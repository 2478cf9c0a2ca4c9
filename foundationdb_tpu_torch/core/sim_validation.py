"""Simulation-only global invariant oracles.

Reference: fdbrpc/sim_validation.cpp — tiny global trackers called from REAL
code paths (e.g. debug_advanceMaxCommittedVersion from the proxy,
MasterProxyServer.actor.cpp:820) that ASSERT cross-process invariants the
distributed protocol is supposed to guarantee. They only observe under the
deterministic simulator (a real deployment has no global vantage point) and
cost nothing when disabled.

Unlike the reference (one process = one simulation, so globals are safe),
several simulated clusters can coexist in one interpreter here, so the
oracle state is attached to each SimNetwork instance; `of(net)` resolves a
network to its oracle, or to a no-op for real transports.

Invariants tracked:
  - acked-commit monotonicity: the set of client-ACKNOWLEDGED commit
    versions is consistent with the master's total order (a new ack below
    an already-acked version is fine — acks race — but a version can never
    be acked twice from different batches).
  - external consistency: a read version HANDED OUT must be >= every commit
    acknowledged before the GRV request was received (strict
    serializability's real-time edge; debug_checkMinCommittedVersion).
"""

from __future__ import annotations


class SimValidation:
    """Per-simulation oracle state (one per SimNetwork)."""

    enabled = True

    def __init__(self):
        self._max_acked = 0
        self._acked_from: dict[int, str] = {}

    def debug_advance_max_committed(self, version: int, who: str = "?"):
        """Called by a proxy when it ACKS a commit at `version` to a client
        (debug_advanceMaxCommittedVersion). Each version is acked by exactly
        one batch on one proxy; a duplicate ack from elsewhere means two
        batches believed they owned the same master-assigned version."""
        prev = self._acked_from.get(version)
        assert prev is None or prev == who, \
            f"version {version} acked by both {prev} and {who}"
        self._acked_from[version] = who
        if version > self._max_acked:
            self._max_acked = version
        # bound memory AND work: over the cap, drop the oldest half by
        # version (a fixed version-distance window prunes nothing when
        # versions advance slowly, turning long dense sims quadratic)
        if len(self._acked_from) > 65536:
            keep = sorted(self._acked_from)[len(self._acked_from) // 2:]
            kept = {v: self._acked_from[v] for v in keep}
            self._acked_from.clear()
            self._acked_from.update(kept)

    def debug_grv_floor(self) -> int:
        """Snapshot the external-consistency floor when a GRV request
        ARRIVES: the reply must be >= this (every commit acked before the
        request)."""
        return self._max_acked

    def debug_check_read_version(self, version: int, floor: int,
                                 who: str = "?"):
        """Called with the GRV reply and the floor snapshotted at arrival
        (debug_checkMinCommittedVersion): handing out less would let a
        client miss a write it was already told succeeded."""
        assert version >= floor, \
            f"{who} handed out read version {version} < acked floor {floor}"


class _Disabled:
    """Real deployments have no global vantage point: every probe no-ops."""

    enabled = False

    def debug_advance_max_committed(self, version, who="?"):
        pass

    def debug_grv_floor(self) -> int:
        return 0

    def debug_check_read_version(self, version, floor, who="?"):
        pass


DISABLED = _Disabled()


def of(net, scope: str = ""):
    """The oracle attached to a network (SimNetwork carries one); no-op for
    real transports. `scope` separates DATABASES sharing one simulation
    (the DR topology runs two live clusters on one SimNetwork): external
    consistency is a per-database invariant — cluster B's acked commits
    must not raise cluster A's GRV floor."""
    base = getattr(net, "validation", None)
    if base is None:
        return DISABLED
    if not scope:
        return base
    scoped = getattr(net, "_validation_scoped", None)
    if scoped is None:
        scoped = net._validation_scoped = {}
    if scope not in scoped:
        scoped[scope] = type(base)()
    return scoped[scope]
