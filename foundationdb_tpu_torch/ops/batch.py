"""Shared batch types for the conflict engine.

Reference interface: fdbserver/ConflictSet.h:27-44 — ConflictBatch collects
transactions (read snapshot + read/write conflict ranges), detectConflicts
returns a per-transaction result in {TransactionConflict, TransactionTooOld,
TransactionCommitted} (:36-40). We keep the reference's result numbering so
logs/tests line up.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# ConflictSet.h:36-40 TransactionConflictStatus
CONFLICT = 0
TOO_OLD = 1
COMMITTED = 2

STATUS_NAMES = {CONFLICT: "Conflict", TOO_OLD: "TooOld", COMMITTED: "Committed"}


@dataclass
class TxnConflictInfo:
    """One transaction's conflict information (CommitTransaction.h:89-101).

    Ranges are half-open [begin, end) byte-string pairs.
    """

    read_snapshot: int
    read_ranges: list[tuple[bytes, bytes]] = field(default_factory=list)
    write_ranges: list[tuple[bytes, bytes]] = field(default_factory=list)


# Conflict-engine config validation — the validate_storage_engine analogue
# (storage/kvstore.py:246 of the JAX package). Lives here rather than in
# server/resolver.py so a worker can fail fast at boot without importing
# the device stack.
VALID_CONFLICT_BACKENDS = ("oracle", "device", "sharded")


def validate_conflict_config(backend=None, num_shards=None):
    """Fail at worker boot on a misconfigured resolver, not on the first
    commit batch minutes later. Arguments default to the live knobs; the
    shard count is checked against the attached cards later, when the
    engine is built."""
    from foundationdb_tpu_torch.utils.errors import FDBError
    from foundationdb_tpu_torch.utils.knobs import KNOBS

    if backend is None:
        backend = KNOBS.CONFLICT_BACKEND
    if backend not in VALID_CONFLICT_BACKENDS:
        raise FDBError(
            "invalid_option",
            f"unknown CONFLICT_BACKEND {backend!r}: valid backends are "
            + ", ".join(VALID_CONFLICT_BACKENDS))
    if num_shards is None:
        num_shards = KNOBS.CONFLICT_NUM_SHARDS
    if isinstance(num_shards, bool) or not isinstance(num_shards, int) \
            or num_shards < 0:
        raise FDBError(
            "invalid_option",
            f"CONFLICT_NUM_SHARDS must be a non-negative integer "
            f"(0 = span every attached device); got {num_shards!r}")
