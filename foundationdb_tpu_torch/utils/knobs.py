"""Knob (configuration) bank.

Reference: flow/Knobs.cpp + fdbclient/Knobs.cpp + fdbserver/Knobs.cpp — a flat
registry of named numeric tunables, overridable at startup.

This bank is the PyTorch port's own, separate from the JAX package's: it
holds only the knobs the port reads, and `KNOBS.reset()` here does not touch
the JAX bank (the port's tests reset it in their own fixtures).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class _Knob:
    name: str
    default: Any


@dataclass
class Knobs:
    _defs: dict[str, _Knob] = field(default_factory=dict)
    _values: dict[str, Any] = field(default_factory=dict)

    def init(self, name: str, default: Any):
        self._defs[name] = _Knob(name, default)
        self._values[name] = default

    def __getattr__(self, name: str):
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any):
        # `KNOBS.X = v` is `KNOBS.set("X", v)`: an instance attribute would
        # shadow `__getattr__` and outlive `reset()`
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self.set(name, value)

    def set(self, name: str, value: Any):
        if name not in self._defs:
            raise KeyError(f"unknown knob: {name}")
        self._values[name] = value

    def reset(self):
        for k, d in self._defs.items():
            self._values[k] = d.default

    def overrides(self, **kw):
        for k, v in kw.items():
            self.set(k, v)


KNOBS = Knobs()

# --- Versions / MVCC window (fdbserver/Knobs.cpp:30-34) ---
KNOBS.init("MAX_WRITE_TRANSACTION_LIFE_VERSIONS", 5_000_000)

# --- Conflict engine (device) ---
# "device" (the port's engine on CONFLICT_DEVICE) | "sharded" (the
# key-partitioned engine, parallel/sharded_conflict.py) | "oracle" (host
# reference).
KNOBS.init("CONFLICT_BACKEND", "device")
# Where the device engine runs: "cuda" (the serving target) or "cpu" (the
# plain PyTorch path the tests drive). Asking for cuda on a machine without
# it raises platform_error; nothing falls back silently.
KNOBS.init("CONFLICT_DEVICE", "cuda")
KNOBS.init("CONFLICT_STATE_CAPACITY", 1 << 16)  # boundary slots
KNOBS.init("CONFLICT_BATCH_TXNS", 1024)  # static batch shape: txns
KNOBS.init("CONFLICT_BATCH_READS_PER_TXN", 4)
KNOBS.init("CONFLICT_BATCH_WRITES_PER_TXN", 4)
# Intra-batch "earlier txns win" evaluator: "scan" (per-level prefix scans,
# a bounded sandwich with no host sync) or "legacy" (every write/read pair,
# an unbounded fixpoint that reads its convergence on the host; kept for
# the A/B of the kernel bench).
KNOBS.init("CONFLICT_INTRA_MODE", "scan")
# Sandwich sweep rounds of the intra-batch evaluator; 0 = auto
# (min(txns // 2 + 1, 32), see conflict_ref.auto_rounds).
KNOBS.init("CONFLICT_INTRA_ROUNDS", 0)
# Pinned host encode slots per shape bucket; 0 disables pooling.
KNOBS.init("CONFLICT_ENCODE_RING", 4)
# Shards of CONFLICT_BACKEND=sharded: how many devices the resolver's
# key-partitioned engine spans. 0 = every attached card (on the CPU, one
# shard); more than the attached cards raises invalid_option. The JAX bank
# lists 1 and 2 as the values a test may force.
KNOBS.init("CONFLICT_NUM_SHARDS", 0)
# resolutionBalancing (masterserver.actor.cpp:955-1012): the sharded engine
# re-cuts its key partition from sampled range begins when per-shard load
# skews. Checked every CHECK_BATCHES batches (floor 4); re-cuts when the
# hottest shard carries more than SKEW x the mean; needs MIN_SAMPLES range
# begins first (floor 32).
KNOBS.init("RESOLUTION_BALANCE_CHECK_BATCHES", 64)
KNOBS.init("RESOLUTION_BALANCE_SKEW", 2.0)
KNOBS.init("RESOLUTION_BALANCE_MIN_SAMPLES", 2048)
# Seconds between the resolver's conflict-mass re-cuts: its HotRangeSketch
# feeds the sharded engine's planner (floor 0.5).
KNOBS.init("RESOLUTION_BALANCE_EPOCH_SECONDS", 5.0)

# --- Simulation transport (flow/Knobs.cpp:51-52, fdbrpc/sim2.actor.cpp) ---
KNOBS.init("SIM_RPC_TIMEOUT_SECONDS", 5.0)  # dropped-packet visibility bound
KNOBS.init("SIM_MIN_LATENCY", 0.0001)
KNOBS.init("SIM_MAX_LATENCY", 0.002)

# --- Contention management (docs/contention.md) ---
KNOBS.init("HOTSPOT_HALF_LIFE", 2.0)  # sketch decay half-life, seconds
KNOBS.init("HOTSPOT_MAX_BUCKETS", 256)  # sketch size bound
KNOBS.init("HOTSPOT_TOP_K", 8)  # ranges per RESOLVER_HOT_RANGES snapshot
# seconds between the resolver's periodic counter trace events
KNOBS.init("COUNTERS_TRACE_INTERVAL", 5.0)
