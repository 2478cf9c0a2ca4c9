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
# "device" (the port's engine on CONFLICT_DEVICE) | "oracle" (host
# reference); "sharded" is validated but not yet ported.
KNOBS.init("CONFLICT_BACKEND", "device")
# Where the device engine runs: "cuda" (the serving target) or "cpu" (the
# plain PyTorch path the tests drive). Asking for cuda on a machine without
# it raises platform_error; nothing falls back silently.
KNOBS.init("CONFLICT_DEVICE", "cuda")
KNOBS.init("CONFLICT_STATE_CAPACITY", 1 << 16)  # boundary slots
KNOBS.init("CONFLICT_BATCH_TXNS", 1024)  # static batch shape: txns
KNOBS.init("CONFLICT_BATCH_READS_PER_TXN", 4)
KNOBS.init("CONFLICT_BATCH_WRITES_PER_TXN", 4)
# Sandwich sweep rounds of the intra-batch evaluator; 0 = auto
# (min(txns // 2 + 1, 32), see conflict_ref.auto_rounds).
KNOBS.init("CONFLICT_INTRA_ROUNDS", 0)
# Pinned host encode slots per shape bucket; 0 disables pooling.
KNOBS.init("CONFLICT_ENCODE_RING", 4)

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
