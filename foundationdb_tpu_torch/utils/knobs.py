"""Knob (configuration) bank.

Reference: flow/Knobs.cpp + fdbclient/Knobs.cpp + fdbserver/Knobs.cpp — a flat
registry of named numeric tunables, overridable at startup, where *the config
system doubles as a fault-injection surface*: under simulation with
buggification enabled, each knob may be randomly set to an extreme value
(`flow/Knobs.cpp:36` `init(..); if(randomize && BUGGIFY) ...` pattern).

This bank is the PyTorch port's own, separate from the JAX package's: it
holds the knobs the port reads, under the JAX bank's defaults and extremes,
and `KNOBS.reset()` here does not touch the JAX bank (the port's tests reset
it in their own fixtures). `Knobs.buggify(rng)` randomizes knobs that
declare extreme candidate values, using the deterministic RNG so runs stay
replayable.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class _Knob:
    name: str
    default: Any
    extremes: tuple = ()  # candidate buggified values


@dataclass
class Knobs:
    _defs: dict[str, _Knob] = field(default_factory=dict)
    _values: dict[str, Any] = field(default_factory=dict)

    def init(self, name: str, default: Any, extremes: tuple = ()):
        self._defs[name] = _Knob(name, default, extremes)
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

    def draw_buggified(self, rng, probability: float = 0.25) -> dict[str, Any]:
        """PURE draw of a buggified knob subset (deterministic under rng):
        which knobs would be randomized and to what, without applying them.
        The randomized harness records this draw in its repro line — the
        knob draw is part of the environment a failing seed must replay
        (SimulatedCluster's per-seed knob randomization, flow/Knobs.cpp
        BUGGIFY pattern)."""
        drawn: dict[str, Any] = {}
        for k, d in sorted(self._defs.items()):
            if d.extremes and rng.random() < probability:
                drawn[k] = d.extremes[rng.randint(0, len(d.extremes) - 1)]
        return drawn

    def buggify(self, rng, probability: float = 0.25) -> dict[str, Any]:
        """Randomly set knobs that declare extremes (deterministic under
        rng). Returns the drawn subset {name: buggified_value}."""
        drawn = self.draw_buggified(rng, probability)
        self._values.update(drawn)
        return drawn

    def overrides(self, **kw):
        for k, v in kw.items():
            self.set(k, v)


KNOBS = Knobs()

# --- Versions / MVCC window (fdbserver/Knobs.cpp:30-34) ---
KNOBS.init("VERSIONS_PER_SECOND", 1_000_000)
KNOBS.init("MAX_READ_TRANSACTION_LIFE_VERSIONS", 5_000_000, (1_000_000,))
KNOBS.init("MAX_WRITE_TRANSACTION_LIFE_VERSIONS", 5_000_000, (1_000_000,))
KNOBS.init("MAX_VERSIONS_IN_FLIGHT", 100_000_000)
KNOBS.init("PROXY_MASTER_LEASE_SECONDS", 2.0)  # proxy GRV fencing lease
KNOBS.init("MASTER_CSTATE_LEASE_SECONDS", 2.0)  # master self-deposition lease

# --- Commit batching (fdbserver/Knobs.cpp:246-252, MasterProxyServer.actor.cpp:921) ---
KNOBS.init("COMMIT_TRANSACTION_BATCH_COUNT_MAX", 32768, (1, 4))
KNOBS.init("COMMIT_TRANSACTION_BATCH_INTERVAL_MIN", 0.001, (0.1,))
# above the time a saturated proxy takes to fill a BYTES_MIN batch, so under
# heavy load the byte/count triggers, not the timer, govern batch size
KNOBS.init("COMMIT_TRANSACTION_BATCH_INTERVAL_MAX", 0.025)
KNOBS.init("COMMIT_TRANSACTION_BATCH_BYTES_MIN", 100_000)
KNOBS.init("COMMIT_BATCH_IDLE_INTERVAL", 0.25)  # empty-batch keepalive
# adaptive batch sizing: the target flush interval slides from INTERVAL_MIN
# toward INTERVAL_MAX as the smoothed commits-in rate approaches SATURATION
KNOBS.init("COMMIT_BATCH_RATE_SATURATION", 4000.0, (10.0,))  # commits/s at INTERVAL_MAX
KNOBS.init("COMMIT_BATCH_RATE_SMOOTHING", 0.1)  # EWMA weight per arrival
# concurrent version batches in the proxy's commit pipeline: resolve(N+1)
# overlaps tlog-push(N)
KNOBS.init("COMMIT_PIPELINE_DEPTH", 4, (1,))

# --- Conflict engine (device) ---
# "device" (the port's engine on CONFLICT_DEVICE) | "sharded" (the
# key-partitioned engine, parallel/sharded_conflict.py) | "oracle" (host
# reference).
KNOBS.init("CONFLICT_BACKEND", "device")
# Where the device engine runs: "cuda" (the serving target) or "cpu" (the
# plain PyTorch path the tests drive). Asking for cuda on a machine without
# it raises platform_error; nothing falls back silently.
KNOBS.init("CONFLICT_DEVICE", "cuda")
KNOBS.init("CONFLICT_STATE_CAPACITY", 1 << 16, (1 << 10,))  # boundary slots
KNOBS.init("CONFLICT_BATCH_TXNS", 1024)  # static batch shape: txns
KNOBS.init("CONFLICT_BATCH_READS_PER_TXN", 4)
KNOBS.init("CONFLICT_BATCH_WRITES_PER_TXN", 4)
# Intra-batch "earlier txns win" evaluator: "scan" (per-level prefix scans,
# a bounded sandwich with no host sync) or "legacy" (every write/read pair,
# an unbounded fixpoint that reads its convergence on the host; kept for
# the A/B of the kernel bench).
KNOBS.init("CONFLICT_INTRA_MODE", "scan", ("legacy",))
# Sandwich sweep rounds of the intra-batch evaluator; 0 = auto
# (min(txns // 2 + 1, 32), see conflict_ref.auto_rounds).
KNOBS.init("CONFLICT_INTRA_ROUNDS", 0, (1,))
# Pinned host encode slots per shape bucket; 0 disables pooling.
KNOBS.init("CONFLICT_ENCODE_RING", 4, (0,))
# Shards of CONFLICT_BACKEND=sharded: how many devices the resolver's
# key-partitioned engine spans. 0 = every attached card (on the CPU, one
# shard); more than the attached cards raises invalid_option. A buggified
# draw may force 1 or 2.
KNOBS.init("CONFLICT_NUM_SHARDS", 0, (1, 2))
# resolutionBalancing (masterserver.actor.cpp:955-1012): the sharded engine
# re-cuts its key partition from sampled range begins when per-shard load
# skews. Checked every CHECK_BATCHES batches (floor 4); re-cuts when the
# hottest shard carries more than SKEW x the mean; needs MIN_SAMPLES range
# begins first (floor 32).
KNOBS.init("RESOLUTION_BALANCE_CHECK_BATCHES", 64, (4,))
KNOBS.init("RESOLUTION_BALANCE_SKEW", 2.0)
KNOBS.init("RESOLUTION_BALANCE_MIN_SAMPLES", 2048, (32,))
# Seconds between the resolver's conflict-mass re-cuts: its HotRangeSketch
# feeds the sharded engine's planner (floor 0.5).
KNOBS.init("RESOLUTION_BALANCE_EPOCH_SECONDS", 5.0, (0.5,))

# --- Client (fdbclient/Knobs.cpp) ---
KNOBS.init("GRV_BATCH_INTERVAL", 0.0005, (0.01,))  # read-version batcher
KNOBS.init("READ_BATCH_INTERVAL", 0.0005, (0.01,))  # point-read batcher
KNOBS.init("READ_BATCH_MAX", 250, (2,))
KNOBS.init("DEFAULT_BACKOFF", 0.01, (1.0,))
# load balance (fdbrpc/LoadBalance.actor.h:159 + QueueModel): replicas by
# smoothed latency, and a "backup request" to the next-best replica once
# the first has been in flight MULT x its expected latency (floored)
KNOBS.init("LOAD_BALANCE_EWMA_ALPHA", 0.2)
KNOBS.init("LOAD_BALANCE_BACKUP_MULT", 5.0, (1.0,))
KNOBS.init("LOAD_BALANCE_MIN_BACKUP_DELAY", 0.005, (0.0005,))
KNOBS.init("MAX_BACKOFF", 1.0)
# client-side commit admission control: AIMD budget on in-flight commits
# per Database, cut on transaction_throttled and on commit latency past
# LATENCY_RATIO x the decaying-min baseline
KNOBS.init("CLIENT_COMMIT_MAX_IN_FLIGHT", 256)
KNOBS.init("CLIENT_COMMIT_INITIAL_IN_FLIGHT", 32, (1,))
KNOBS.init("CLIENT_ADMISSION_LATENCY_RATIO", 6.0)
KNOBS.init("CLIENT_ADMISSION_DECREASE", 0.7)  # multiplicative cut factor
KNOBS.init("KEY_SIZE_LIMIT", 10_000)
KNOBS.init("VALUE_SIZE_LIMIT", 100_000)
KNOBS.init("TRANSACTION_SIZE_LIMIT", 10_000_000)

# --- Simulation transport (flow/Knobs.cpp:51-52, fdbrpc/sim2.actor.cpp) ---
KNOBS.init("SIM_RPC_TIMEOUT_SECONDS", 5.0)  # dropped-packet visibility bound
KNOBS.init("SIM_MIN_LATENCY", 0.0001)
KNOBS.init("SIM_MAX_LATENCY", 0.002, (0.05,))

# --- TLog / storage ---
KNOBS.init("TLOG_QUORUM_ANTIQUORUM", 0)
KNOBS.init("TLOG_PEEK_REPLY_BYTES", 150_000, (10_000,))  # bounded peek pages
KNOBS.init("TLOG_SPILL_BYTES", 1_500_000, (100_000,))  # in-memory cap per log
# log-router pull-ahead bound, in versions past the slowest consumer's pop
# (LogRouter.actor.cpp bounds by bytes via LOG_ROUTER_MAX_SEARCH_MEMORY)
KNOBS.init("LOG_ROUTER_BUFFER_VERSIONS", 50_000_000)
KNOBS.init("STORAGE_ENGINE", "memory")  # "memory" | "ssd" | "redwood" (KeyValueStoreType)
KNOBS.init("SSD_DATA_DIR", "")  # "" -> the platform temp dir

# --- Redwood storage engine (storage/redwood.py; the reference's
# ssd-redwood-v1, VersionedBTree.actor.cpp knob family) ---
KNOBS.init("REDWOOD_MEMTABLE_BYTES", 4_000_000, (8_192,))  # flush trigger
KNOBS.init("REDWOOD_BLOCK_BYTES", 16_384, (512,))  # sorted-block target size
KNOBS.init("REDWOOD_COMPACTION_FAN_IN", 4, (2,))  # runs per level -> merge
KNOBS.init("REDWOOD_BLOCK_CACHE_BLOCKS", 1_024, (2,))  # decoded-block cache
KNOBS.init("REDWOOD_MAINT_INTERVAL", 0.25)  # storage-server poll period
# native read path (native/fdb_native.c RedwoodRun): 0 forces the
# pure-Python lookup even when the extension is built — the parity-fuzz lever
KNOBS.init("REDWOOD_NATIVE_READS", 1, (0,))
KNOBS.init("REDWOOD_BLOOM_BITS_PER_KEY", 10, (0,))  # 0 -> no bloom section
KNOBS.init("REDWOOD_BLOOM_HASHES", 6)  # double-hashing probe count
KNOBS.init("DESIRED_TOTAL_BYTES", 150_000)  # range-read reply soft limit
# serve incoming connections through the C transport data plane
# (net/native_transport.py), and send through its client half (batched C
# request encode + C reply pump); NET_NATIVE_TRANSPORT=1 /
# NET_NATIVE_CLIENT=1 in the environment override. Not buggified: the sim
# never constructs a NetTransport.
KNOBS.init("NET_NATIVE_TRANSPORT", 0)
KNOBS.init("NET_NATIVE_CLIENT", 0)

# --- Ratekeeper (fdbserver/Ratekeeper.actor.cpp updateRate :250) ---
KNOBS.init("RK_UPDATE_INTERVAL", 0.5)
KNOBS.init("RK_TARGET_STORAGE_LAG_VERSIONS", 10_000_000)  # worst durability lag
KNOBS.init("RK_TARGET_TLOG_BYTES", 2_000_000, (200_000,))  # worst log queue
KNOBS.init("RK_BASE_TPS", 100_000.0)  # unthrottled budget
KNOBS.init("RK_SMOOTHING", 0.5)  # exponential smoothing per update

# --- Contention management (docs/contention.md) ---
KNOBS.init("HOTSPOT_HALF_LIFE", 2.0)  # sketch decay half-life, seconds
KNOBS.init("HOTSPOT_MAX_BUCKETS", 256, (16,))  # sketch size bound
KNOBS.init("HOTSPOT_TOP_K", 8)  # ranges per RESOLVER_HOT_RANGES snapshot
KNOBS.init("CONTENTION_THROTTLE_ENABLED", True)
# a range whose decayed conflict rate exceeds this is throttled
KNOBS.init("RK_THROTTLE_CONFLICT_RATE", 25.0, (2.0,))
# commits/sec the WHOLE proxy fleet may release into a throttled range
KNOBS.init("RK_THROTTLE_RELEASE_TPS", 50.0)
KNOBS.init("RK_THROTTLE_BACKOFF", 0.25)  # server-advised client backoff, s
KNOBS.init("RK_THROTTLE_MAX_BACKOFF", 2.0)  # advised-backoff ceiling
# DD conflict-split trigger: sustained conflict rate on a shard splits it
# even when its byte count is small (the hot-shard half of shardSplitter)
KNOBS.init("DD_SHARD_SPLIT_CONFLICT_RATE", 50.0)
KNOBS.init("DD_HOT_SHARD_ROUNDS", 2)  # consecutive hot DD rounds before split

# --- Storage read cache: a bounded version-tagged value cache over ranges
# the HotRangeSketch flags read-hot (server/readcache.py) ---
KNOBS.init("READ_CACHE_ENABLED", True, (False,))
KNOBS.init("READ_CACHE_MAX_ENTRIES", 4096, (4,))  # bounded: FIFO eviction
# one read in SAMPLE is folded into the read-hotness sketch
KNOBS.init("READ_CACHE_SAMPLE", 16, (1,))
KNOBS.init("READ_CACHE_TOP_K", 16)  # hot ranges eligible for caching
# a sampled range is hot when its decayed read rate (scaled back up by the
# sampling stride) exceeds this, in reads/sec
KNOBS.init("READ_CACHE_HOT_RATE", 50.0, (1.0,))
KNOBS.init("READ_CACHE_REFRESH", 0.5)  # hot-set recompute period, seconds
# seconds between the resolver's periodic counter trace events
KNOBS.init("COUNTERS_TRACE_INTERVAL", 5.0)

# storage replicas recruited per shard, every one serving reads (the CC's
# recruitment fans each shard's tag set across failure domains; clusters
# constructed with an explicit n_replicas override this default)
KNOBS.init("READ_REPLICAS", 1)

# --- Data distribution (fdbserver/DataDistributionTracker.actor.cpp) ---
KNOBS.init("CC_PREEMPT_INTERVAL_SECONDS", 5.0)  # betterMasterExists poll
KNOBS.init("DD_INTERVAL_SECONDS", 2.0)  # shard tracker poll period
# a storage worker silent for this long is treated as permanently failed and
# its shards are re-replicated onto a replacement (storageServerFailureTracker
# / DD_FAILURE_TIME; short here because sim time is cheap)
KNOBS.init("DD_STORAGE_FAILURE_SECONDS", 8.0, (2.0,))
KNOBS.init("DD_SHARD_SPLIT_BYTES", 500_000, (5_000,))  # shardSplitter :314 threshold
KNOBS.init("DD_SHARD_MERGE_BYTES", 50_000, (500,))  # shardMerger :379 threshold

# Declared with the JAX bank's defaults and extremes so that a buggified
# draw consumes the rng as the reference's does (`draw_buggified` walks
# every knob that declares extremes); nothing in the port reads them.
KNOBS.init("CONFLICT_READBACK_OVERLAP", True, (False,))
KNOBS.init("CONFLICT_CPU_FALLBACK", "host", ("jax",))
KNOBS.init("CONNECTION_MONITOR_TIMEOUT", 2.0, (0.1,))
KNOBS.init("MAX_BATCH_SIZE", 20, (1,))
KNOBS.init("SHARD_MAX_BYTES", 500_000_000, (10_000,))
KNOBS.init("SHARD_MIN_BYTES", 200_000, (1_000,))
