"""Conflict-hotspot detection: the per-key-range conflict-rate sketch.

Reference: fdbserver/Ratekeeper.actor.cpp (the 6.3+ tag-throttling machinery,
TagThrottler) and fdbserver/DataDistributionTracker.actor.cpp's read-hot-shard
detection. FDB samples busy tags at the proxy and busy read ranges at the
storage server; here the *resolver* is the natural sampling point for WRITE
contention — it is the one place that sees every conflict verdict together
with the write ranges that caused it.

`HotRangeSketch` keeps an exponentially-decayed conflict counter per exact
write range (begin, end). Decay is computed lazily on read (value halves
every HOTSPOT_HALF_LIFE seconds), so `record` stays O(ranges) on the resolve
hot path. The bucket table is bounded: when full, the coldest bucket is
evicted deterministically (lowest decayed value, ties broken by key order) —
no RNG, so the same sim seed sees the same sketch.

Everything here is pure data + arithmetic on caller-supplied timestamps; the
module deliberately has no dependency on the event loop so the sketch is
trivially unit-testable and deterministic.
"""

from __future__ import annotations

from dataclasses import dataclass

from foundationdb_tpu_torch.utils.knobs import KNOBS


@dataclass
class HotRange:
    """One sampled hot range: conflicts/sec at snapshot time."""

    begin: bytes
    end: bytes
    rate: float


@dataclass
class HotRangesReply:
    """Resolver -> ratekeeper/DD snapshot (RESOLVER_HOT_RANGES)."""

    ranges: list  # list[HotRange], hottest first
    total_rate: float = 0.0  # decayed conflicts/sec across ALL buckets


@dataclass
class ThrottleEntry:
    """One throttled range in the ratekeeper's rate reply: proxies admit at
    most `release_tps` commits/sec touching [begin, end) and advise rejected
    clients to wait `backoff` seconds."""

    begin: bytes
    end: bytes
    release_tps: float
    backoff: float


class HotRangeSketch:
    """Exponentially-decayed conflict counters over exact write ranges."""

    def __init__(self, half_life: float | None = None,
                 max_buckets: int | None = None):
        self.half_life = (KNOBS.HOTSPOT_HALF_LIFE
                          if half_life is None else half_life)
        self.max_buckets = (KNOBS.HOTSPOT_MAX_BUCKETS
                            if max_buckets is None else max_buckets)
        # (begin, end) -> [decayed_count, last_update_time]
        self._buckets: dict[tuple[bytes, bytes], list] = {}

    def __len__(self) -> int:
        return len(self._buckets)

    def _decayed(self, entry: list, now: float) -> float:
        dt = now - entry[1]
        if dt <= 0.0:
            return entry[0]
        return entry[0] * 2.0 ** (-dt / self.half_life)

    def record(self, write_ranges, now: float, weight: float = 1.0):
        """Fold one conflicting transaction's write ranges into the sketch."""
        buckets = self._buckets
        for begin, end in write_ranges:
            key = (begin, end)
            entry = buckets.get(key)
            if entry is not None:
                entry[0] = self._decayed(entry, now) + weight
                entry[1] = now
                continue
            if len(buckets) >= self.max_buckets:
                self._evict_coldest(now)
            buckets[key] = [weight, now]

    def _evict_coldest(self, now: float):
        # deterministic: lowest decayed value first, key order breaks ties
        coldest = min(self._buckets.items(),
                      key=lambda kv: (self._decayed(kv[1], now), kv[0]))
        del self._buckets[coldest[0]]

    def rate(self, begin: bytes, end: bytes, now: float) -> float:
        """Decayed conflicts/sec for one exact range (0.0 if untracked).

        A bucket holding decayed count C represents C conflicts spread over
        roughly one half-life, so rate ~= C * ln(2) / half_life.
        """
        entry = self._buckets.get((begin, end))
        if entry is None:
            return 0.0
        return self._decayed(entry, now) * 0.6931471805599453 / self.half_life

    def total_rate(self, now: float) -> float:
        scale = 0.6931471805599453 / self.half_life
        return sum(self._decayed(e, now) for e in self._buckets.values()) * scale

    def merge(self, other: "HotRangeSketch", now: float):
        """Fold another sketch's decayed mass into this one (ratekeeper-side
        aggregation across resolvers)."""
        for (begin, end), entry in other._buckets.items():
            self.record([(begin, end)], now, weight=other._decayed(entry, now))

    def top_k(self, k: int, now: float) -> list[HotRange]:
        """Hottest k ranges as HotRange snapshots, deterministically ordered
        by (-rate, begin, end) so equal-rate ranges never flap."""
        scale = 0.6931471805599453 / self.half_life
        rows = [HotRange(begin=b, end=e,
                         rate=self._decayed(entry, now) * scale)
                for (b, e), entry in self._buckets.items()]
        rows.sort(key=lambda r: (-r.rate, r.begin, r.end))
        return rows[:k]

    def prune(self, now: float, floor: float = 1e-3):
        """Drop buckets whose decayed mass fell below `floor` (housekeeping
        so long-lived resolvers don't keep dead ranges pinned)."""
        dead = [k for k, e in self._buckets.items()
                if self._decayed(e, now) < floor]
        for k in dead:
            del self._buckets[k]


def overlaps(a_begin: bytes, a_end: bytes, b_begin: bytes, b_end) -> bool:
    """Half-open range intersection test; b_end None means +infinity (the
    shard-boundary convention in clustercontroller's DD loop)."""
    if b_end is None:
        return a_end > b_begin
    return a_begin < b_end and b_begin < a_end
