"""Versioned hot-key read cache for the storage server.

Reference: fdbserver/DataDistributionTracker.actor.cpp's read-hot-shard
detection plus the storage cache role sketched in fdbserver/
StorageCache.actor.cpp — FDB answers zipfian read skew by putting extra
serving capacity in front of the hot range. Here the storage server itself
keeps a bounded, version-tagged value cache over the ranges its read-hotness
sketch flags, so a hot key is answered from one dict probe instead of an
MVCC window walk, and replicas under zipfian skew stay flat instead of one
melting.

Correctness contract (the whole point of the version tags):

- An entry is `key -> (valid_from, value)` where `value` is the MVCC value
  at `valid_from`, and `valid_from` is the server's LATEST applied version
  at populate time.
- Every committed mutation the update loop applies invalidates the touched
  keys *synchronously, in the same tick* (`invalidate`), before the server's
  version advances past it. Therefore: an entry that is still present has
  seen no mutation to its key since `valid_from`, so its value is exact for
  every read version v >= valid_from (and the server never serves reads
  above its applied version).
- Reads below `valid_from` miss and fall through to the MVCC map; rollbacks
  and fetchKeys splices drop the whole cache (`clear`) — both rewrite
  history out from under the tags.

Hotness detection reuses HotRangeSketch with per-key point ranges, fed by
stride-sampled reads (one sketch record per READ_CACHE_SAMPLE reads, weighted
back up by the stride) so the serve path pays O(1) per batch. The hot set is
recomputed at most every READ_CACHE_REFRESH seconds.

Pure data + arithmetic on caller-supplied timestamps (the HotRangeSketch
discipline): no event-loop dependency, deterministic, unit-testable.
"""

from __future__ import annotations

from foundationdb_tpu_torch.server.hotspot import HotRangeSketch
from foundationdb_tpu_torch.utils.knobs import KNOBS
from foundationdb_tpu_torch.utils.types import MutationType


class VersionedReadCache:
    """Bounded version-tagged point-read cache over sketch-flagged ranges."""

    def __init__(self, max_entries: int | None = None,
                 sample: int | None = None,
                 top_k: int | None = None,
                 hot_rate: float | None = None,
                 refresh: float | None = None):
        self.max_entries = (KNOBS.READ_CACHE_MAX_ENTRIES
                            if max_entries is None else max_entries)
        self.sample = KNOBS.READ_CACHE_SAMPLE if sample is None else sample
        self.top_k = KNOBS.READ_CACHE_TOP_K if top_k is None else top_k
        self.hot_rate = (KNOBS.READ_CACHE_HOT_RATE
                         if hot_rate is None else hot_rate)
        self.refresh = (KNOBS.READ_CACHE_REFRESH
                        if refresh is None else refresh)
        self.sketch = HotRangeSketch()
        # key -> (valid_from, value); dict order doubles as FIFO for eviction
        self.entries: dict[bytes, tuple[int, bytes | None]] = {}
        self.hot_ranges: list[tuple[bytes, bytes]] = []
        self._sample_due = self.sample
        self._next_refresh = 0.0
        # plain ints, folded into the storage CounterCollection by the owner
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.evictions = 0

    # -- hotness feed (serve path, O(1) per batch) --

    def note_reads(self, first_key: bytes, n: int, now: float):
        """Stride-sample a batch of `n` point reads into the sketch. The
        first key of every READ_CACHE_SAMPLE-th read stands for the stride
        (batch contents are i.i.d. draws from the client's key mix, so the
        sample is unbiased), weighted back up by the stride length."""
        self._sample_due -= n
        if self._sample_due > 0:
            return
        self._sample_due = self.sample
        self.sketch.record([(first_key, first_key + b"\x00")], now,
                           weight=float(self.sample))
        if now >= self._next_refresh:
            self._next_refresh = now + self.refresh
            self.refresh_hot(now)

    def refresh_hot(self, now: float):
        """Recompute the cacheable set from the sketch; entries whose range
        went cold stay until touched by a mutation or evicted (their version
        tags keep them exact regardless of hotness)."""
        self.hot_ranges = [
            (r.begin, r.end) for r in self.sketch.top_k(self.top_k, now)
            if r.rate >= self.hot_rate]
        self.sketch.prune(now)

    def is_hot(self, key: bytes) -> bool:
        for b, e in self.hot_ranges:
            if b <= key < e:
                return True
        return False

    # -- serve path --

    def lookup(self, key: bytes, version: int):
        """(hit, value): hit iff a tag proves the value exact at `version`."""
        entry = self.entries.get(key)
        if entry is not None and entry[0] <= version:
            self.hits += 1
            return True, entry[1]
        if self.hot_ranges and self.is_hot(key):
            self.misses += 1
        return False, None

    def populate(self, key: bytes, value: bytes | None, latest_version: int):
        """Insert after a miss. `latest_version` MUST be the server's latest
        applied version in the same event-loop tick as the MVCC read that
        produced `value` — tagging with the (older) read version would let a
        mutation already applied between the two mint stale hits."""
        if not self.is_hot(key):
            return
        if key not in self.entries and len(self.entries) >= self.max_entries:
            self.entries.pop(next(iter(self.entries)))
            self.evictions += 1
        self.entries[key] = (latest_version, value)

    # -- invalidation (update loop, same tick as data.apply) --

    def invalidate(self, muts) -> None:
        """Drop entries a mutation batch touches. Point writes (set/atomic)
        are one pop; a clear sweeps the (bounded) entry table."""
        entries = self.entries
        for m in muts:
            if m.type == MutationType.CLEAR_RANGE:
                b, e = m.param1, m.param2
                dead = [k for k in entries if b <= k < e]
                for k in dead:
                    del entries[k]
                self.invalidations += len(dead)
            elif entries.pop(m.param1, None) is not None:
                self.invalidations += 1

    def clear(self):
        """History rewrote (rollback / fetchKeys splice): drop everything."""
        self.invalidations += len(self.entries)
        self.entries.clear()
