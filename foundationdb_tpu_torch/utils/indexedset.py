"""IndexedSet: the ordered key index with count+sum augmentation.

Reference: flow/IndexedSet.h — the balanced ordered structure everything
size-aware hangs off (storage byte sampling, shard metrics): O(log n)
insert/erase and O(log n) `sumTo` over key ranges. The serving
implementation is the C skiplist in native/fdb_native.c (IndexedSet type);
this module adds the identical-surface pure-Python fallback (bisect lists —
O(n) inserts, used only when no C toolchain exists) and the factory the
rest of the codebase calls.

Surface:
    insert(key, metric=1)      add or replace (re-metric) a key
    discard(key) -> bool
    rank(key) -> int           bisect_left index
    nth(i) -> key
    range_keys(lo, hi, limit=0, reverse=False) -> [keys]
    sum_range(lo, hi) -> (count, metric_sum)
    contains(key) -> bool, len()
"""

from __future__ import annotations

import bisect


class PyIndexedSet:
    """Fallback with the same surface (bisect lists)."""

    def __init__(self):
        self._keys: list[bytes] = []
        self._metrics: dict[bytes, int] = {}

    def insert(self, key: bytes, metric: int = 1):
        if key not in self._metrics:
            bisect.insort(self._keys, key)
        self._metrics[key] = metric

    def discard(self, key: bytes) -> bool:
        if key not in self._metrics:
            return False
        del self._metrics[key]
        i = bisect.bisect_left(self._keys, key)
        del self._keys[i]
        return True

    def rank(self, key: bytes) -> int:
        return bisect.bisect_left(self._keys, key)

    def nth(self, i: int) -> bytes:
        return self._keys[i]

    def range_keys(self, lo: bytes, hi: bytes, limit: int = 0,
                   reverse: bool = False) -> list[bytes]:
        a = bisect.bisect_left(self._keys, lo)
        b = bisect.bisect_left(self._keys, hi)
        keys = self._keys[a:b]
        if reverse:
            keys.reverse()
        if limit:
            keys = keys[:limit]
        return keys

    def sum_range(self, lo: bytes, hi: bytes) -> tuple[int, int]:
        a = bisect.bisect_left(self._keys, lo)
        b = bisect.bisect_left(self._keys, hi)
        return b - a, sum(self._metrics[k] for k in self._keys[a:b])

    def contains(self, key: bytes) -> bool:
        return key in self._metrics

    def __len__(self):
        return len(self._keys)


def make_indexed_set():
    from foundationdb_tpu_torch import native
    if native.available() and hasattr(native.mod, "IndexedSet"):
        return native.mod.IndexedSet()
    return PyIndexedSet()


def iter_range(iset, begin: bytes, end: bytes, reverse: bool = False,
               chunk: int = 64):
    """Lazy chunked iteration over [begin, end): fetches `chunk` keys per
    C call so bounded reads stay O(limit), not O(range size)."""
    lo, hi = begin, end
    while True:
        keys = iset.range_keys(lo, hi, chunk, reverse)
        if not keys:
            return
        yield from keys
        if len(keys) < chunk:
            return
        if reverse:
            hi = keys[-1]
        else:
            lo = keys[-1] + b"\x00"
