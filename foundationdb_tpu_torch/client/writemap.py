"""WriteMap: the client-local overlay of uncommitted writes.

Reference: fdbclient/WriteMap.h (633 LoC) — an ordered map of point writes and
cleared intervals that (a) lets reads see uncommitted writes (RYWIterator
merges it over snapshot data), and (b) yields the transaction's write conflict
ranges at commit time.

Host design: a dict of point operations (applied in order per key) plus a
sorted list of disjoint cleared intervals. Mutations are also kept in arrival
order for the commit body (CommitTransactionRef.mutations preserves order).
"""

from __future__ import annotations

import bisect

from foundationdb_tpu_torch.utils.types import (
    ATOMIC_OPS, Mutation, MutationType, apply_atomic_op, make_mutation)


class _PointWrite:
    """Per-key overlay state: either a known value, or a chain of atomic ops
    pending on the storage value (unresolved until first read / commit)."""

    __slots__ = ("known", "value", "pending_ops")

    def __init__(self):
        self.known = False
        self.value: bytes | None = None
        self.pending_ops: list[tuple[MutationType, bytes]] = []

    def resolve(self, base: bytes | None) -> bytes | None:
        """Value this key reads as, given storage value `base`."""
        v = self.value if self.known else base
        for op, operand in self.pending_ops:
            v = apply_atomic_op(op, v, operand)
        return v


class WriteMap:
    """Mutations are recorded append-only; the read-your-writes overlay
    (_points/_clears) materializes lazily on the first overlay query by
    replaying the unapplied mutation suffix in order. Blind-write
    transactions — the common OLTP shape — never read their own writes, so
    they never pay for the dict of _PointWrite objects at all; write
    conflict ranges are derived from the mutation list directly."""

    def __init__(self):
        self.mutations: list[Mutation] = []
        self._points: dict[bytes, _PointWrite] = {}
        self._clears: list[tuple[bytes, bytes]] = []  # disjoint, sorted
        self._applied = 0  # prefix of `mutations` folded into the overlay

    def __bool__(self):
        return bool(self.mutations)

    # -- mutation entry points (hot path: one list append each) --

    def set(self, key: bytes, value: bytes):
        self.mutations.append(make_mutation(MutationType.SET_VALUE, key, value))

    def clear_range(self, begin: bytes, end: bytes):
        self.mutations.append(
            make_mutation(MutationType.CLEAR_RANGE, begin, end))

    def atomic_op(self, op: MutationType, key: bytes, operand: bytes):
        self.mutations.append(make_mutation(op, key, operand))

    # -- overlay materialization --

    def _sync(self):
        """Fold mutations[_applied:] into the overlay, in arrival order."""
        muts = self.mutations
        n = len(muts)
        if self._applied == n:
            return
        points = self._points
        for i in range(self._applied, n):
            m = muts[i]
            t = m.type
            if t == MutationType.SET_VALUE:
                p = points.get(m.param1)
                if p is None:
                    p = points[m.param1] = _PointWrite()
                p.known, p.value, p.pending_ops = True, m.param2, []
            elif t == MutationType.CLEAR_RANGE:
                begin, end = m.param1, m.param2
                for k in [k for k in points if begin <= k < end]:
                    p = points[k]
                    p.known, p.value, p.pending_ops = True, None, []
                self._merge_clear(begin, end)
            else:
                self._apply_atomic(t, m.param1, m.param2)
        self._applied = n

    def _apply_atomic(self, op: MutationType, key: bytes, operand: bytes):
        p = self._points.get(key)
        if p is None:
            p = self._points[key] = _PointWrite()
            if self._cleared(key):
                p.known, p.value = True, None
        if op in (MutationType.SET_VERSIONSTAMPED_KEY,
                  MutationType.SET_VERSIONSTAMPED_VALUE):
            # value unknowable until commit; reads of it are an error in the
            # reference (accessed_unreadable) — model as known-None
            p.known, p.value, p.pending_ops = True, None, []
            return
        if p.known:
            p.value = apply_atomic_op(op, p.value, operand)
        else:
            p.pending_ops.append((op, operand))

    # -- cleared-interval bookkeeping --

    def _merge_clear(self, begin: bytes, end: bytes):
        if not begin < end:
            return
        keep = []
        for b, e in self._clears:
            if e < begin or b > end:
                keep.append((b, e))
            else:
                begin, end = min(begin, b), max(end, e)
        keep.append((begin, end))
        keep.sort()
        self._clears = keep

    def is_cleared(self, key: bytes) -> bool:
        self._sync()
        return self._cleared(key)

    def _cleared(self, key: bytes) -> bool:
        if not self._clears:
            return False  # hot path: read-only transactions
        # bisect on interval begins only: a probe tuple would mis-compare
        # against interval ends that sort above it
        i = bisect.bisect_right(self._clears, key, key=lambda r: r[0]) - 1
        if i < 0:
            return False
        b, e = self._clears[i]
        return b <= key < e

    def clears_intersecting(self, begin: bytes, end: bytes) -> list[tuple[bytes, bytes]]:
        self._sync()
        return [(max(b, begin), min(e, end)) for b, e in self._clears
                if b < end and e > begin]

    # -- read-your-writes lookups --

    def lookup(self, key: bytes) -> tuple[bool, _PointWrite | None, bool]:
        """(has_point_write, point, cleared): overlay state for `key`."""
        self._sync()
        p = self._points.get(key)
        if p is not None:
            return True, p, False
        return False, None, self._cleared(key)

    def points_in_range(self, begin: bytes, end: bytes) -> list[tuple[bytes, _PointWrite]]:
        self._sync()
        return sorted((k, p) for k, p in self._points.items() if begin <= k < end)

    # -- conflict ranges --

    def write_conflict_ranges(self) -> list[tuple[bytes, bytes]]:
        """Union of written points and cleared ranges, coalesced. Derived
        straight from the mutation list — commit must not force the RYW
        overlay into existence for a blind-write transaction."""
        clear_t = MutationType.CLEAR_RANGE
        points = set()
        ranges: list[tuple[bytes, bytes]] = []
        for m in self.mutations:
            if m.type == clear_t:
                if m.param1 < m.param2:
                    ranges.append((m.param1, m.param2))
            else:
                points.add(m.param1)
        ranges += [(k, k + b"\x00") for k in points]
        ranges.sort()
        out: list[tuple[bytes, bytes]] = []
        for b, e in ranges:
            if out and b <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((b, e))
        return out
