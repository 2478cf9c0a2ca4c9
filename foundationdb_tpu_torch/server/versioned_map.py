"""VersionedMap: the storage server's in-memory MVCC window.

Reference: fdbclient/VersionedMap.h — a path-copying tree (PTree :43) serving
reads at any version inside the ~5 s MVCC window, fed by the TLog cursor and
pruned as versions become durable (storageserver.actor.cpp:2358 update,
:2633 updateStorage).

TPU-host design: instead of a persistent tree we keep, per key, an ascending
version chain as PARALLEL lists (versions, values) — a read bisects the
C-typed int list directly (no per-entry key function) — plus one sorted key
index for range reads. Mutations arrive strictly in version order (the TLog ingestion
contract), so chain appends are O(1) amortized and a read at version v binary
searches the chain. ClearRange writes tombstones onto every key live at that
version (chains preserve older versions for concurrent readers).

forget_before(v) drops chain prefixes older than v — the analogue of the
PTree forgetting versions once durable.
"""

from __future__ import annotations

import bisect
from typing import Iterator

from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.types import (
    ATOMIC_OPS, Mutation, MutationType, apply_atomic_op)


class VersionedMap:
    def __init__(self, oldest_version: int = 0):
        from foundationdb_tpu_torch.utils.indexedset import make_indexed_set
        # ordered key index (flow/IndexedSet.h analogue; C skiplist with
        # O(log n) inserts — bisect lists made every first-write O(n))
        self._index = make_indexed_set()
        # key -> ([versions ascending], [values]); parallel lists so the
        # hot read path is one C bisect over ints
        self._chains: dict[bytes, tuple[list[int], list[bytes | None]]] = {}
        self.oldest_version = oldest_version  # reads below this throw
        self.latest_version = oldest_version

    # -- write path (version order enforced by caller) --

    def apply(self, version: int, m: Mutation):
        if version < self.latest_version:
            raise FDBError("internal_error",
                           f"mutation at {version} < latest {self.latest_version}")
        self.latest_version = version
        if m.type == MutationType.SET_VALUE:
            self._put(m.param1, version, m.param2)
        elif m.type == MutationType.CLEAR_RANGE:
            # materialized list: _put may drop fully-cleared keys
            for key in self._index.range_keys(m.param1, m.param2):
                if self._latest_value(key) is not None:
                    self._put(key, version, None)
        elif m.type in ATOMIC_OPS:
            existing = self._latest_value(m.param1)
            self._put(m.param1, version, apply_atomic_op(m.type, existing, m.param2))
        elif m.type == MutationType.NO_OP:
            pass
        else:
            raise FDBError("invalid_mutation_type", str(m.type))

    def _latest_value(self, key: bytes) -> bytes | None:
        chain = self._chains.get(key)
        return chain[1][-1] if chain else None

    def _put(self, key: bytes, version: int, value: bytes | None):
        chain = self._chains.get(key)
        if chain is None:
            if value is None:
                return  # clearing an absent key is a no-op
            self._chains[key] = ([version], [value])
            self._index.insert(key, 1)
            return
        versions, values = chain
        if versions[-1] == version:
            values[-1] = value
        else:
            versions.append(version)
            values.append(value)

    # -- read path --

    def _value_at(self, key: bytes, version: int) -> bytes | None:
        chain = self._chains.get(key)
        if chain is None:
            return None
        # rightmost entry with entry.version <= version: one C bisect over
        # the int list (a key= callable here was the storage read path's
        # single hottest line)
        i = bisect.bisect_right(chain[0], version) - 1
        if i < 0:
            return None
        return chain[1][i]

    def get(self, key: bytes, version: int) -> bytes | None:
        self._check_version(version)
        return self._value_at(key, version)

    def range_read(self, begin: bytes, end: bytes, version: int,
                   limit: int = 0, limit_bytes: int = 0,
                   reverse: bool = False) -> tuple[list[tuple[bytes, bytes]], bool]:
        """Live (key, value) pairs in [begin, end) at `version`.

        Returns (data, more): `more` means a limit cut the scan short
        (storageserver.actor.cpp readRange limit semantics).
        """
        self._check_version(version)
        out: list[tuple[bytes, bytes]] = []
        total = 0
        it = self._iter_keys(begin, end, reverse)
        for key in it:
            v = self._value_at(key, version)
            if v is None:
                continue
            out.append((key, v))
            total += len(key) + len(v)
            if (limit and len(out) >= limit) or (limit_bytes and total >= limit_bytes):
                return out, self._has_live_after(it, version)
        return out, False

    def _has_live_after(self, it: Iterator[bytes], version: int) -> bool:
        for key in it:
            if self._value_at(key, version) is not None:
                return True
        return False

    def _iter_keys(self, begin: bytes, end: bytes, reverse: bool) -> Iterator[bytes]:
        from foundationdb_tpu_torch.utils.indexedset import iter_range
        return iter_range(self._index, begin, end, reverse)

    def _check_version(self, version: int):
        if version < self.oldest_version:
            raise FDBError("transaction_too_old",
                           f"read at {version} < oldest {self.oldest_version}")

    def get_batch(self, reads: list[tuple[bytes, int]]) -> list[tuple]:
        """Per-key results for a GetValuesRequest batch:
        (0, value-or-None) | (1, 'transaction_too_old'). Per-key errors so
        one stale read doesn't fail its neighbors; shard checks (which need
        the server's shard map) stay in the storage handler."""
        chains = self._chains
        oldest = self.oldest_version
        out = []
        for k, v in reads:
            if v < oldest:
                out.append((1, "transaction_too_old"))
            else:
                c = chains.get(k)
                if c is None:
                    out.append((0, None))
                else:
                    i = bisect.bisect_right(c[0], v) - 1
                    out.append((0, c[1][i] if i >= 0 else None))
        return out

    # selector resolution (storageserver.actor.cpp findKey)
    def resolve_selector(self, sel, version: int) -> bytes:
        """Resolve a KeySelector to a live key (or b''/\\xff sentinels)."""
        # forward: offset >= 1 means "offset-th live key at-or-after"
        if sel.offset >= 1:
            skip = sel.offset - 1
            begin = sel.key + (b"\x00" if sel.or_equal else b"")
            data, _ = self.range_read(begin, b"\xff" * 32, version,
                                      limit=skip + 1)
            if len(data) > skip:
                return data[skip][0]
            # past the end: \xff\xff (the systemKeys end) — a plain \xff
            # sentinel would sort BELOW \xff-prefixed system keys and fold
            # system-range reads empty
            return b"\xff\xff"
        # backward: offset <= 0 means "(1-offset)-th live key before"
        skip = -sel.offset
        end = sel.key + (b"\x00" if sel.or_equal else b"")
        data, _ = self.range_read(b"", end, version, limit=skip + 1,
                                  reverse=True)
        if len(data) > skip:
            return data[skip][0]
        return b""

    # -- GC (updateStorage analogue) --

    def forget_before(self, version: int):
        """Drop history below `version`; reads below it now throw."""
        if version <= self.oldest_version:
            return
        self.oldest_version = version
        dead: list[bytes] = []
        for key, (versions, values) in self._chains.items():
            i = bisect.bisect_right(versions, version) - 1
            if i > 0:
                del versions[:i]
                del values[:i]
            if len(versions) == 1 and values[0] is None:
                dead.append(key)
        for key in dead:
            del self._chains[key]
            self._index.discard(key)

    def rollback(self, version: int):
        """Discard versions > `version` (storageserver.actor.cpp:2211): a
        master recovery chose `version` as the epoch end, so anything newer
        in memory was never committed and must vanish before the new epoch's
        mutations (which reuse higher version numbers) arrive."""
        if version >= self.latest_version:
            return
        dead: list[bytes] = []
        for key, (versions, values) in self._chains.items():
            i = bisect.bisect_right(versions, version)
            if i < len(versions):
                del versions[i:]
                del values[i:]
            if not versions:
                dead.append(key)
        for key in dead:
            del self._chains[key]
            self._index.discard(key)
        self.latest_version = version

    # -- introspection --

    def key_count(self) -> int:
        return len(self._index)

    def byte_size(self) -> int:
        return sum(len(k) + sum(len(v or b"") + 16 for v in c[1])
                   for k, c in self._chains.items())


class NativeVersionedMap:
    """C-backed MVCC window (native/fdb_native.c VStore): one skiplist holds
    both the key index and the per-key version chains, so a point get is a
    single C call (descend + chain bisect) instead of a dict probe plus a
    Python bisect, and range reads / selector resolution never cross the
    C↔Python boundary per key. Version policy (oldest/latest tracking,
    order enforcement) lives here; parity with VersionedMap is fuzz-tested.

    The *_encoded methods return a complete wire frame (bytes) for the
    corresponding reply dataclass — the storage server sends them through
    transport's pre-encoded path so a remote read reply costs zero
    per-KV Python serialization.
    """

    def __init__(self, oldest_version: int = 0):
        from foundationdb_tpu_torch import native
        self._store = native.mod.VStore()
        self.oldest_version = oldest_version
        self.latest_version = oldest_version

    # -- write path (version order enforced by caller) --

    def apply(self, version: int, m: Mutation):
        if version < self.latest_version:
            raise FDBError("internal_error",
                           f"mutation at {version} < latest {self.latest_version}")
        self.latest_version = version
        t = m.type
        if t == MutationType.SET_VALUE:
            self._store.put(m.param1, version, m.param2)
        elif t == MutationType.CLEAR_RANGE:
            self._store.clear_range(m.param1, m.param2, version)
        elif t in ATOMIC_OPS:
            existing = self._store.latest(m.param1)
            self._store.put(m.param1, version,
                            apply_atomic_op(t, existing, m.param2))
        elif t == MutationType.NO_OP:
            pass
        else:
            raise FDBError("invalid_mutation_type", str(m.type))

    # -- read path --

    def get(self, key: bytes, version: int) -> bytes | None:
        self._check_version(version)
        return self._store.get(key, version)

    def get_batch(self, reads: list[tuple[bytes, int]]) -> list[tuple]:
        return self._store.get_many(reads, self.oldest_version)

    def get_batch_encoded(self, reads: list[tuple[bytes, int]]) -> bytes:
        return self._store.get_many_encode(
            reads, self.oldest_version, _get_values_reply_id())

    def range_read(self, begin: bytes, end: bytes, version: int,
                   limit: int = 0, limit_bytes: int = 0,
                   reverse: bool = False) -> tuple[list[tuple[bytes, bytes]], bool]:
        self._check_version(version)
        return self._store.range_read(begin, end, version, limit,
                                      limit_bytes, reverse)

    def range_read_encoded(self, begin: bytes, end: bytes, version: int,
                           limit: int, limit_bytes: int,
                           reverse: bool) -> bytes:
        self._check_version(version)
        return self._store.range_read_encode(
            begin, end, version, limit, limit_bytes, reverse,
            _get_key_values_reply_id())

    def resolve_selector(self, sel, version: int) -> bytes:
        self._check_version(version)
        return self._store.resolve_selector(
            sel.key, sel.or_equal, sel.offset, version)

    def _check_version(self, version: int):
        if version < self.oldest_version:
            raise FDBError("transaction_too_old",
                           f"read at {version} < oldest {self.oldest_version}")

    # -- GC (updateStorage analogue) --

    def forget_before(self, version: int):
        if version <= self.oldest_version:
            return
        self.oldest_version = version
        self._store.forget_before(version)

    def rollback(self, version: int):
        if version >= self.latest_version:
            return
        self._store.rollback(version)
        self.latest_version = version

    # -- introspection --

    def key_count(self) -> int:
        return len(self._store)

    def byte_size(self) -> int:
        return self._store.byte_size()


def _get_values_reply_id() -> int:
    global _GV_ID
    if _GV_ID is None:
        from foundationdb_tpu_torch.server.interfaces import GetValuesReply
        from foundationdb_tpu_torch.utils import wire
        _GV_ID = wire.type_id(GetValuesReply)
    return _GV_ID


def _get_key_values_reply_id() -> int:
    global _GKV_ID
    if _GKV_ID is None:
        from foundationdb_tpu_torch.server.interfaces import GetKeyValuesReply
        from foundationdb_tpu_torch.utils import wire
        _GKV_ID = wire.type_id(GetKeyValuesReply)
    return _GKV_ID


_GV_ID: int | None = None
_GKV_ID: int | None = None


def make_versioned_map(oldest_version: int = 0):
    """C-backed store when the extension is present, else the pure-Python
    one (same surface; parity fuzz-tested in tests/test_vstore_parity.py)."""
    from foundationdb_tpu_torch import native
    if native.available() and hasattr(native.mod, "VStore"):
        return NativeVersionedMap(oldest_version)
    return VersionedMap(oldest_version)
