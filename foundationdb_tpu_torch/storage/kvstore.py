"""Pluggable durable KV engines behind one interface.

Reference: fdbserver/IKeyValueStore.h:38-87 (interface + openKVStore dispatch
on KeyValueStoreType, fdbclient/FDBTypes.h:472). Engines here:

- MemoryKeyValueStore — the reference's `memory` engine
  (KeyValueStoreMemory.actor.cpp): all data in RAM, durability via a DiskQueue
  WAL of operations with periodic full snapshots; recovery replays
  snapshot + ops. Deterministic under the simulator (WAL on SimFiles).
- SSDKeyValueStore — the reference's `ssd` engine
  (KeyValueStoreSQLite.actor.cpp, a vendored SQLite B-tree). Here: the
  platform SQLite via the stdlib binding over a real file — a host B-tree for
  real deployments; not used inside the deterministic simulator.
- RedwoodKeyValueStore (storage/redwood.py) — the reference's
  `ssd-redwood-v1` direction (VersionedBTree.actor.cpp): WAL + memtable +
  immutable prefix-compressed sorted runs with leveled background
  compaction, for datasets the memory engine can't hold resident. Runs on
  SimFiles under the simulator (kill-injected durability faults apply) and
  on real files over the net transport.

Engines are synchronous at this layer; roles call commit() at their own
group-commit points (the event loop is cooperative, so a sync commit is a
deterministic scheduling point, so simulation determinism is preserved).
"""

from __future__ import annotations

from typing import Iterable, Protocol

from foundationdb_tpu_torch.storage.diskqueue import DiskQueue
from foundationdb_tpu_torch.utils import wire
from foundationdb_tpu_torch.utils.errors import FDBError

# WAL op tags
_OP_SET = 0
_OP_CLEAR = 1
_OP_META = 2  # durable metadata (e.g. storage server's durable version)
_OP_SNAPSHOT = 3  # full-state snapshot chunk


class IKeyValueStore(Protocol):
    def set(self, key: bytes, value: bytes) -> None: ...
    def clear_range(self, begin: bytes, end: bytes) -> None: ...
    def set_metadata(self, key: str, value: bytes) -> None: ...
    def get_metadata(self, key: str) -> bytes | None: ...
    def get(self, key: bytes) -> bytes | None: ...
    def get_range(self, begin: bytes, end: bytes, limit: int = -1,
                  reverse: bool = False) -> list[tuple[bytes, bytes]]: ...
    def commit(self) -> None: ...
    def recover(self) -> None: ...


class MemoryKeyValueStore:
    """Hashmap + sorted index in RAM; DiskQueue WAL + snapshot for durability.

    Commit atomicity: mutations accumulate in a pending list and one commit()
    writes them as a SINGLE checksummed WAL entry — recovery sees a commit
    batch entirely or not at all. This matters for correctness of the storage
    server's updateStorage: its durable-version metadata must land atomically
    with the mutations it covers, or non-idempotent atomic ops would be
    re-applied after a crash (the reference gets the same property from its
    storage engines' transactional commits, IKeyValueStore.h commit()).
    """

    SNAPSHOT_OPS = 10_000  # ops between snapshots (KNOB-ish; small for sim)

    def __init__(self, file0, file1):
        from foundationdb_tpu_torch.utils.indexedset import make_indexed_set
        self.queue = DiskQueue(file0, file1)
        self._data: dict[bytes, bytes] = {}
        # size-augmented ordered index (flow/IndexedSet.h): O(log n)
        # inserts and O(log n) byte sums over ranges (shard metrics)
        self._index = make_indexed_set()
        self._meta: dict[str, bytes] = {}
        self._pending: list[tuple] = []
        self._ops_since_snapshot = 0

    # -- mutation --

    def set(self, key: bytes, value: bytes) -> None:
        self._apply_set(key, value)
        self._pending.append((_OP_SET, key, value))

    def clear_range(self, begin: bytes, end: bytes) -> None:
        self._apply_clear(begin, end)
        self._pending.append((_OP_CLEAR, begin, end))

    def set_metadata(self, key: str, value: bytes) -> None:
        self._meta[key] = value
        self._pending.append((_OP_META, key, value))

    def get_metadata(self, key: str) -> bytes | None:
        return self._meta.get(key)

    def _apply_set(self, key: bytes, value: bytes):
        self._index.insert(key, len(key) + len(value))
        self._data[key] = value

    def _apply_clear(self, begin: bytes, end: bytes):
        for k in self._index.range_keys(begin, end):
            del self._data[k]
            self._index.discard(k)

    # -- reads (always from RAM, like the reference memory engine) --

    def get(self, key: bytes) -> bytes | None:
        return self._data.get(key)

    def get_range(self, begin: bytes, end: bytes, limit: int = -1,
                  reverse: bool = False) -> list[tuple[bytes, bytes]]:
        if limit == 0:
            return []  # limit semantics: 0 rows; unlimited is limit < 0
        keys = self._index.range_keys(begin, end, max(limit, 0), reverse)
        return [(k, self._data[k]) for k in keys]

    def bytes_range(self, begin: bytes, end: bytes) -> tuple[int, int]:
        """(row count, key+value bytes) over [begin, end) in O(log n) —
        the augmented-sum read shard metrics are built on (the reference's
        byteSample serves the same query, storageserver byteSampleApplySet;
        here the index sum is exact rather than sampled)."""
        return self._index.sum_range(begin, end)

    def split_key(self, begin: bytes, end: bytes) -> bytes | None:
        """Median-by-count split candidate in O(log n)."""
        n, _b = self._index.sum_range(begin, end)
        if n < 4:
            return None
        k = self._index.nth(self._index.rank(begin) + n // 2)
        return None if k == begin else k

    # -- durability --

    def commit(self) -> None:
        if self._pending:
            self.queue.push(wire.dumps(self._pending))
            self._ops_since_snapshot += len(self._pending)
            self._pending = []
        if self._ops_since_snapshot >= self.SNAPSHOT_OPS:
            self._write_snapshot()
        self.queue.commit()

    def _write_snapshot(self):
        """Full-state snapshot entry, then pop everything before it — the
        memory engine's log compaction (KeyValueStoreMemory semantics)."""
        snap = wire.dumps(
            [(_OP_SNAPSHOT, list(self._data.items()), dict(self._meta))])
        seq = self.queue.push(snap)
        self.queue.commit()
        self.queue.pop(seq)
        self._ops_since_snapshot = 0

    def recover(self) -> None:
        from foundationdb_tpu_torch.utils.indexedset import make_indexed_set
        self._data.clear()
        self._index = make_indexed_set()
        self._meta.clear()
        self._pending = []
        for _seq, payload in self.queue.recover():
            try:
                ops = wire.loads(payload)
            except wire.WireError as e:
                # DiskQueue checksums passed but the body is not ours: not a
                # torn tail, an incompatible/corrupt store (file_corrupt in
                # the reference's IKeyValueStore recovery)
                raise FDBError("file_corrupt", f"WAL entry undecodable: {e}")
            for op in ops:
                if op[0] == _OP_SNAPSHOT:
                    self._data = dict(op[1])
                    self._meta = dict(op[2])
                elif op[0] == _OP_SET:
                    self._data[op[1]] = op[2]
                elif op[0] == _OP_CLEAR:
                    for k in [k for k in self._data if op[1] <= k < op[2]]:
                        del self._data[k]
                elif op[0] == _OP_META:
                    self._meta[op[1]] = op[2]
        for k, v in self._data.items():
            self._index.insert(k, len(k) + len(v))
        self._ops_since_snapshot = 0


class SSDKeyValueStore:
    """Host B-tree engine over the platform SQLite (real deployments).

    The reference's ssd engine is a vendored SQLite B-tree driven through
    IKeyValueStore (KeyValueStoreSQLite.actor.cpp); binding the platform
    library gives the same storage shape without vendoring 150k LoC.
    """

    def __init__(self, path: str):
        import sqlite3

        # check_same_thread=False: the storage server commits off the actor
        # loop through run_blocking, which under the real event loop runs in
        # a worker thread; SQLite itself is serialized-mode thread-safe
        self.db = sqlite3.connect(path, isolation_level=None,
                                  check_same_thread=False)
        self.db.execute("PRAGMA journal_mode=WAL")
        self.db.execute("PRAGMA synchronous=FULL")
        self.db.execute(
            "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB) WITHOUT ROWID")
        self.db.execute(
            "CREATE TABLE IF NOT EXISTS meta (k TEXT PRIMARY KEY, v BLOB)")
        self.db.execute("BEGIN")

    def set(self, key: bytes, value: bytes) -> None:
        self.db.execute("INSERT OR REPLACE INTO kv VALUES (?, ?)", (key, value))

    def clear_range(self, begin: bytes, end: bytes) -> None:
        self.db.execute("DELETE FROM kv WHERE k >= ? AND k < ?", (begin, end))

    def set_metadata(self, key: str, value: bytes) -> None:
        self.db.execute("INSERT OR REPLACE INTO meta VALUES (?, ?)", (key, value))

    def get_metadata(self, key: str) -> bytes | None:
        row = self.db.execute("SELECT v FROM meta WHERE k = ?", (key,)).fetchone()
        return row[0] if row else None

    def get(self, key: bytes) -> bytes | None:
        row = self.db.execute("SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return row[0] if row else None

    def get_range(self, begin: bytes, end: bytes, limit: int = -1,
                  reverse: bool = False) -> list[tuple[bytes, bytes]]:
        order = "DESC" if reverse else "ASC"
        q = f"SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k {order}"
        if limit >= 0:
            q += f" LIMIT {int(limit)}"
        return [(bytes(k), bytes(v))
                for k, v in self.db.execute(q, (begin, end)).fetchall()]

    def commit(self) -> None:
        self.db.execute("COMMIT")
        self.db.execute("BEGIN")

    def recover(self) -> None:
        pass  # SQLite recovers via its own WAL on connect


# the KeyValueStoreType universe (FDBTypes.h:472) — "ssd-2" is an alias the
# reference keeps for its second sqlite format; redwood is the log-structured
# engine in storage/redwood.py
VALID_STORAGE_ENGINES = ("memory", "ssd", "ssd-2", "redwood")


def validate_storage_engine(name: str) -> None:
    """Fail FAST on a bad STORAGE_ENGINE — at worker boot, not on the first
    storage recruitment minutes later (and never by silently falling back
    to some other engine)."""
    if name not in VALID_STORAGE_ENGINES:
        raise FDBError(
            "invalid_option",
            f"unknown STORAGE_ENGINE {name!r}: valid engines are "
            + ", ".join(VALID_STORAGE_ENGINES))


def open_kv_store(store_type: str, **kwargs) -> IKeyValueStore:
    """openKVStore dispatch (IKeyValueStore.h:66, KeyValueStoreType)."""
    if store_type == "memory":
        return MemoryKeyValueStore(kwargs["file0"], kwargs["file1"])
    if store_type in ("ssd", "ssd-2"):
        return SSDKeyValueStore(kwargs["path"])
    if store_type == "redwood":
        from foundationdb_tpu_torch.storage.redwood import RedwoodKeyValueStore
        return RedwoodKeyValueStore(kwargs["file0"], kwargs["file1"],
                                    kwargs["open_file"],
                                    kwargs.get("existing_files"))
    validate_storage_engine(store_type)  # raises with the valid list
    raise FDBError("invalid_option", f"unknown storage engine {store_type}")
