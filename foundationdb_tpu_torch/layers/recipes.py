"""Layer recipes: the classic data structures built ON the key-value API.

Reference: the design-recipes documentation
(documentation/sphinx/source/*-recipes.rst + class-scheduling tutorials) —
the point of the layer concept: counters, queues and secondary indexes are
ordinary transactions over subspaces, not database features. Each recipe
here is transactional end to end (the index can never diverge from the rows
it indexes, a dequeue can never lose or double-deliver an item committed
exactly once).
"""

from __future__ import annotations

from foundationdb_tpu_torch.layers.subspace import Subspace
from foundationdb_tpu_torch.utils.types import MutationType


class Counter:
    """High-frequency counter (counter recipe): atomic adds never conflict
    with each other, so N writers scale without retries."""

    def __init__(self, subspace: Subspace, name: str = "counter"):
        self._key = subspace.pack((name,))

    def add(self, tr, delta: int = 1):
        tr.atomic_op(MutationType.ADD_VALUE, self._key,
                     delta.to_bytes(8, "little", signed=True))

    async def value(self, tr) -> int:
        raw = await tr.get(self._key)
        return int.from_bytes(raw or b"", "little", signed=True)


class Queue:
    """FIFO queue (queue recipe): versionstamped keys give every push a
    globally-ordered unique position with NO conflict between concurrent
    pushers; pop takes the first item transactionally."""

    def __init__(self, subspace: Subspace):
        self._sub = subspace

    def push(self, tr, value: bytes):
        # key = subspace + 10-byte versionstamp placeholder, offset trailer
        body = self._sub.key + b"\x00" * 10
        key = body + (len(self._sub.key)).to_bytes(4, "little")
        tr.atomic_op(MutationType.SET_VERSIONSTAMPED_KEY, key, value)

    async def pop(self, tr) -> bytes | None:
        rows = await tr.get_range(self._sub.key, self._sub.key + b"\xff",
                                  limit=1)
        if not rows:
            return None
        k, v = rows[0]
        tr.clear(k)
        return v

    async def peek_all(self, tr) -> list[bytes]:
        rows = await tr.get_range(self._sub.key, self._sub.key + b"\xff")
        return [v for _k, v in rows]


class Index:
    """Secondary index (simple-indexes recipe): the row and its index entry
    ride one transaction, so a reader via the index always finds a live row
    and an updated row never strands a stale entry."""

    def __init__(self, rows: Subspace, index: Subspace):
        self._rows = rows
        self._index = index

    async def set(self, tr, pk, value: bytes, indexed):
        old = await tr.get(self._rows.pack((pk,)))
        if old is not None:
            old_idx = await tr.get(self._rows.pack((pk, "idx")))
            if old_idx is not None:
                import foundationdb_tpu_torch.layers.tuple as tuple_layer
                (old_key,) = tuple_layer.unpack(old_idx)
                tr.clear(self._index.pack((old_key, pk)))
        tr.set(self._rows.pack((pk,)), value)
        import foundationdb_tpu_torch.layers.tuple as tuple_layer
        tr.set(self._rows.pack((pk, "idx")), tuple_layer.pack((indexed,)))
        tr.set(self._index.pack((indexed, pk)), b"")

    async def get(self, tr, pk) -> bytes | None:
        return await tr.get(self._rows.pack((pk,)))

    async def query(self, tr, indexed) -> list:
        """Primary keys whose indexed value equals `indexed`."""
        pre = self._index.pack((indexed,))
        rows = await tr.get_range(pre, pre + b"\xff")
        return [self._index.unpack(k)[-1] for k, _v in rows]
