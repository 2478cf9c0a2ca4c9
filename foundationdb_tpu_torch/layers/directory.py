"""Directory layer: path -> short-prefix mapping stored in the database.

Reference: bindings/python/fdb/directory_impl.py — directories map
human-readable paths to SHORT allocated prefixes so deep paths don't bloat
every key. The reference allocates prefixes with a high-contention allocator
(HCA); here allocation is a plain transactional counter under the node
subspace (simpler, serialized through the normal conflict path — fine at sim
scale; an HCA analogue can replace it without changing the API).

Layout (all under raw prefix \\xfe, like the reference's default node_ss):
  (\\xfe, "alloc")                 -> next prefix id (atomic ADD)
  (\\xfe, "node", *path)          -> packed short prefix for that directory
"""

from __future__ import annotations

import struct

from foundationdb_tpu_torch.layers.subspace import Subspace
from foundationdb_tpu_torch.utils.types import MutationType


class DirectorySubspace(Subspace):
    def __init__(self, path: tuple, raw_prefix: bytes, layer: "DirectoryLayer"):
        super().__init__(raw_prefix=raw_prefix)
        self.path = path
        self._layer = layer


class DirectoryLayer:
    def __init__(self, node_prefix: bytes = b"\xfe",
                 content_prefix: bytes = b"\x15"):
        self._nodes = Subspace(raw_prefix=node_prefix)
        self._alloc_key = self._nodes.pack(("alloc",))
        self._content_prefix = content_prefix

    async def create_or_open(self, tr, path) -> DirectorySubspace:
        """Open (creating recursively) the directory at `path` (tuple of
        strings). Call within a transaction; retries via the caller's loop."""
        path = tuple(path)
        if not path:
            raise ValueError("the root directory cannot be opened")
        prefix = None
        for i in range(1, len(path) + 1):
            prefix = await self._open_one(tr, path[:i])
        return DirectorySubspace(path, prefix, self)

    async def _open_one(self, tr, path: tuple) -> bytes:
        node_key = self._nodes.pack(("node",) + path)
        existing = await tr.get(node_key)
        if existing is not None:
            return existing
        # allocate the next short prefix. NOTE: reading the counter in the
        # same transaction adds a read conflict on it, so concurrent
        # directory creations serialize through retries — the contention the
        # reference's high-contention allocator avoids; an HCA analogue can
        # slot in here without changing the directory API
        tr.atomic_op(MutationType.ADD_VALUE, self._alloc_key,
                     struct.pack("<q", 1))
        raw = await tr.get(self._alloc_key)
        n = struct.unpack("<q", raw.ljust(8, b"\x00"))[0]
        prefix = self._content_prefix + struct.pack(">I", n)
        tr.set(node_key, prefix)
        return prefix

    async def open(self, tr, path) -> DirectorySubspace | None:
        path = tuple(path)
        prefix = await tr.get(self._nodes.pack(("node",) + path))
        if prefix is None:
            return None
        return DirectorySubspace(path, prefix, self)

    async def list(self, tr, path=()) -> list[str]:
        """Immediate children of `path`."""
        path = tuple(path)
        lo, hi = self._nodes.range(("node",) + path)
        rows = await tr.get_range(lo, hi)
        out = []
        for k, _v in rows:
            child = self._nodes.unpack(k)[1 + len(path):]
            if len(child) == 1:
                out.append(child[0])
        return out

    async def remove(self, tr, path) -> bool:
        """Remove the directory, its subdirectories, and their contents."""
        path = tuple(path)
        node = await self.open(tr, path)
        if node is None:
            return False
        # clear content of this node and every subdirectory
        sub_lo, sub_hi = self._nodes.range(("node",) + path)
        rows = await tr.get_range(sub_lo, sub_hi)
        for _k, prefix in rows:
            tr.clear_range(prefix, prefix + b"\xff")
        tr.clear_range(node.key, node.key + b"\xff")
        # clear the node entries themselves
        tr.clear(self._nodes.pack(("node",) + path))
        tr.clear_range(sub_lo, sub_hi)
        return True
