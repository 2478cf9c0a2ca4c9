"""Subspace: a keyspace region identified by a tuple prefix.

Reference: bindings/python/fdb/subspace_impl.py — thin sugar over the tuple
layer: every key in the subspace starts with the packed prefix; pack/unpack
translate between logical tuples and raw keys; range() bounds a scan of all
children.
"""

from __future__ import annotations

from foundationdb_tpu_torch.layers import tuple as tuple_layer


class Subspace:
    def __init__(self, prefix_tuple: tuple = (), raw_prefix: bytes = b""):
        self._prefix = raw_prefix + tuple_layer.pack(prefix_tuple)

    @property
    def key(self) -> bytes:
        return self._prefix

    def pack(self, t: tuple = ()) -> bytes:
        return tuple_layer.pack(t, self._prefix)

    def unpack(self, key: bytes) -> tuple:
        if not self.contains(key):
            raise ValueError("key is not in this subspace")
        return tuple_layer.unpack(key, len(self._prefix))

    def contains(self, key: bytes) -> bool:
        return key.startswith(self._prefix)

    def range(self, t: tuple = ()) -> tuple[bytes, bytes]:
        p = tuple_layer.pack(t, self._prefix)
        return p + b"\x00", p + b"\xff"

    def subspace(self, t: tuple) -> "Subspace":
        return Subspace(raw_prefix=self.pack(t))

    def __getitem__(self, item) -> "Subspace":
        return self.subspace((item,))

    def __repr__(self):
        return f"Subspace({self._prefix!r})"
