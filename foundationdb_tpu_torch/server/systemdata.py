"""The `\\xff` system keyspace: metadata keys, codecs, and the txnStateStore.

Reference: fdbclient/SystemData.cpp:1 (keyServers et al. key codecs),
fdbserver/ApplyMetadataMutation.h:1 (how proxies fold metadata mutations into
their cached txnStateStore + keyInfo map).

The shard-routing map lives in the database itself under
`\\xff/keyServers/<begin>` -> encoded team tags: the shard beginning at
`<begin>` (up to the next keyServers entry) is served by those storage tags.
Every proxy keeps the system keyspace in an in-memory TxnStateStore and
derives its ShardMap from it; changes flow through the COMMIT PIPELINE as
ordinary transactions whose mutations touch `\\xff` (resolved by all
resolvers, applied by every proxy in version order) — the reference's
mechanism for every online reconfiguration.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right, insort

from foundationdb_tpu_torch.utils.types import Mutation, MutationType

SYSTEM_PREFIX = b"\xff"
KEY_SERVERS_PREFIX = b"\xff/keyServers/"
KEY_SERVERS_END = b"\xff/keyServers0"  # '0' = '/'+1
CONF_PREFIX = b"\xff/conf/"
CONF_END = b"\xff/conf0"


def keyservers_key(begin: bytes) -> bytes:
    return KEY_SERVERS_PREFIX + begin


def encode_tags(tags: list[int]) -> bytes:
    """Team tags for one shard (SystemData keyServersValue analogue)."""
    return b",".join(b"%d" % t for t in tags)


def decode_tags(value: bytes) -> list[int]:
    return [int(x) for x in value.split(b",")] if value else []


def mutation_overlaps(m: Mutation, begin: bytes, end: bytes) -> bool:
    """Does this mutation touch [begin, end)? (point mutations are their
    key; clears are their range)."""
    if m.type == MutationType.CLEAR_RANGE:
        return m.param1 < end and m.param2 > begin
    return begin <= m.param1 < end


def is_metadata_mutation(m: Mutation) -> bool:
    """Does this mutation touch the system keyspace? (the proxy's
    isMetadataMutation test, MasterProxyServer.actor.cpp:278)."""
    return mutation_overlaps(m, SYSTEM_PREFIX, b"\xff\xff")


def build_keyservers_snapshot(boundaries: list[bytes],
                              teams: list[list[int]]) -> list[tuple[bytes, bytes]]:
    """Full \\xff/keyServers contents for a layout (recovery seeding —
    the sendInitialCommitToResolvers analogue, masterserver.actor.cpp:690)."""
    return [(keyservers_key(b), encode_tags(t))
            for b, t in zip(boundaries, teams)]


def parse_keyservers(items: list[tuple[bytes, bytes]]):
    """Inverse of build_keyservers_snapshot: sorted (boundaries, teams)."""
    boundaries: list[bytes] = []
    teams: list[list[int]] = []
    for k, v in items:
        assert k.startswith(KEY_SERVERS_PREFIX), k
        boundaries.append(k[len(KEY_SERVERS_PREFIX):])
        teams.append(decode_tags(v))
    return boundaries, teams


class TxnStateStore:
    """Sorted in-memory KV for the system keyspace subset a proxy caches
    (the reference's txnStateStore, a KeyValueStoreMemory over the log
    adapter; ours is seeded from the recovery snapshot and maintained purely
    by applied metadata mutations)."""

    def __init__(self, items: list[tuple[bytes, bytes]] | None = None):
        self._keys: list[bytes] = []
        self._vals: dict[bytes, bytes] = {}
        for k, v in sorted(items or []):
            self._keys.append(k)
            self._vals[k] = v

    def get(self, key: bytes) -> bytes | None:
        return self._vals.get(key)

    def set(self, key: bytes, value: bytes):
        if key not in self._vals:
            insort(self._keys, key)
        self._vals[key] = value

    def clear_range(self, begin: bytes, end: bytes):
        i0 = bisect_left(self._keys, begin)
        i1 = bisect_left(self._keys, end)
        for k in self._keys[i0:i1]:
            del self._vals[k]
        del self._keys[i0:i1]

    def get_range(self, begin: bytes, end: bytes) -> list[tuple[bytes, bytes]]:
        i0 = bisect_left(self._keys, begin)
        i1 = bisect_left(self._keys, end)
        return [(k, self._vals[k]) for k in self._keys[i0:i1]]

    def apply(self, m: Mutation):
        from foundationdb_tpu_torch.utils.types import ATOMIC_OPS, apply_atomic_op
        if m.type == MutationType.SET_VALUE:
            self.set(m.param1, m.param2)
        elif m.type == MutationType.CLEAR_RANGE:
            self.clear_range(m.param1, m.param2)
        elif m.type in ATOMIC_OPS:
            self.set(m.param1, apply_atomic_op(m.type, self.get(m.param1),
                                               m.param2))

    def snapshot(self) -> list[tuple[bytes, bytes]]:
        return [(k, self._vals[k]) for k in self._keys]
