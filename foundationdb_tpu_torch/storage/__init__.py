"""Durable storage primitives: DiskQueue WAL and pluggable KV engines.

Reference layer: fdbserver/DiskQueue.actor.cpp (durable append-only queue of
two alternating checksummed files), fdbserver/IKeyValueStore.h (engine
interface), fdbserver/KeyValueStoreMemory.actor.cpp (hashmap + WAL/snapshot
memory engine), fdbserver/KeyValueStoreSQLite.actor.cpp (ssd B-tree engine).
"""

from foundationdb_tpu_torch.storage.diskqueue import DiskQueue
from foundationdb_tpu_torch.storage.kvstore import (
    IKeyValueStore, MemoryKeyValueStore, SSDKeyValueStore, open_kv_store)

__all__ = [
    "DiskQueue",
    "IKeyValueStore",
    "MemoryKeyValueStore",
    "SSDKeyValueStore",
    "open_kv_store",
]
