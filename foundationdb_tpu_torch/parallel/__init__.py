"""The key-partitioned conflict engine: one resolver's state split by key
range over a list of devices (foundationdb_tpu/parallel of the JAX package).

The reference scales conflict detection by partitioning the keyspace across
resolvers (SURVEY.md §2.0; fdbserver/MasterProxyServer.actor.cpp:283-306
fan-out, masterserver.actor.cpp:955 resolutionBalancing); each device here
holds one shard, checks and merges only the ranges clipped to it, and the
per-transaction verdicts combine by min, the proxy's rule
(MasterProxyServer.actor.cpp:492-504).
"""

from foundationdb_tpu_torch.parallel.sharded_conflict import (
    ShardedDeviceConflictSet, make_resolver_mesh, shard_cut_keys,
    sharded_conflict_step)

__all__ = [
    "ShardedDeviceConflictSet",
    "make_resolver_mesh",
    "shard_cut_keys",
    "sharded_conflict_step",
]
