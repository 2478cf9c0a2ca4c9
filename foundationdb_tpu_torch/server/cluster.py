"""SimCluster: boot a whole database cluster inside the deterministic simulator.

Reference: fdbserver/SimulatedCluster.actor.cpp (setupSimulatedSystem :1239) —
the simulator runs the REAL role code on simulated processes; tests then drive
workloads against a Database handle and inject faults through the SimNetwork.

Topology: 1 master, P proxies, R resolvers (key-partitioned), L tlogs
(replicated; quorum = L - antiquorum), S storage servers (key-sharded, one
tag each). Roles are constructed directly, as in the JAX package's
server/cluster.py; the resolvers are the port's, so with
CONFLICT_BACKEND=device their conflict engines run on CONFLICT_DEVICE.
RecoverableCluster (coordinators, workers and the recruiting cluster
controller) is not ported yet.
"""

from __future__ import annotations

from foundationdb_tpu_torch.client.database import Database, LocationCache
from foundationdb_tpu_torch.core.eventloop import EventLoop
from foundationdb_tpu_torch.core.future import all_of
from foundationdb_tpu_torch.core.sim import Endpoint, SimNetwork
from foundationdb_tpu_torch.server.interfaces import Token
from foundationdb_tpu_torch.server.master import Master
from foundationdb_tpu_torch.server.proxy import Proxy, ResolverMap, ShardMap
from foundationdb_tpu_torch.server.resolver import Resolver
from foundationdb_tpu_torch.server.storage import StorageServer
from foundationdb_tpu_torch.server.tlog import TLog
from foundationdb_tpu_torch.utils.keys import (
    partition_boundaries as _partition_boundaries)
from foundationdb_tpu_torch.utils.rng import DeterministicRandom


class SimCluster:
    def __init__(self, seed: int = 0, n_proxies: int = 1, n_resolvers: int = 1,
                 n_tlogs: int = 1, n_storage: int = 1,
                 loop: EventLoop | None = None,
                 net: SimNetwork | None = None, name_prefix: str = "",
                 n_grv_proxies: int = 0):
        """`loop`/`net`/`name_prefix` let several clusters share one
        deterministic simulation (the DR topology: two live databases)."""
        self.loop = loop or EventLoop()
        self.rng = DeterministicRandom(seed)
        self.net = net or SimNetwork(self.loop, self.rng.fork())
        self.name_prefix = name_prefix
        P = name_prefix

        # -- processes --
        self.master_proc = self.net.new_process(f"{P}master:0", dc_id="dc0")
        self.proxy_procs = [self.net.new_process(f"{P}proxy:{i}") for i in range(n_proxies)]
        self.grv_proxy_procs = [self.net.new_process(f"{P}grvproxy:{i}")
                                for i in range(n_grv_proxies)]
        self.resolver_procs = [self.net.new_process(f"{P}resolver:{i}") for i in range(n_resolvers)]
        self.tlog_procs = [self.net.new_process(f"{P}tlog:{i}") for i in range(n_tlogs)]
        self.storage_procs = [self.net.new_process(f"{P}storage:{i}") for i in range(n_storage)]

        # -- endpoints --
        master_ep = Endpoint(f"{P}master:0", Token.MASTER_GET_COMMIT_VERSION)
        resolver_eps = [Endpoint(p.address, Token.RESOLVER_RESOLVE)
                        for p in self.resolver_procs]
        tlog_eps = [Endpoint(p.address, Token.TLOG_COMMIT) for p in self.tlog_procs]
        self.proxy_addrs = [p.address for p in self.proxy_procs]
        self.grv_proxy_addrs = [p.address for p in self.grv_proxy_procs]

        # -- role state --
        self.master = Master(self.master_proc)
        # outer key split: resolver i owns [rb[i], rb[i+1]); the sharded
        # backend's cuts subdivide that range (inner split), so
        # n_resolvers > 1 topologies and the sharded engine compose
        resolver_bounds = _partition_boundaries(n_resolvers)
        self.resolvers = [
            Resolver(p, n_proxies=n_proxies,
                     key_range_begin=resolver_bounds[i],
                     key_range_end=(resolver_bounds[i + 1]
                                    if i + 1 < len(resolver_bounds)
                                    else None))
            for i, p in enumerate(self.resolver_procs)]
        self.tlogs = [TLog(p) for p in self.tlog_procs]

        # storage sharding: shard i served by storage i (tag = i); every tlog
        # holds every tag (replication = n_tlogs over the same data for now)
        self.shard_boundaries = _partition_boundaries(n_storage)
        shard_map = ShardMap(boundaries=self.shard_boundaries,
                             tags=[[i] for i in range(n_storage)])
        resolver_map = ResolverMap(
            boundaries=resolver_bounds,
            endpoints=resolver_eps)

        def shard_range(i):
            b = self.shard_boundaries
            return [(b[i], b[i + 1] if i + 1 < len(b) else None)]

        tlog_addrs = [p.address for p in self.tlog_procs]
        self.storages = [
            StorageServer(p, tag=i,
                          tlog_addrs=tlog_addrs[i % n_tlogs:] + tlog_addrs[:i % n_tlogs],
                          shard_ranges=shard_range(i))
            for i, p in enumerate(self.storage_procs)]

        # reboot wiring: a rebooted process re-runs its role on surviving
        # durable files (simulatedFDBDRebooter, SimulatedCluster.actor.cpp:198)
        for i, proc in enumerate(self.storage_procs):
            def boot_storage(p, i=i, n=n_tlogs):
                addrs = tlog_addrs[i % n:] + tlog_addrs[:i % n]
                self.storages[i] = StorageServer(p, tag=i, tlog_addrs=addrs,
                                                 shard_ranges=shard_range(i))
            proc.boot_fn = boot_storage
        for i, proc in enumerate(self.tlog_procs):
            def boot_tlog(p, i=i):
                t = TLog(p)
                t.recover_from_file()
                self.tlogs[i] = t
            proc.boot_fn = boot_tlog

        self.proxies = [
            Proxy(p, proxy_id=i, master=master_ep, resolvers=resolver_map,
                  tlogs=tlog_eps, shards=shard_map,
                  other_proxies=[a for a in self.proxy_addrs if a != p.address],
                  validation_scope=name_prefix, n_proxies=n_proxies)
            for i, p in enumerate(self.proxy_procs)]
        # GRV-only proxies confirm liveness against the COMMIT pool — their
        # own committed_version never advances
        self.grv_proxies = [
            Proxy(p, proxy_id=n_proxies + i, master=master_ep,
                  other_proxies=list(self.proxy_addrs),
                  validation_scope=name_prefix, grv_only=True)
            for i, p in enumerate(self.grv_proxy_procs)]

    # -- client handles --

    def database(self, name: str = "client:0") -> Database:
        name = self.name_prefix + name
        proc = self.net.processes.get(name) or self.net.new_process(name)
        cache = LocationCache(self.shard_boundaries,
                              [p.address for p in self.storage_procs])
        return Database(proc, self.proxy_addrs, locations=cache,
                        rng=self.rng.fork(),
                        grv_proxies=self.grv_proxy_addrs)

    # -- driving --

    def run(self, future, max_time: float = 1000.0):
        """Run the loop until `future` resolves (virtual time)."""
        return self.loop.run_future(future, max_time=max_time)

    def run_all(self, coros, max_time: float = 1000.0):
        tasks = [self.loop.spawn(c, name=f"test{i}") for i, c in enumerate(coros)]
        return self.run(all_of(tasks), max_time=max_time)
