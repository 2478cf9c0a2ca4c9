"""SimCluster: boot a whole database cluster inside the deterministic simulator.

Reference: fdbserver/SimulatedCluster.actor.cpp (setupSimulatedSystem :1239) —
the simulator runs the REAL role code on simulated processes; tests then drive
workloads against a Database handle and inject faults through the SimNetwork.

Topology: 1 master, P proxies, R resolvers (key-partitioned), L tlogs
(replicated; quorum = L - antiquorum), S storage servers (key-sharded, one
tag each). Roles are constructed directly, as in the JAX package's
server/cluster.py; the resolvers are the port's, so with
CONFLICT_BACKEND=device their conflict engines run on CONFLICT_DEVICE.
RecoverableCluster builds the same pipeline the real way (coordinators,
workers and an elected cluster controller that recruits the roles, the
port's resolvers among them, and recruits them anew after a failure).
"""

from __future__ import annotations

from foundationdb_tpu_torch.client.database import Database, LocationCache
from foundationdb_tpu_torch.core.eventloop import EventLoop
from foundationdb_tpu_torch.core.future import all_of
from foundationdb_tpu_torch.core.sim import Endpoint, SimNetwork, SimProcess
from foundationdb_tpu_torch.server.interfaces import Token
from foundationdb_tpu_torch.server.master import Master
from foundationdb_tpu_torch.server.proxy import Proxy, ResolverMap, ShardMap
from foundationdb_tpu_torch.server.resolver import Resolver
from foundationdb_tpu_torch.server.storage import StorageServer
from foundationdb_tpu_torch.server.tlog import TLog
from foundationdb_tpu_torch.utils.keys import (
    partition_boundaries as _partition_boundaries)
from foundationdb_tpu_torch.utils.knobs import KNOBS
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


class RecoverableCluster:
    """A cluster built the real way: coordinators + workers, with the
    transaction subsystem recruited by an ELECTED cluster controller and
    rebuilt from scratch on any role failure (SURVEY §3.3).

    Unlike SimCluster (direct construction, used by the steady-state tests),
    nothing here is wired by hand: workers register with the leader, the
    recovery state machine locks the old TLog generation, recruits a new one,
    writes the coordinated state, and rebinds storage servers.
    """

    def __init__(self, seed: int = 0, n_coordinators: int = 3,
                 n_workers: int = 5, n_proxies: int = 2, n_resolvers: int = 1,
                 n_tlogs: int = 2, n_storage: int = 2,
                 n_replicas: int | None = None,
                 n_storage_workers: int | None = None,
                 region_dcs: tuple | None = None,
                 satellite_dc: str | None = None, n_satellites: int = 0,
                 usable_regions: int = 1, n_log_routers: int = 1,
                 worker_dcs: list[str] | None = None,
                 storage_worker_dcs: list[str] | None = None,
                 coord_dcs: list[str] | None = None,
                 n_grv_proxies: int = 0):
        from foundationdb_tpu_torch.server.clustercontroller import (
            ClusterConfig, ClusterController)
        from foundationdb_tpu_torch.server.coordination import Coordinator, elect_leader
        from foundationdb_tpu_torch.server.worker import Worker

        if n_replicas is None:
            n_replicas = KNOBS.READ_REPLICAS
        self.loop = EventLoop()
        self.rng = DeterministicRandom(seed)
        self.net = SimNetwork(self.loop, self.rng.fork())
        self.config = ClusterConfig(n_proxies=n_proxies,
                                    n_grv_proxies=n_grv_proxies,
                                    n_resolvers=n_resolvers,
                                    n_tlogs=n_tlogs, n_storage=n_storage,
                                    n_replicas=n_replicas,
                                    region_dcs=region_dcs,
                                    satellite_dc=satellite_dc,
                                    n_satellites=n_satellites,
                                    usable_regions=usable_regions,
                                    n_log_routers=n_log_routers)
        if n_storage_workers is None:
            n_storage_workers = n_storage * n_replicas * max(
                1, usable_regions if region_dcs else 1)

        def dc_at(dcs, i):
            return dcs[i] if dcs and i < len(dcs) else "dc0"

        self.coord_procs = [self.net.new_process(f"coord:{i}",
                                                 dc_id=dc_at(coord_dcs, i))
                            for i in range(n_coordinators)]
        self.coordinators = [p.address for p in self.coord_procs]
        self.coords = [Coordinator(p) for p in self.coord_procs]
        for p in self.coord_procs:
            def boot_coord(proc):
                Coordinator(proc)
            p.boot_fn = boot_coord

        # process classes (fdbrpc/Locality.h ProcessClass): the disposable
        # transaction subsystem lives on stateless/tlog workers; storage
        # servers (the only roles with irreplaceable single-replica state
        # until replication lands) get dedicated workers, so killing a txn
        # role never destroys a shard
        self.worker_procs = [self.net.new_process(f"worker:{i}",
                                                  dc_id=dc_at(worker_dcs, i))
                             for i in range(n_workers)]
        self.storage_worker_procs = [
            self.net.new_process(f"storagew:{i}",
                                 dc_id=dc_at(storage_worker_dcs, i))
            for i in range(n_storage_workers)]

        def start_worker(proc: SimProcess, process_class: str = "unset"):
            proc.worker = Worker(proc, self.coordinators,
                                 ["stateless", "tlog"],
                                 process_class=process_class)

            async def cc_candidate():
                # tryBecomeLeader loop: whoever wins runs the CC/recovery
                # core until deposed, then campaigns again
                while True:
                    await elect_leader(proc, self.coordinators, priority=1)
                    cc = ClusterController(proc, self.coordinators, self.config)
                    proc.cluster_controller = cc
                    await cc.run()

            proc.spawn(cc_candidate(), "ccCandidate")

        def start_storage_worker(proc: SimProcess):
            proc.worker = Worker(proc, self.coordinators, ["storage"],
                                 process_class="storage")

        for p in self.worker_procs:
            p.boot_fn = start_worker
            start_worker(p)
        for p in self.storage_worker_procs:
            p.boot_fn = start_storage_worker
            start_storage_worker(p)

    @classmethod
    def two_region(cls, seed: int = 0, n_storage: int = 1,
                   n_replicas: int = 1, **kw) -> "RecoverableCluster":
        """The canonical dual-region layout (the reference's region config,
        configuration.rst "Configuring regions"): dc0 = primary (txn
        subsystem + storage replicas), sat0 = satellite log (synchronously
        in every commit quorum, so a whole-dc0 loss loses no acked commit),
        dc1 = standby region (full storage replica set fed through log
        routers, failover target). Coordinators 1/1/1 so losing any one
        region keeps a majority."""
        nsw = n_storage * n_replicas
        return cls(
            seed=seed, n_coordinators=3,
            coord_dcs=["dc0", "sat0", "dc1"],
            n_workers=6,
            worker_dcs=["dc0", "dc0", "dc0", "sat0", "dc1", "dc1"],
            n_proxies=1, n_resolvers=1, n_tlogs=1,
            n_storage=n_storage, n_replicas=n_replicas,
            n_storage_workers=2 * nsw,
            storage_worker_dcs=["dc0"] * nsw + ["dc1"] * nsw,
            region_dcs=("dc0", "dc1"), satellite_dc="sat0", n_satellites=1,
            usable_regions=2, n_log_routers=1, **kw)

    def kill_dc(self, dc_id: str):
        """Region loss: kill every process whose locality is in `dc_id`."""
        for p in list(self.net.processes.values()):
            if p.dc_id == dc_id and p.alive:
                self.net.kill(p.address)

    def cluster_procs(self) -> list[SimProcess]:
        """Every process that IS the cluster (coordinators + workers +
        storage workers) — excludes client processes living on the same
        simulated network."""
        return self.coord_procs + self.worker_procs + self.storage_worker_procs

    def restart_from_disk(self):
        """Whole-cluster restart (tests/restarting/*.txt): every cluster
        process dies at once; each reboots onto its surviving durable files
        and the cluster must re-elect, re-recover, and serve the same data.
        Unsynced tails are (deterministically-randomly) torn, exactly like a
        power loss."""
        from foundationdb_tpu_torch.core.sim import KillType
        for p in self.cluster_procs():
            if p.alive:
                self.net.kill(p.address, KillType.RebootProcess)

    def database(self, name: str = "client:0") -> Database:
        proc = self.net.processes.get(name) or self.net.new_process(name)
        return Database(proc, coordinators=self.coordinators,
                        rng=self.rng.fork())

    def add_worker(self, address: str, capabilities: list[str],
                   process_class: str = "unset"):
        """Join a new worker mid-run (tests of elasticity/preemption)."""
        from foundationdb_tpu_torch.server.worker import Worker
        proc = self.net.new_process(address)

        def boot(p, caps=list(capabilities), cls=process_class):
            p.worker = Worker(p, self.coordinators, caps, process_class=cls)
        proc.boot_fn = boot
        boot(proc)
        return proc

    def run(self, future, max_time: float = 1000.0):
        return self.loop.run_future(future, max_time=max_time)

    def run_all(self, coros, max_time: float = 1000.0):
        from foundationdb_tpu_torch.core.future import all_of
        tasks = [self.loop.spawn(c, name=f"test{i}") for i, c in enumerate(coros)]
        return self.run(all_of(tasks), max_time=max_time)

    # -- introspection for tests --

    def current_cc(self):
        for p in self.worker_procs:
            cc = getattr(p, "cluster_controller", None)
            if cc is not None and p.alive and not cc.deposed \
                    and cc.dbinfo.recovery_state == "accepting_commits":
                return cc
        return None
