"""ClusterController: elected leader that drives master recovery.

Reference: fdbserver/ClusterController.actor.cpp (worker registry, recruitment
:383, ServerDBInfo broadcast) + fdbserver/masterserver.actor.cpp (masterCore
:1160, recoverFrom :759) + fdbserver/TagPartitionedLogSystem.actor.cpp
(epochEnd :398-417). The reference splits the recovery core into a recruited
master role babysat by the CC; here the CC runs the recovery state machine
itself and recruits the *version-allocator* master as a worker role — the
fitness/preemption machinery (betterMasterExists :799) is not modeled yet.

Recovery states (RecoveryState.h:30):
  READING_CSTATE  — quorum-read the coordinated state (prior log system)
  LOCKING_CSTATE  — lock the old TLog generation; compute the recovery version
  RECRUITING      — instantiate a whole new transaction subsystem on workers
  WRITING_CSTATE  — publish the new log-system config through the coordinators
  ACCEPTING_COMMITS — broadcast DBInfo + SetLogSystem; monitor for failure

The transaction subsystem is disposable: ANY master/proxy/resolver/TLog
failure triggers a fresh recovery with a new epoch; storage servers survive
across epochs and roll back to the recovery version (storageserver rollback
:2211 via SetLogSystemRequest).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from foundationdb_tpu_torch.core.future import Future, settle_failed
from foundationdb_tpu_torch.core.sim import Endpoint, SimProcess
from foundationdb_tpu_torch.server.coordination import (
    CandidacyRequest, CoordinatedStateClient, CoordToken, quorum_wait)
from foundationdb_tpu_torch.server.interfaces import (
    AddShardRequest, DBInfo, GetStorageMetricsRequest, InitRoleRequest,
    LogEpoch, RegisterWorkerRequest, SetLogSystemRequest, SetShardsRequest,
    TLogLockRequest, Token)
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.types import Mutation, MutationType
from foundationdb_tpu_torch.utils.keys import partition_boundaries as _partition_boundaries
from foundationdb_tpu_torch.utils.knobs import KNOBS
from foundationdb_tpu_torch.utils.stats import CounterCollection, trace_counters_loop
from foundationdb_tpu_torch.utils.trace import TraceEvent


@dataclass
class ClusterConfig:
    n_proxies: int = 1
    # dedicated GRV proxies (grv_proxy/commit_proxy split): 0 keeps the
    # combined shape where commit proxies also serve read versions
    n_grv_proxies: int = 0
    n_resolvers: int = 1
    n_tlogs: int = 1
    n_storage: int = 1  # number of SHARDS
    n_replicas: int = 1  # storage team size per shard (replication factor)
    # -- two-region (the reference's region configuration,
    # DatabaseConfiguration.h regions + TagPartitionedLogSystem satellite
    # log sets + LogRouter.actor.cpp) --
    # region_dcs: dc ids in failover-priority order; recovery recruits the
    # txn subsystem in the first listed dc with enough live workers, so
    # killing the whole primary region fails over to the next.
    region_dcs: tuple | None = None
    satellite_dc: str | None = None  # hosts the synchronous satellite logs
    n_satellites: int = 0
    # usable_regions=2: the standby region keeps full storage replicas fed
    # asynchronously through log routers (its tags still route through the
    # primary log system; the routers pull each tag across the WAN once)
    usable_regions: int = 1
    n_log_routers: int = 1


# ProcessClass fitness per role (fdbrpc/Locality.h ProcessClass::machineClassFitness,
# used by getWorkerForRoleInDatacenter ClusterController.actor.cpp:383): lower
# is better; recruitment picks the best-ranked alive workers.
_FITNESS = {
    # role kind -> {process_class: rank}
    "stateless": {"stateless": 0, "unset": 1, "transaction": 2, "storage": 3},
    "tlog": {"transaction": 0, "unset": 1, "stateless": 2, "storage": 3},
    "storage": {"storage": 0, "unset": 1, "transaction": 2, "stateless": 2},
}


def role_fitness(kind: str, process_class: str) -> int:
    return _FITNESS[kind].get(process_class, 1)


@dataclass
class _Registry:
    """Known workers: address -> (capabilities, process_class, last_seen),
    plus each worker's LocalityData for policy-driven placement."""

    workers: dict = field(default_factory=dict)
    localities: dict = field(default_factory=dict)

    def register(self, req: RegisterWorkerRequest, now: float):
        from foundationdb_tpu_torch.server.replication import LocalityData
        self.workers[req.address] = (
            list(req.roles), getattr(req, "process_class", "unset"), now)
        self.localities[req.address] = LocalityData(
            process_id=req.address,
            zone_id=getattr(req, "zone_id", "") or req.address,
            machine_id=getattr(req, "machine_id", "") or req.address,
            dc_id=getattr(req, "dc_id", ""))

    def alive(self, capability: str, now: float, max_age: float = 3.0) -> list[str]:
        """Alive workers with `capability`, best-fitness first (ties by
        address for determinism) — recruitment takes from the front."""
        fit = _FITNESS.get(capability, _FITNESS["stateless"])
        return sorted(
            (a for a, (caps, _cls, seen) in self.workers.items()
             if capability in caps and now - seen <= max_age),
            key=lambda a: (fit.get(self.workers[a][1], 1), a))

    def class_of(self, address: str) -> str:
        entry = self.workers.get(address)
        return entry[1] if entry else "unset"

    def locality_of(self, address: str):
        from foundationdb_tpu_torch.server.replication import LocalityData
        return self.localities.get(
            address, LocalityData(process_id=address, zone_id=address,
                                  machine_id=address))


class ClusterController:
    def __init__(self, process: SimProcess, coordinators: list[str],
                 config: ClusterConfig):
        self.process = process
        self.net = process.net
        self.loop = process.net.loop
        self.coordinators = coordinators
        self.config = config
        self.registry = _Registry()
        self.cstate = CoordinatedStateClient(process, coordinators)
        self.dbinfo = DBInfo(version=0, epoch=0, master=None, proxies=[],
                             resolvers=[], log_epochs=[], storages=[],
                             shard_boundaries=[], recovery_state="unrecovered")
        self.deposed = False
        self._need_recovery = Future()
        self._watchers: list = []
        self._incarnations: dict[str, int] = {}
        self._attempt = 0
        self.counters = CounterCollection("ClusterController",
                                          str(process.address))
        self._c_registrations = self.counters.counter("WorkerRegistrations")
        self._c_recoveries = self.counters.counter("RecoveriesCompleted")
        self._c_status_reqs = self.counters.counter("StatusRequests")
        self._counters_task = trace_counters_loop(process, self.counters)
        process.register(Token.CC_REGISTER_WORKER, self._on_register)
        process.register(Token.CC_GET_DBINFO, self._on_get_dbinfo)
        process.register(Token.CC_GET_STATUS, self._on_get_status)

    def _on_register(self, req: RegisterWorkerRequest, reply):
        self._c_registrations.increment()
        self.registry.register(req, self.loop.now())
        reply.send(None)
        # stand-down: a storage worker that hosts no referenced tag (healed
        # away while it was partitioned/clogged — never actually dead) must
        # stop serving its stale ranges, or clients with stale layouts would
        # read data missing every post-heal write. Delivered on the worker's
        # own heartbeat, so it reaches exactly the ones that came back.
        info = self.dbinfo
        if ("storage" in req.roles
                and info.recovery_state == "accepting_commits"
                and getattr(self, "_initial_meta_done", False)
                and req.address not in {a for a, _t in info.storages}):
            self.net.one_way(self.process,
                             Endpoint(req.address, Token.STORAGE_SET_SHARDS),
                             SetShardsRequest(shard_ranges=[],
                                              layout_version=(info.epoch,
                                                              info.version)))

    def _on_get_dbinfo(self, req, reply):
        reply.send(self.dbinfo)

    def _on_get_status(self, req, reply):
        self.process.spawn(self._get_status(reply), "clusterGetStatus")

    def _metrics_targets(self, info) -> list[tuple[str, str, int]]:
        """(role, address, metrics token) for every live role in the
        published generation — the workerEventsFetcher fan-out set."""
        targets: list[tuple[str, str, int]] = []
        if info.master:
            targets.append(("master", info.master, Token.MASTER_METRICS))
        for a in info.proxies:
            targets.append(("proxy", a, Token.PROXY_METRICS))
        for a in info.grv_proxies:
            targets.append(("grv_proxy", a, Token.PROXY_METRICS))
        for a in info.resolvers:
            targets.append(("resolver", a, Token.RESOLVER_METRICS))
        last_ep = info.log_epochs[-1] if info.log_epochs else None
        for a in (last_ep.addrs if last_ep else []):
            targets.append(("log", a, Token.TLOG_METRICS))
        for a in sorted({a for a, _t in info.storages}):
            targets.append(("storage", a, Token.STORAGE_METRICS))
        if info.ratekeeper:
            targets.append(("ratekeeper", info.ratekeeper, Token.RK_METRICS))
        return targets

    async def _fetch_metrics(self, addr: str, token: int):
        """One role's counter snapshot; None when the role is unreachable
        (a dead role must not wedge the whole status request)."""
        try:
            return await self.loop.timeout(self.net.request(
                self.process, Endpoint(addr, token), None), 1.0)
        except FDBError as e:
            if e.name == "operation_cancelled":
                raise
            return None

    async def _get_status(self, reply):
        """Status JSON assembled by the CC from every role
        (fdbserver/Status.actor.cpp:1698 clusterGetStatus, schema shape from
        fdbclient/Schemas.cpp — trimmed to what this cluster models)."""
        self._c_status_reqs.increment()
        info = self.dbinfo
        now = self.loop.now()
        status = {
            "cluster": {
                "recovery_state": {"name": info.recovery_state,
                                   "epoch": info.epoch},
                "generation": info.epoch,
                "cluster_controller": self.process.address,
                "coordinators": list(self.coordinators),
                "workers": {
                    a: {"roles": caps, "class": cls,
                        "stale_seconds": round(now - seen, 2)}
                    for a, (caps, cls, seen)
                    in sorted(self.registry.workers.items())
                },
                "layers": {"master": info.master,
                           "proxies": list(info.proxies),
                           "grv_proxies": list(info.grv_proxies),
                           "resolvers": list(info.resolvers),
                           "ratekeeper": info.ratekeeper,
                           "logs": [{"epoch": ep.epoch, "begin": ep.begin,
                                     "end": ep.end, "addrs": list(ep.addrs)}
                                    for ep in info.log_epochs],
                           "storages": [{"address": a, "tag": t}
                                        for a, t in info.storages]},
                "data": {"shard_boundaries": [b.hex() for b in
                                              info.shard_boundaries],
                         "shard_teams": info.shard_tags},
            },
        }
        # roles: per-role counter snapshots, fetched CONCURRENTLY — a
        # sequential sweep with 1s timeouts would make status O(roles)
        # seconds exactly when parts of the cluster are dead
        targets = self._metrics_targets(info)
        futs = [self.loop.spawn(self._fetch_metrics(a, tok), "statusMetrics")
                for _role, a, tok in targets]
        roles = [{"role": "cluster_controller",
                  "address": self.process.address,
                  "counters": self.counters.as_dict()}]
        try:
            for (role, addr, _tok), f in zip(targets, futs):
                snap = await f
                entry = {"role": role, "address": addr}
                if snap is None:
                    entry["unreachable"] = True
                else:
                    entry["counters"] = dict(snap)
                roles.append(entry)
        except FDBError as e:
            # CC displaced (or a fetch died) mid-status: settle before
            # propagating, or the status client waits out the full RPC
            # timeout (protolint PROTO002)
            for f in futs:
                f.cancel()
            settle_failed(reply, e)
            raise
        status["cluster"]["roles"] = roles
        # workload: cluster-wide commit traffic summed over the proxy fleet
        # (Status's workload.transactions/bytes section)
        workload = {"transactions_started": 0, "transactions_committed": 0,
                    "transactions_conflicted": 0, "commit_batches": 0,
                    "mutation_bytes": 0}
        for entry in roles:
            if (entry["role"] not in ("proxy", "grv_proxy")
                    or "counters" not in entry):
                continue
            c = entry["counters"]
            workload["transactions_started"] += c.get("GRVIn", 0)
            workload["transactions_committed"] += c.get("TxnCommitted", 0)
            workload["transactions_conflicted"] += c.get("TxnConflicts", 0)
            workload["commit_batches"] += c.get("CommitBatches", 0)
            workload["mutation_bytes"] += c.get("MutationBytes", 0)
        status["cluster"]["workload"] = workload
        # qos: live ratekeeper view (Status's qos section)
        if info.ratekeeper:
            try:
                r = await self.loop.timeout(self.net.request(
                    self.process, Endpoint(info.ratekeeper, Token.RK_GET_RATE),
                    1), 1.0)
                status["cluster"]["qos"] = {
                    "transactions_per_second_limit": round(r.tps, 1)}
            except FDBError as e:
                if e.name == "operation_cancelled":
                    settle_failed(reply, e)
                    raise
                status["cluster"]["qos"] = {"unreachable": True}
        reply.send(status)

    # -- leadership maintenance (tryBecomeLeader's nominee refresh) --

    async def _hold_leadership(self):
        quorum = len(self.coordinators) // 2 + 1
        while True:
            votes = 0
            for addr in self.coordinators:
                try:
                    r = await self.loop.timeout(self.net.request(
                        self.process, Endpoint(addr, CoordToken.CANDIDACY),
                        CandidacyRequest(address=self.process.address,
                                         priority=1)), 1.0)
                    if r.leader == self.process.address:
                        votes += 1
                except FDBError as e:
                    if e.name == "operation_cancelled":
                        raise
            if votes < quorum:
                self.deposed = True
                if not self._need_recovery.is_ready():
                    self._need_recovery._set("deposed")
                return
            await self.loop.delay(1.0)

    # -- role failure detection (waitFailureClient analogue) --

    async def _watch_role(self, address: str, what: str, incarnation: int):
        """A role is dead when its worker stops answering OR answers with a
        newer incarnation (the worker rebooted: the process is back but the
        roles recruited on it died with the old incarnation)."""
        misses = 0
        while True:
            try:
                inc = await self.loop.timeout(self.net.request(
                    self.process, Endpoint(address, Token.WORKER_PING), None),
                    1.0)
                if inc != incarnation:
                    misses = 2
                else:
                    misses = 0
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise
                misses += 1
            if misses >= 2:
                TraceEvent("CCRoleFailed", self.process.address) \
                    .detail("Role", what).detail("Address", address).log()
                if not self._need_recovery.is_ready():
                    self._need_recovery._set(f"{what}@{address}")
                return
            await self.loop.delay(0.5)

    async def _watch_epoch_role(self, address: str, token: int, epoch: int,
                                what: str):
        """Worker pings can't see a ROLE stomped by a competing recovery
        attempt on the same worker (the process never rebooted), a master
        that self-deposed, or a proxy that died because its commit pipeline
        kept failing — watch the role's own epoch-answering endpoint."""
        misses = 0
        while True:
            try:
                got = await self.loop.timeout(self.net.request(
                    self.process, Endpoint(address, token), None), 1.0)
                misses = 0 if got == epoch else 2
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise
                misses += 1
            if misses >= 2:
                TraceEvent("CCEpochRoleFailed", self.process.address) \
                    .detail("What", what).detail("Address", address) \
                    .detail("Epoch", epoch).log()
                if not self._need_recovery.is_ready():
                    self._need_recovery._set(f"{what}@{address}")
                return
            await self.loop.delay(0.5)

    # -- the recovery state machine --

    async def run(self):
        """Drive recoveries until deposed (clusterControllerCore)."""
        hold = self.process.spawn(self._hold_leadership(), "holdLeadership")
        try:
            while not self.deposed:
                try:
                    await self._recover_once()
                except FDBError as e:
                    if e.name == "operation_cancelled":
                        raise
                    TraceEvent("CCRecoveryFailed", self.process.address) \
                        .detail("Error", e.name).detail("Detail", e.detail).log()
                    await self.loop.delay(0.5)
                    continue
                # recovered: wait for a role failure or deposition
                reason = await self._need_recovery
                self._need_recovery = Future()
                TraceEvent("CCRecoveryTriggered", self.process.address) \
                    .detail("Reason", str(reason)).log()
        finally:
            hold.cancel()
            for w in self._watchers:  # a deposed CC stops babysitting
                w.cancel()
            self._watchers = []

    async def _recover_once(self):
        cfg = self.config
        # stop babysitting the generation being replaced (a locked old TLog
        # dying later must not trigger a spurious recovery)
        for w in self._watchers:
            w.cancel()
        self._watchers = []
        self._incarnations: dict[str, int] = {}
        # ---- READING_CSTATE ----
        self.dbinfo.recovery_state = "reading_cstate"
        prior, _gen = await self.cstate.read()

        # ---- LOCKING_CSTATE: epoch end over the old generation ----
        self.dbinfo.recovery_state = "locking_cstate"
        if prior is None:
            epoch = 1
            recovery_version = 0
            old_epochs: list[LogEpoch] = []
            storages: list[tuple[str, int]] = []
            boundaries = _partition_boundaries(cfg.n_storage)
        else:
            epoch = prior["epoch"] + 1
            old_epochs = list(prior["log_epochs"])
            storages = list(prior["storages"])
            boundaries = list(prior["shard_boundaries"])
            # configure-commanded txn-subsystem shape (ManagementAPI):
            # recruit the new generation with the configured counts
            cc_conf = prior.get("conf") or {}
            from dataclasses import replace as _dc_replace
            cfg = _dc_replace(cfg, **{
                k: int(v) for k, v in cc_conf.items()
                if k in ("n_proxies", "n_grv_proxies", "n_resolvers",
                         "n_tlogs", "n_replicas")})
            recovery_version = await self._lock_old_generation(old_epochs[-1])
            # close the old generation at the recovery version
            old_epochs[-1] = LogEpoch(begin=old_epochs[-1].begin,
                                      end=recovery_version,
                                      addrs=old_epochs[-1].addrs,
                                      epoch=old_epochs[-1].epoch,
                                      uids=old_epochs[-1].uids)

        # the new generation starts above anything any process can have seen
        # in flight (masterserver.actor.cpp:858 bump)
        start_version = recovery_version + KNOBS.MAX_VERSIONS_IN_FLIGHT

        # ---- RECRUITING ----
        self.dbinfo.recovery_state = "recruiting"
        now = self.loop.now()
        # excluded servers (ManagementAPI) never receive new roles; the
        # exclusion list is mirrored into the cstate since the database is
        # unreadable during recovery
        excluded = set(((prior or {}).get("conf") or {}).get("excluded") or [])
        stateless_all = [a for a in self.registry.alive("stateless", now)
                         if a not in excluded]
        log_workers_all = [a for a in self.registry.alive("tlog", now)
                           if a not in excluded]

        def dc_of(a: str) -> str:
            return self.registry.locality_of(a).dc_id

        # region selection: the first dc in priority order with enough live
        # workers hosts the txn subsystem — so a dead primary REGION makes
        # recovery recruit in the next region (the failover path the
        # reference drives through its region priority config)
        primary_dc = None
        if cfg.region_dcs:
            for dc in cfg.region_dcs:
                sl = [a for a in stateless_all if dc_of(a) == dc]
                lw = [a for a in log_workers_all if dc_of(a) == dc]
                if (len(sl) >= max(1, cfg.n_proxies + cfg.n_grv_proxies,
                                   cfg.n_resolvers)
                        and len(lw) >= cfg.n_tlogs):
                    primary_dc = dc
                    stateless, log_workers = sl, lw
                    break
            if primary_dc is None:
                raise FDBError("recruitment_failed",
                               "no region has enough workers")
        else:
            stateless, log_workers = stateless_all, log_workers_all
        # one resolver/proxy per worker: co-locating two same-keyed roles on
        # one process would silently displace the first (single endpoint
        # token per role kind per process). GRV proxies count against the
        # same stateless pool — they own the GRV token a co-located commit
        # proxy would also register.
        if (len(stateless) < max(1, cfg.n_proxies + cfg.n_grv_proxies,
                                 cfg.n_resolvers)
                or len(log_workers) < cfg.n_tlogs):
            raise FDBError("recruitment_failed", "not enough workers")

        # new TLog generation: fresh instances with UNIQUE ids (and uid-named
        # files), so neither an old locked generation nor a racing recovery
        # attempt can ever be stomped on a shared host
        self._attempt += 1
        uids = [f"e{epoch}-{self.process.address}-a{self._attempt}-t{i}"
                for i in range(cfg.n_tlogs)]
        tlog_addrs = await self._recruit_many(
            log_workers, cfg.n_tlogs, "tlog",
            lambda i: {"uid": uids[i], "recovery_version": start_version})
        # satellite log set: synchronously quorumed OUTSIDE the primary dc
        # (TagPartitionedLogSystem satellite tLogs), so losing the whole
        # primary region loses no acked commit. Folded into the epoch's
        # addr list after the n_primary split: peeks/pops/locks treat every
        # member uniformly, only the proxy's push quorum is per set.
        sat_addrs: list[str] = []
        sat_uids: list[str] = []
        if cfg.region_dcs and cfg.n_satellites:
            if KNOBS.TLOG_QUORUM_ANTIQUORUM:
                raise FDBError("recruitment_failed",
                               "satellite logs require antiquorum 0")
            sat_workers = [a for a in log_workers_all
                           if dc_of(a) == cfg.satellite_dc]
            if len(sat_workers) < cfg.n_satellites:
                raise FDBError("recruitment_failed",
                               "not enough satellite log workers")
            sat_uids = [f"e{epoch}-{self.process.address}"
                        f"-a{self._attempt}-s{i}"
                        for i in range(cfg.n_satellites)]
            sat_addrs = await self._recruit_many(
                sat_workers, cfg.n_satellites, "tlog",
                lambda i: {"uid": sat_uids[i],
                           "recovery_version": start_version})
        new_epochs = old_epochs + [LogEpoch(begin=recovery_version, end=None,
                                            addrs=tlog_addrs + sat_addrs,
                                            epoch=epoch,
                                            uids=uids + sat_uids,
                                            n_primary=len(tlog_addrs))]

        # each resolver is told its slice of the outer key split so a
        # sharded conflict engine can cut the mesh INSIDE its range
        resolver_bounds = _partition_boundaries(cfg.n_resolvers)
        resolver_addrs = await self._recruit_many(
            stateless, cfg.n_resolvers, "resolver",
            lambda i: {"recovery_version": start_version,
                       "n_proxies": cfg.n_proxies,
                       "key_range_begin": resolver_bounds[i],
                       "key_range_end": (resolver_bounds[i + 1]
                                         if i + 1 < len(resolver_bounds)
                                         else None)})
        master_addr = (await self._recruit_many(
            stateless, 1, "master",
            lambda i: {"recovery_version": start_version, "epoch": epoch,
                       "coordinators": list(self.coordinators)}))[0]

        remote_dc = None
        if cfg.region_dcs and cfg.usable_regions >= 2:
            remotes = [d for d in cfg.region_dcs if d != primary_dc]
            remote_dc = remotes[0] if remotes else None
        if prior is None:
            storage_workers = [a for a in self.registry.alive("storage", now)
                               if a not in excluded]
            if primary_dc is not None:
                storage_workers = [a for a in storage_workers
                                   if dc_of(a) == primary_dc]
            # one storage role per worker (a process has one set of STORAGE_*
            # endpoints, so co-located roles would displace each other —
            # also the reference's normal deployment shape)
            if len(storage_workers) < cfg.n_storage * cfg.n_replicas:
                raise FDBError("recruitment_failed", "not enough storage workers")
            # teams (DDTeamCollection :515): every shard gets n_replicas
            # storage servers on DISTINCT workers, each with its OWN tag; the
            # proxy routes each mutation to every team member's tag, so
            # replication happens through the log, not server-to-server.
            # Placement honors the replication POLICY (ReplicationPolicy.h:
            # Across(n, zoneid) for double/triple) when worker localities
            # allow; otherwise it degrades to distinct workers with a trace.
            from foundationdb_tpu_torch.server.replication import (
                policy_for_replication, select_replicas)
            policy = policy_for_replication(cfg.n_replicas)
            storages = []
            shard_tags: list[list[int]] = []
            # each worker hosts at most ONE storage role (a process has one
            # set of STORAGE_* endpoint tokens), so picked workers leave the
            # pool; the count guard above ensures it never runs dry
            pool = list(storage_workers)
            for i in range(cfg.n_storage):
                srange = (boundaries[i],
                          boundaries[i + 1] if i + 1 < len(boundaries) else None)
                # balance zone consumption across shards: offer candidates
                # from the zones with the MOST remaining workers first
                # (stable, so fitness order survives within a zone) — a
                # plain greedy strands small zones and forces later shards
                # into same-zone teams that a global assignment avoids
                zone_left: dict[str, int] = {}
                for a in pool:
                    z = self.registry.locality_of(a).zone_id
                    zone_left[z] = zone_left.get(z, 0) + 1
                ordered = sorted(
                    pool, key=lambda a: -zone_left[
                        self.registry.locality_of(a).zone_id])
                cands = [(a, self.registry.locality_of(a)) for a in ordered]
                picked = select_replicas(policy, cands)
                if picked is None or len(picked) < cfg.n_replicas:
                    TraceEvent("CCPolicyUnsatisfiable", self.process.address,
                               severity=30) \
                        .detail("Policy", str(policy)).detail("Shard", i).log()
                    picked = ordered[:cfg.n_replicas]
                team = []
                for r, w in enumerate(picked[:cfg.n_replicas]):
                    tag = i * cfg.n_replicas + r
                    addr = (await self._recruit_many(
                        [w], 1, "storage",
                        lambda _i, tag=tag, srange=srange: {
                            "tag": tag, "log_epochs": list(new_epochs),
                            "recovery_count": epoch,
                            "shard_ranges": [srange],
                            "engine": ((prior or {}).get("conf") or {})
                            .get("storage_engine")}))[0]
                    storages.append((addr, tag))
                    team.append(tag)
                pool = [a for a in pool if a not in picked]
                shard_tags.append(team)
            router_of: dict[int, tuple[str, str]] = {}
            if remote_dc is not None:
                # remote-region replica set (usable_regions=2): every shard
                # gets n_replicas more storages in the standby region with
                # their OWN tags — mutations route to those tags through
                # the primary log system, and the region's log routers pull
                # each tag across the WAN once to feed them
                remote_pool = [a for a in self.registry.alive("storage", now)
                               if a not in excluded and dc_of(a) == remote_dc]
                if len(remote_pool) < cfg.n_storage * cfg.n_replicas:
                    raise FDBError("recruitment_failed",
                                   "not enough remote-region storage workers")
                base = cfg.n_storage * cfg.n_replicas
                remote_tags_all = [base + i * cfg.n_replicas + r
                                   for i in range(cfg.n_storage)
                                   for r in range(cfg.n_replicas)]
                router_of = await self._recruit_log_routers(
                    remote_dc, remote_tags_all, new_epochs,
                    recovery_version, epoch, excluded, now)
                rp = list(remote_pool)
                for i in range(cfg.n_storage):
                    srange = (boundaries[i],
                              boundaries[i + 1] if i + 1 < len(boundaries)
                              else None)
                    for r in range(cfg.n_replicas):
                        tag = base + i * cfg.n_replicas + r
                        w = rp.pop(0)
                        ep_view = self._router_epochs(new_epochs, router_of,
                                                      tag)
                        addr = (await self._recruit_many(
                            [w], 1, "storage",
                            lambda _i, tag=tag, srange=srange,
                            ep_view=ep_view: {
                                "tag": tag, "log_epochs": ep_view,
                                "recovery_count": epoch,
                                "shard_ranges": [srange]}))[0]
                        storages.append((addr, tag))
                        shard_tags[i].append(tag)
        else:
            shard_tags = list(prior.get("shard_tags")
                              or [[t] for _a, t in storages])
            # refresh the standby region's log routers for the new
            # generation (they pull the NEW epoch list); best effort — with
            # the remote region's workers gone (or after a failover into
            # it) its storages just bind the primary view directly
            router_of = {}
            if remote_dc is not None:
                remote_tags_all = sorted(
                    t for a, t in storages if dc_of(a) == remote_dc)
                if remote_tags_all:
                    try:
                        router_of = await self._recruit_log_routers(
                            remote_dc, remote_tags_all, new_epochs,
                            recovery_version, epoch, excluded, now)
                    except FDBError as e:
                        if e.name == "operation_cancelled":
                            raise
                        router_of = {}

        # admission control alongside the new generation (Ratekeeper runs
        # with the master in the reference)
        rk_addr = (await self._recruit_many(
            stateless, 1, "ratekeeper",
            lambda i: {"tlogs": list(tlog_addrs),
                       "storages": [a for a, _t in storages],
                       "resolvers": list(resolver_addrs)}))[0]

        from foundationdb_tpu_torch.server import systemdata
        from foundationdb_tpu_torch.server.proxy import ResolverMap
        # seed every proxy's txnStateStore with the \xff snapshot derived
        # from the coordinated checkpoint (the recovery transaction /
        # sendInitialCommitToResolvers analogue, masterserver.actor.cpp:690)
        system_snapshot = systemdata.build_keyservers_snapshot(
            boundaries, shard_tags)
        resolver_map = ResolverMap(
            boundaries=resolver_bounds,
            endpoints=[Endpoint(a, Token.RESOLVER_RESOLVE)
                       for a in resolver_addrs])
        # worker address == role address, so the cross-proxy GRV confirmation
        # set (getLiveCommittedVersion :935) is known before recruitment
        proxy_addrs = [stateless[i % len(stateless)]
                       for i in range(cfg.n_proxies)]
        for i in range(cfg.n_proxies):
            await self._recruit_many(
                [proxy_addrs[i]], 1, "proxy",
                lambda _i, i=i: {
                    "proxy_id": i,
                    "master": Endpoint(master_addr, Token.MASTER_GET_COMMIT_VERSION),
                    "resolvers": resolver_map,
                    "tlogs": [Endpoint(a, Token.TLOG_COMMIT) for a in tlog_addrs],
                    "tlog_uids": list(uids),
                    "satellites": [Endpoint(a, Token.TLOG_COMMIT)
                                   for a in sat_addrs],
                    "satellite_uids": list(sat_uids),
                    "system_snapshot": list(system_snapshot),
                    "storages": list(storages),
                    "recovery_version": start_version,
                    "epoch": epoch,
                    "other_proxies": [a for a in proxy_addrs
                                      if a != proxy_addrs[i]],
                    "ratekeeper": rk_addr,
                    "n_proxies": cfg.n_proxies,
                    "die_on_failure": True,
                })
        # dedicated GRV proxies on workers AFTER the commit proxies (they
        # register the same GRV/ping/metrics tokens, so sharing a worker
        # with a commit proxy would displace its handlers). They confirm
        # read versions against the COMMIT proxies' committed versions and
        # report their own pool size to the ratekeeper, so the GRV budget
        # divides over the pool actually serving GRVs.
        grv_addrs = [stateless[(cfg.n_proxies + i) % len(stateless)]
                     for i in range(cfg.n_grv_proxies)]
        for i in range(cfg.n_grv_proxies):
            await self._recruit_many(
                [grv_addrs[i]], 1, "grv_proxy",
                lambda _i, i=i: {
                    "proxy_id": cfg.n_proxies + i,
                    "master": Endpoint(master_addr,
                                       Token.MASTER_GET_COMMIT_VERSION),
                    "recovery_version": start_version,
                    "epoch": epoch,
                    "other_proxies": list(proxy_addrs),
                    "ratekeeper": rk_addr,
                    "n_proxies": max(1, cfg.n_grv_proxies),
                    "die_on_failure": True,
                })

        # ---- WRITING_CSTATE: fencing point for competing recoveries ----
        self.dbinfo.recovery_state = "writing_cstate"
        await self.cstate.write({
            "epoch": epoch,
            "master": master_addr,
            "log_epochs": new_epochs,
            "storages": storages,
            "shard_tags": shard_tags,
            "shard_boundaries": boundaries,
            "recovery_version": recovery_version,
            # configure-commanded overrides survive further recoveries
            "conf": (prior.get("conf") if prior else None) or {},
        })
        self._cstate_conf = (prior.get("conf") if prior else None) or {}

        # ---- ACCEPTING_COMMITS: rebind storages, publish DBInfo ----
        for addr, tag in storages:
            # standby-region storages bind the open generation via their
            # tag's log router; everyone else binds the primary view
            eps = self._router_epochs(new_epochs, router_of, tag)
            self.net.one_way(self.process,
                             Endpoint(addr, Token.STORAGE_SET_LOGSYSTEM),
                             SetLogSystemRequest(epochs=eps,
                                                 rollback_to=recovery_version,
                                                 recovery_count=epoch))
        if prior is not None:
            # fence the old generation's read versions before clients can see
            # (and commit through) the new one. Fast path: depose the old
            # master directly. Backstop for partitions: the old master's own
            # cstate lease fails within MASTER_CSTATE_LEASE once the cstate
            # has moved (or its coordinator quorum is gone), and its proxies'
            # GRV leases drain within PROXY_MASTER_LEASE after that — so wait
            # out both before publishing DBInfo (the reference gets this from
            # the old master's cstate writes failing + proxy failure
            # monitoring; strict serializability needs no old-generation GRV
            # after the first new-generation commit).
            old_master = prior.get("master")
            if old_master:
                self.net.one_way(self.process,
                                 Endpoint(old_master, Token.MASTER_DEPOSE),
                                 epoch)
            await self.loop.delay(1.5 * KNOBS.MASTER_CSTATE_LEASE_SECONDS
                                  + KNOBS.PROXY_MASTER_LEASE_SECONDS)
        # wire the DD's client to the new generation (DBInfo publishes just
        # below; the background recovery txn and DD both use this handle)
        self._initial_meta_done = False
        addr_of_tag = {tag: addr for addr, tag in storages}
        pre_db = self._dd_database()
        pre_db.proxies = list(proxy_addrs)
        pre_db.locations.update(
            boundaries, [[addr_of_tag[t] for t in team]
                         for team in shard_tags])
        self.dbinfo = DBInfo(
            version=self.dbinfo.version + 1, epoch=epoch, master=master_addr,
            proxies=proxy_addrs, resolvers=resolver_addrs,
            log_epochs=new_epochs, storages=storages,
            shard_boundaries=boundaries, recovery_state="accepting_commits",
            ratekeeper=rk_addr, shard_tags=shard_tags,
            grv_proxies=grv_addrs)
        self._c_recoveries.increment()
        TraceEvent("CCRecovered", self.process.address) \
            .detail("Epoch", epoch).detail("RecoveryVersion", recovery_version) \
            .detail("Proxies", len(proxy_addrs)).detail("TLogs", len(tlog_addrs)).log()

        # recovery transaction (the reference's recovery txn +
        # sendInitialCommitToResolvers, masterserver.actor.cpp:597-690),
        # run in the BACKGROUND and retried until it lands or the generation
        # dies: it writes the keyServers snapshot INTO the database so DD's
        # read-modify-write layout txns have rows to read (DD waits on
        # _initial_meta_done). Blocking the publish on it would make
        # recovery fragile under sustained clogging; the one thing that
        # genuinely cannot wait — an in-flight backup's mutation-log tee —
        # is instead self-seeded by each proxy from durable storage before
        # it accepts any commit (Proxy._seed_backup_ranges), so no client
        # write can land in an un-teed gap.
        self._watchers.append(self.process.spawn(
            self._write_initial_metadata(system_snapshot), "recoveryTxn"))

        # shard tracker / relocator (DataDistribution.actor.cpp:2260 runs
        # alongside the master; here it runs with the CC and survives until
        # the next recovery replaces it)
        self._watchers.append(
            self.process.spawn(self._data_distribution(), "dataDistribution"))
        # fitness preemption (betterMasterExists, ClusterController.actor.cpp
        # :799): when strictly better-class workers become available for the
        # txn subsystem, one recovery migrates the roles onto them
        self._watchers.append(self.process.spawn(
            self._preemption_watch(epoch), "betterMasterExists"))
        # babysit the new generation (role stomps by racing recoveries,
        # self-deposed masters, and self-killed proxies are caught by the
        # epoch watchers; worker deaths by the incarnation pings)
        self._watchers.append(self.process.spawn(
            self._watch_epoch_role(master_addr, Token.MASTER_PING, epoch,
                                   "master"), "watchMaster"))
        for pa in proxy_addrs:
            self._watchers.append(self.process.spawn(
                self._watch_epoch_role(pa, Token.PROXY_PING, epoch, "proxy"),
                "watchProxy"))
        for ga in grv_addrs:
            self._watchers.append(self.process.spawn(
                self._watch_epoch_role(ga, Token.PROXY_PING, epoch,
                                       "grv_proxy"), "watchGrvProxy"))
        router_addrs = sorted({a for a, _u in router_of.values()})
        for addr in sorted(set([master_addr] + proxy_addrs + grv_addrs
                               + resolver_addrs + tlog_addrs + sat_addrs
                               + router_addrs + [rk_addr])):
            self._watchers.append(self.process.spawn(
                self._watch_role(addr, "txn",
                                 self._incarnations.get(addr, 0)),
                "watchRole"))

    async def _recruit_log_routers(self, remote_dc: str, tags: list[int],
                                   epochs: list[LogEpoch], begin: int,
                                   epoch: int, excluded: set,
                                   now: float) -> dict:
        """Recruit the standby region's log routers (LogRouter.actor.cpp):
        tags are partitioned round-robin over n_log_routers routers hosted
        on the region's tlog-capable workers; each router pulls its tags
        from the primary log system once and re-serves them locally.
        Returns {tag: (router_addr, router_uid)}."""
        cfg = self.config
        workers = [a for a in self.registry.alive("tlog", now)
                   if a not in excluded
                   and self.registry.locality_of(a).dc_id == remote_dc]
        if not workers:
            raise FDBError("recruitment_failed",
                           "no remote-region log-router workers")
        n = max(1, min(cfg.n_log_routers, len(workers)))
        router_of: dict[int, tuple[str, str]] = {}
        for j in range(n):
            uid = (f"e{epoch}-{self.process.address}"
                   f"-a{self._attempt}-lr{j}")
            tags_j = [t for k, t in enumerate(tags) if k % n == j]
            if not tags_j:
                continue
            addr = (await self._recruit_many(
                [workers[j % len(workers)]], 1, "logrouter",
                lambda _i, uid=uid, tags_j=tags_j: {
                    "uid": uid, "tags": tags_j,
                    "epochs": list(epochs), "begin": begin}))[0]
            for t in tags_j:
                router_of[t] = (addr, uid)
        return router_of

    @staticmethod
    def _router_epochs(epochs: list[LogEpoch], router_of: dict,
                       tag: int) -> list[LogEpoch]:
        """A remote storage's epoch view: the OPEN generation routes through
        the tag's log router; closed generations stay direct (their data is
        already applied locally or reachable with peek failover — including
        the satellite members folded into each epoch's addr list)."""
        if tag not in router_of:
            return list(epochs)
        addr, uid = router_of[tag]
        last = epochs[-1]
        return list(epochs[:-1]) + [LogEpoch(
            begin=last.begin, end=last.end, addrs=[addr], epoch=last.epoch,
            uids=[uid], n_primary=1)]

    async def _lock_old_generation(self, old: LogEpoch) -> int:
        """epochEnd (TagPartitionedLogSystem:398-417): lock enough old TLogs
        that no old-generation commit can reach quorum again, then choose the
        recovery version.

        With commit quorum N - a (antiquorum a), locking a+1 logs fences the
        generation. For the recovery version we use the (s-a)-th highest
        durable version over the s locked logs: any acknowledged commit is
        durable on >= N-a logs, so at least s-a locked logs hold it and the
        (s-a)-th highest durable version is >= every acked commit. With the
        default a=0 this is min-over-locked, which every locked log holds in
        full (so the data for every recovered version is reachable)."""
        # the SAME antiquorum the proxies commit with (proxy.py quorum =
        # len(tlogs) - TLOG_QUORUM_ANTIQUORUM): the fencing and recovery-
        # version math below is only sound against the real commit quorum
        a = KNOBS.TLOG_QUORUM_ANTIQUORUM
        futures = [self.loop.timeout(self.net.request(
            self.process, Endpoint(addr, Token.TLOG_LOCK),
            TLogLockRequest(epoch=old.epoch + 1, uid=old.uid_of(i))), 2.0)
            for i, addr in enumerate(old.addrs)]
        # a+1 locked logs fence the old generation (the alive unlocked
        # remainder is below the N-a commit quorum) and suffice for safety:
        # any acked commit is durable on >= N-a logs, so >= s-a of any s
        # locked logs hold it. Locking MORE when available only improves the
        # data's reachability, so collect every answer (bounded by the
        # per-request timeouts already attached).
        need = a + 1
        replies = []
        for f in futures:
            try:
                replies.append(await f)
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise
        if len(replies) < need:
            raise FDBError("master_tlog_failed",
                           "cannot lock enough old TLogs")
        durables = sorted((r.durable_version for r in replies), reverse=True)
        s = len(durables)
        recovery_version = durables[max(0, s - a - 1)]
        return recovery_version

    async def _recruit_many(self, workers: list[str], n: int, role: str,
                            make_args) -> list[str]:
        if self.deposed:
            # a deposed CC must stop recruiting immediately: its half-built
            # generation would stomp the new leader's roles on shared workers
            raise FDBError("recruitment_failed", "deposed")
        addrs = []
        for i in range(n):
            addr = workers[i % len(workers)]
            try:
                r = await self.loop.timeout(self.net.request(
                    self.process, Endpoint(addr, Token.WORKER_INIT_ROLE),
                    InitRoleRequest(role=role, args=make_args(i))), 2.0)
                addrs.append(r.address)
                self._incarnations[r.address] = r.incarnation
            except FDBError as e:
                raise FDBError("recruitment_failed",
                               f"{role} on {addr}: {e.name}") from None
        return addrs

    # -- data distribution (shard tracker + relocator) --

    async def _data_distribution(self):
        """shardSplitter (DataDistributionTracker.actor.cpp:314) + a
        least-loaded relocation policy (DataDistributionQueue :849) +
        MoveKeys-style execution: split an oversized shard at its sampled
        median and hand the upper half to the team currently serving the
        fewest shards. Every step is fenced so no mutation is lost:
          1. swap every proxy's shard map (dual-routes the moving range)
          2. take a version fence from the master (all later commits use
             the new routing)
          3. destination team fetches the range (storage _add_shard)
          4. publish the new layout (cstate + DBInfo); source drops the range
        """
        while True:
            await self.loop.delay(KNOBS.DD_INTERVAL_SECONDS)
            info = self.dbinfo
            if self.deposed or info.recovery_state != "accepting_commits" \
                    or not getattr(self, "_initial_meta_done", False):
                continue
            try:
                # QuietDatabase's "data distribution idle" signal: a checker
                # must not race an in-flight relocation's splice/publish
                self._dd_moving = True
                await self._dd_once()
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise
                TraceEvent("DDRoundFailed", self.process.address) \
                    .detail("Error", e.name).log()
            finally:
                self._dd_moving = False

    async def _dd_once(self):
        info = self.dbinfo
        # live configuration from \xff/conf (ManagementAPI changeConfig):
        # replication/exclusions apply through the healing machinery below;
        # txn-subsystem shape changes trigger a recovery that re-recruits
        # with the new counts
        conf = await self._read_db_conf()
        if conf is None:
            return  # conf unreadable this round: do nothing rather than
                    # act on boot-time defaults
        if await self._apply_conf_shape(info, conf):
            return
        # reconcile next: a failed round can leave the live \xff/keyServers
        # mid-transition (e.g. dual-routed) while dbinfo/cstate still hold
        # the last PUBLISHED layout. Published state is the authority (an
        # unpublished move is by definition not final and its dual-route
        # window is safe to revert), and without this the expected-value
        # guards in every later layout txn would wedge forever.
        if await self._reconcile_keyservers(info):
            return
        # redundancy healing next (the relocation queue's highest priority,
        # DataDistributionQueue.actor.cpp PRIORITY_TEAM_UNHEALTHY)
        if await self._heal_once(info, conf):
            return
        b = list(info.shard_boundaries)
        teams = [list(t) for t in info.teams()]
        addr_of_tag = {t: a for a, t in info.storages}
        # conflict-hotspot feed (docs/contention.md): the resolver sketch
        # gives DD a second split trigger — sustained write contention on a
        # shard splits it even when its byte count is small
        from foundationdb_tpu_torch.server.hotspot import overlaps
        hot_ranges = await self._poll_hot_ranges(info)
        streaks = getattr(self, "_hot_streaks", None)
        if streaks is None:
            streaks = self._hot_streaks = {}
        hot_shards: set[bytes] = set()  # shard begin keys hot THIS round
        hot_split: tuple[int, bytes] | None = None
        # sample every shard from one replica
        sizes: list[int] = []
        for i, team in enumerate(teams):
            lo = b[i]
            hi = b[i + 1] if i + 1 < len(b) else None
            owner = addr_of_tag[team[0]]
            metrics = await self.loop.timeout(self.net.request(
                self.process, Endpoint(owner, Token.STORAGE_GET_METRICS),
                GetStorageMetricsRequest(ranges=[(lo, hi)])), 2.0)
            m = metrics[0]
            sizes.append(m.bytes)
            rate = sum(hr.rate for hr in hot_ranges
                       if overlaps(hr.begin, hr.end, lo, hi))
            if rate >= KNOBS.DD_SHARD_SPLIT_CONFLICT_RATE:
                hot_shards.add(lo)
                streaks[lo] = streaks.get(lo, 0) + 1
                if (hot_split is None and m.split_key is not None
                        and streaks[lo] >= KNOBS.DD_HOT_SHARD_ROUNDS):
                    hot_split = (i, m.split_key)
            else:
                streaks.pop(lo, None)
            if m.bytes <= KNOBS.DD_SHARD_SPLIT_BYTES or m.split_key is None:
                continue
            await self._split_and_move(i, m.split_key)
            return  # one relocation per round
        if hot_split is not None:
            i, split_key = hot_split
            streaks.pop(b[i], None)  # the streak acted; children start fresh
            TraceEvent("DDConflictSplit", self.process.address) \
                .detail("Shard", b[i].hex()) \
                .detail("SplitKey", split_key.hex()).log()
            await self._split_and_move(i, split_key)
            return
        # shardMerger (:379): two adjacent small shards on the SAME team
        # collapse back into one — metadata-only (no data moves). Skip pairs
        # touching a currently-hot shard: re-merging what the conflict
        # trigger just split would make the two triggers fight forever.
        for i in range(len(teams) - 1):
            if b[i] in hot_shards or b[i + 1] in hot_shards:
                continue
            if (teams[i] == teams[i + 1]
                    and sizes[i] + sizes[i + 1] < KNOBS.DD_SHARD_MERGE_BYTES):
                await self._merge(i)
                return

    async def _poll_hot_ranges(self, info) -> list:
        """Merged conflict-hotspot snapshot across the live resolvers (the
        DD side of the contention loop; ratekeeper polls independently for
        throttling). A dead resolver costs one bounded timeout and is
        skipped — DD must keep distributing through resolver failures."""
        if not KNOBS.CONTENTION_THROTTLE_ENABLED or not info.resolvers:
            return []
        out = []
        for a in info.resolvers:
            try:
                r = await self.loop.timeout(self.net.request(
                    self.process, Endpoint(a, Token.RESOLVER_HOT_RANGES),
                    KNOBS.HOTSPOT_TOP_K), 1.0)
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise
                continue
            out.extend(r.ranges)
        return out

    async def _write_initial_metadata(self, snapshot):
        """Persist the recovery's \\xff snapshot through the pipeline
        (idempotent: re-writes the cstate-derived layout; a ghost from a
        deposed generation dies at its locked TLogs). DD mutations wait on
        this."""
        from foundationdb_tpu_torch.server import systemdata
        db = self._dd_database()  # pre-wired by the recovery
        while not self.deposed and not self._need_recovery.is_ready():
            try:
                tr = db.create_transaction()
                tr.clear_range(systemdata.KEY_SERVERS_PREFIX,
                               systemdata.KEY_SERVERS_END)
                for k, v in snapshot:
                    tr.set(k, v)
                await tr.commit()  # RPCs inside are individually bounded
                self._initial_meta_done = True
                return
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise
                await self.loop.delay(1.0)

    def _dd_database(self):
        """Client handle the DD uses to run layout transactions (the
        reference's DD runs its moveKeys transactions through NativeAPI,
        DataDistribution.actor.cpp; MoveKeys.actor.cpp)."""
        if getattr(self, "_dd_db", None) is None:
            from foundationdb_tpu_torch.client.database import Database
            self._dd_db = Database(self.process,
                                   coordinators=list(self.coordinators))
        return self._dd_db

    async def _commit_metadata_txn(self, info, expected: dict, mutations) -> int:
        """Run a layout metadata transaction through the commit pipeline (the
        moveKeys-transaction analogue, MoveKeys.actor.cpp): resolved by every
        resolver, applied to every proxy's txnStateStore in version order.

        `expected` maps each touched \\xff key to the value this round
        believes is current; the transaction READS those keys (conflict
        ranges at its snapshot) and aborts if they moved. This makes a ghost
        commit — an RPC the CC timed out on that delivers later — harmless:
        either the keyspace is unchanged (the ghost re-writes the same
        values) or something advanced it and the ghost CONFLICTS. A timeout
        here fails the DD round; the next round re-reads the live layout.

        Returns the commit version — by the pipeline's ordering guarantee,
        every batch with a later version routes with the new map, so the
        returned version IS the routing fence."""
        db = self._dd_database()
        await db.refresh(max_wait=5.0)
        tr = db.create_transaction()
        try:
            for k, want in expected.items():
                cur = await tr.get(k)
                if cur != want:
                    raise FDBError("operation_failed",
                                   f"layout moved under DD: {k!r}")
            for m in mutations:
                if m.type == MutationType.CLEAR_RANGE:
                    tr.clear_range(m.param1, m.param2)
                else:
                    tr.set(m.param1, m.param2)
            await tr.commit()
            return tr.committed_version
        except FDBError as e:
            if e.name == "operation_cancelled":
                raise
            raise FDBError("operation_failed",
                           f"metadata txn failed: {e.name}") from None

    async def _preemption_watch(self, epoch: int):
        """Trigger ONE recovery when the current generation's txn roles
        could be placed on strictly better-fitness workers (a degraded-but-
        alive generation is otherwise never improved). The candidate must
        look better across two consecutive checks so a worker mid-reboot
        doesn't cause churn."""
        better_streak = 0
        while True:
            await self.loop.delay(KNOBS.CC_PREEMPT_INTERVAL_SECONDS)
            info = self.dbinfo
            if (self.deposed or info.epoch != epoch
                    or info.recovery_state != "accepting_commits"):
                return
            now = self.loop.now()

            def current_cost(addrs, kind):
                return sum(role_fitness(kind, self.registry.class_of(a))
                           for a in addrs)

            # recruitment skips excluded workers; a better-looking placement
            # that needs one would churn recoveries forever
            excluded = set(
                (getattr(self, "_cstate_conf", None) or {}).get("excluded")
                or [])

            def best_cost(kind, families):
                # mirror recruitment's placement exactly: each role FAMILY
                # takes workers from the front of the fitness-ranked list
                # independently (proxies from ranked[0..], resolvers from
                # ranked[0..], ...), excluded workers removed
                ranked = [a for a in self.registry.alive(
                    "stateless" if kind == "stateless" else kind, now)
                    if a not in excluded]
                if not ranked:
                    return None  # can't even re-recruit: no preemption
                return sum(
                    role_fitness(kind, self.registry.class_of(
                        ranked[i % len(ranked)]))
                    for size in families for i in range(size))

            stateless_addrs = ([info.master] + list(info.proxies)
                               + list(info.resolvers)
                               + ([info.ratekeeper] if info.ratekeeper else []))
            last_ep = info.log_epochs[-1] if info.log_epochs else None
            tlog_addrs = (last_ep.addrs[:last_ep.n_primary or len(last_ep.addrs)]
                          if last_ep else [])
            cur = (current_cost(stateless_addrs, "stateless")
                   + current_cost(tlog_addrs, "tlog"))
            b_s = best_cost("stateless", [1, len(info.proxies),
                                          len(info.resolvers),
                                          1 if info.ratekeeper else 0])
            b_t = best_cost("tlog", [len(tlog_addrs)])
            if b_s is None or b_t is None or b_s + b_t >= cur:
                better_streak = 0
                continue
            better_streak += 1
            if better_streak < 2:
                continue
            TraceEvent("CCBetterMasterExists", self.process.address) \
                .detail("Current", cur).detail("Best", b_s + b_t).log()
            if not self._need_recovery.is_ready():
                self._need_recovery._set("betterMasterExists")
            return

    async def _read_db_conf(self) -> dict | None:
        """Live \\xff/conf contents (ManagementAPI surface); None when the
        read failed — callers must SKIP the round, not act on boot defaults
        (falling back would e.g. shrink-team a `configure double` cluster
        on any transient read blip)."""
        from foundationdb_tpu_torch.client import management
        db = self._dd_database()
        try:
            return await management.get_configuration(db)
        except FDBError as e:
            if e.name == "operation_cancelled":
                raise
            return None

    async def _apply_conf_shape(self, info, conf: dict) -> bool:
        """Txn-subsystem shape changes (n_proxies/n_resolvers/n_tlogs):
        persist to the cstate and trigger a recovery that re-recruits with
        the new counts (the reference equally restarts the transaction
        subsystem on such configure commands). Exclusions are synced into
        the cstate too, so recruitment (which runs while the database is
        unreadable) honors them. Returns True if a recovery was triggered."""
        now = self.loop.now()
        excluded = sorted(conf.get("excluded") or [])
        shape = {}
        cur = {"n_proxies": len(info.proxies),
               "n_grv_proxies": len(info.grv_proxies),
               "n_resolvers": len(info.resolvers),
               "n_tlogs": len(info.log_epochs[-1].addrs[
                   :info.log_epochs[-1].n_primary
                   or len(info.log_epochs[-1].addrs)])
               if info.log_epochs else 0}
        for k in ("n_proxies", "n_grv_proxies", "n_resolvers", "n_tlogs"):
            if k in conf and conf[k] != cur[k]:
                shape[k] = conf[k]
        want_conf = {k: v for k, v in conf.items() if k != "excluded"}
        want_conf["excluded"] = excluded
        if not shape and want_conf == getattr(self, "_cstate_conf", None):
            return False
        if shape:
            # feasibility: a shape the registry cannot satisfy would brick
            # the cluster (recovery fails forever; the corrective configure
            # can never commit while recovery holds the database down).
            # Mirror recruitment exactly: excluded workers don't count.
            ex = set(excluded)
            n_stateless = len([a for a in self.registry.alive(
                "stateless", now) if a not in ex])
            avail = {
                "n_proxies": n_stateless,
                "n_grv_proxies": n_stateless,
                "n_resolvers": n_stateless,
                "n_tlogs": len([a for a in self.registry.alive("tlog", now)
                                if a not in ex])}
            bad = {k: v for k, v in shape.items() if v > avail[k]}
            # commit + GRV proxies each need their own stateless worker
            want_px = (shape.get("n_proxies", cur["n_proxies"])
                       + shape.get("n_grv_proxies", cur["n_grv_proxies"]))
            if want_px > n_stateless:
                bad.setdefault("n_proxies+n_grv_proxies", want_px)
            if bad:
                TraceEvent("CCConfigureInfeasible", self.process.address,
                           severity=30).detail("Requested", bad) \
                    .detail("Available", avail).log()
                return False
        prior, _gen = await self.cstate.read()
        if prior is None or prior.get("epoch") != info.epoch or self.deposed:
            return False
        prior["conf"] = want_conf
        await self.cstate.write(prior)
        self._cstate_conf = want_conf
        if not shape:
            return False  # exclusion sync only: no recovery needed
        TraceEvent("CCConfigureRecovery", self.process.address) \
            .detail("Shape", shape).log()
        if not self._need_recovery.is_ready():
            self._need_recovery._set(f"configure {shape}")
        return True

    async def _reconcile_keyservers(self, info) -> bool:
        """Compare the live \\xff/keyServers rows with the published layout;
        if they differ, write the published layout back (expected = the live
        values just read, so a delayed ghost of this txn conflicts unless
        nothing changed). Returns True if a corrective txn ran."""
        from foundationdb_tpu_torch.server import systemdata
        db = self._dd_database()
        await db.refresh(max_wait=5.0)
        tr = db.create_transaction()
        try:
            live = await tr.get_range(systemdata.KEY_SERVERS_PREFIX,
                                      systemdata.KEY_SERVERS_END)
            want = systemdata.build_keyservers_snapshot(
                list(info.shard_boundaries), [list(t) for t in info.teams()])
            if list(live) == want:
                return False
            TraceEvent("DDReconcileLayout", self.process.address) \
                .detail("Live", len(live)).detail("Want", len(want)).log()
            tr.clear_range(systemdata.KEY_SERVERS_PREFIX,
                           systemdata.KEY_SERVERS_END)
            for k, v in want:
                tr.set(k, v)
            await tr.commit()
            return True
        except FDBError as e:
            if e.name == "operation_cancelled":
                raise
            raise FDBError("operation_failed",
                           f"reconcile failed: {e.name}") from None

    # -- redundancy healing (teamTracker DataDistribution.actor.cpp:1373 +
    # storageServerTracker :1730): a storage server silent past the failure
    # timeout is permanently failed; every shard it served is re-replicated
    # onto a replacement via the normal dual-route + fetchKeys move --

    async def _heal_once(self, info, conf: dict | None = None) -> bool:
        from foundationdb_tpu_torch.server import systemdata
        conf = conf or {}
        now = self.loop.now()
        alive = set(self.registry.alive(
            "storage", now, max_age=KNOBS.DD_STORAGE_FAILURE_SECONDS))
        # excluded servers are drained exactly like failed ones
        # (ManagementAPI excludeServers -> DD moves every shard off them)
        excluded = set(conf.get("excluded") or [])
        alive -= excluded
        addr_of_tag = {t: a for a, t in info.storages}
        dead_tags = {t for a, t in info.storages if a not in alive}
        teams = [list(t) for t in info.teams()]
        b = list(info.shard_boundaries)
        # a team needs healing if it references a dead/excluded tag OR is
        # off the replication target (below: top up one replacement per
        # round; above after `configure single`: shrink one per round)
        want = int(conf.get("n_replicas", self.config.n_replicas))
        over = [(i, t) for i, t in enumerate(teams)
                if not any(x in dead_tags for x in t) and len(t) > want]
        if over:
            return await self._shrink_team(info, over[0][0], want)
        affected = [(i, t) for i, t in enumerate(teams)
                    if any(x in dead_tags for x in t)
                    or len([x for x in t if x not in dead_tags]) < want]
        if not affected:
            # GC: a dead tag referenced by NO team can be dropped — pop it
            # on every TLog so the queue can truncate, and forget the server
            gone = [t for t in dead_tags
                    if not any(t in team for team in teams)]
            if gone:
                await self._forget_tags(info, gone)
                return True
            return False
        i, team = affected[0]
        alive_in_team = [t for t in team if t not in dead_tags]
        if not alive_in_team:
            TraceEvent("DDShardUnrecoverable", self.process.address,
                       severity=40).detail("Shard", i).log()
            return False  # every replica lost: nothing to copy from
        lo = b[i]
        hi = b[i + 1] if i + 1 < len(b) else None

        # replacement: a spare alive storage worker (no live tag), else an
        # alive server not already in this team. Among spares, prefer one
        # that keeps the team satisfying the replication policy (a zone the
        # surviving members don't cover, ReplicationPolicy Across semantics).
        from foundationdb_tpu_torch.server.replication import (
            policy_for_replication, select_replicas)
        used = {addr_of_tag[t] for t in addr_of_tag
                if t not in dead_tags}
        spare = sorted(a for a in alive if a not in used)
        if len(spare) > 1:
            policy = policy_for_replication(want)
            surviving = [(addr_of_tag[t], self.registry.locality_of(
                addr_of_tag[t])) for t in alive_in_team]
            best = select_replicas(
                policy, [(a, self.registry.locality_of(a)) for a in spare],
                already=surviving)
            if best:
                spare = best + [a for a in spare if a not in best]
        new_storages = list(info.storages)
        if spare:
            new_tag = max((t for _a, t in info.storages), default=-1) + 1
            epoch0 = info.log_epochs[-1].begin if info.log_epochs else 0
            addr = (await self._recruit_many(
                [spare[0]], 1, "storage",
                lambda _i: {"tag": new_tag,
                            "log_epochs": list(info.log_epochs),
                            "recovery_count": info.epoch,
                            "recovery_version": epoch0,
                            "shard_ranges": [],
                            "engine": conf.get("storage_engine")}))[0]
            new_storages.append((addr, new_tag))
            addr_of_tag[new_tag] = addr
        else:
            candidates = [t for _a, t in info.storages
                          if t not in dead_tags and t not in team]
            if not candidates:
                TraceEvent("DDHealNoReplacement", self.process.address) \
                    .detail("Shard", i).log()
                return False
            new_tag = candidates[0]
        TraceEvent("DDHealShard", self.process.address) \
            .detail("Shard", i) \
            .detail("DeadTags", sorted(set(team) - set(alive_in_team))) \
            .detail("NewTag", new_tag).log()

        # dual-route (mutations flow to the replacement from the fence on),
        # copy from an alive replica, then finalize the team without the
        # dead tag — the same fenced move shards use
        fence = await self._commit_metadata_txn(
            info,
            {systemdata.keyservers_key(lo): systemdata.encode_tags(team)},
            [Mutation(MutationType.SET_VALUE, systemdata.keyservers_key(lo),
                      systemdata.encode_tags(sorted(set(team) | {new_tag})))])
        src = addr_of_tag[alive_in_team[0]]
        await self.loop.timeout(self.net.request(
            self.process, Endpoint(addr_of_tag[new_tag],
                                   Token.STORAGE_ADD_SHARD),
            AddShardRequest(begin=lo, end=hi, source=src,
                            fence_version=fence)), 30.0)
        new_team = sorted(set(alive_in_team) | {new_tag})
        done = await self._commit_metadata_txn(
            info,
            {systemdata.keyservers_key(lo):
                 systemdata.encode_tags(sorted(set(team) | {new_tag}))},
            [Mutation(MutationType.SET_VALUE, systemdata.keyservers_key(lo),
                      systemdata.encode_tags(new_team))])
        new_teams = [list(t) for t in teams]
        new_teams[i] = new_team
        await self._publish_layout(b, new_teams, storages=new_storages)
        # serving ranges for every OLD member too, not just the new team: a
        # drained-but-alive member (exclusion heals look exactly like dead-
        # server heals) must drop the range, or a later move back onto it
        # would look like a duplicate and skip the re-fetch — serving every
        # write since the drain from a stale replica
        self._push_team_ranges(sorted(set(team) | {new_tag}), b, new_teams,
                               addr_of_tag, as_of_version=done)
        return True

    async def _shrink_team(self, info, i: int, want: int) -> bool:
        """Drop one member from an over-replicated team (configure down):
        metadata txn, publish, updated serving ranges. The dropped member's
        tag is GC'd by _forget_tags once no team references it."""
        from foundationdb_tpu_torch.server import systemdata
        from foundationdb_tpu_torch.server.replication import (
            policy_for_replication, select_replicas)
        teams = [list(t) for t in info.teams()]
        b = list(info.shard_boundaries)
        team = teams[i]
        addr_of_tag = {t: a for a, t in info.storages}
        # retain a subset that still satisfies the replication policy at the
        # new size (dropping by tag order alone can keep two same-zone
        # replicas and drop the only one in a distinct zone)
        policy = policy_for_replication(want)
        tag_of_addr = {a: t for a, t in info.storages}
        cands = [(addr_of_tag[t], self.registry.locality_of(addr_of_tag[t]))
                 for t in sorted(team) if t in addr_of_tag]
        picked = select_replicas(policy, cands)
        if picked is not None and len(picked) == want:
            new_team = sorted(tag_of_addr[a] for a in picked)
        else:
            new_team = sorted(team)[:want]
            TraceEvent("DDShrinkTeamNoPolicySubset", self.process.address) \
                .detail("Shard", i).detail("Policy", str(policy)).log()
        TraceEvent("DDShrinkTeam", self.process.address) \
            .detail("Shard", i).detail("From", team).detail("To", new_team).log()
        done = await self._commit_metadata_txn(
            info,
            {systemdata.keyservers_key(b[i]): systemdata.encode_tags(team)},
            [Mutation(MutationType.SET_VALUE, systemdata.keyservers_key(b[i]),
                      systemdata.encode_tags(new_team))])
        new_teams = [list(t) for t in teams]
        new_teams[i] = new_team
        await self._publish_layout(b, new_teams)
        # every old member (dropped ones included) gets its remaining
        # assignments pushed — possibly empty (new_team is a subset of team)
        self._push_team_ranges(sorted(set(team)), b, new_teams, addr_of_tag,
                               as_of_version=done)
        return True

    async def _forget_tags(self, info, tags: list[int]):
        """Drop fully-unreferenced dead tags: final TLog pops (so disk
        queues can truncate past their backlog) + remove from the server
        list."""
        from foundationdb_tpu_torch.server.interfaces import TLogPopRequest
        for ep in info.log_epochs:
            for j, addr in enumerate(ep.addrs):
                for t in tags:
                    self.net.one_way(
                        self.process, Endpoint(addr, Token.TLOG_POP),
                        TLogPopRequest(tag=t, version=1 << 60,
                                       uid=ep.uid_of(j)))
        new_storages = [(a, t) for a, t in info.storages if t not in tags]
        TraceEvent("DDForgetTags", self.process.address) \
            .detail("Tags", list(tags)).log()
        await self._publish_layout(list(info.shard_boundaries),
                                   [list(t) for t in info.teams()],
                                   storages=new_storages)

    async def _merge(self, i: int):
        """Drop the boundary between shards i and i+1 (same team): one
        metadata transaction clears its \\xff/keyServers entry (every proxy
        applies it in version order), then publish through the cstate and
        DBInfo. Stale layouts stay correct — the union of the halves is
        exactly the merged shard on the same servers."""
        from foundationdb_tpu_torch.server import systemdata
        info = self.dbinfo
        b = list(info.shard_boundaries)
        teams = [list(t) for t in info.teams()]
        new_b = b[:i + 1] + b[i + 2:]
        new_teams = teams[:i + 1] + teams[i + 2:]
        TraceEvent("DDMergeShards", self.process.address) \
            .detail("At", b[i + 1].hex()).log()
        k = systemdata.keyservers_key(b[i + 1])
        done = await self._commit_metadata_txn(
            info,
            {k: systemdata.encode_tags(teams[i + 1]),
             systemdata.keyservers_key(b[i]): systemdata.encode_tags(teams[i])},
            [Mutation(MutationType.CLEAR_RANGE, k, k + b"\x00")])
        await self._publish_layout(new_b, new_teams)
        # the merged team's storage servers must coalesce their served
        # ranges too: _owns_range requires a request to fit ONE entry, so a
        # post-merge range read spanning the former boundary would get
        # wrong_shard_server forever from a team with explicit shard_ranges
        addr_of_tag = {t: a for a, t in info.storages}
        self._push_team_ranges(teams[i], new_b, new_teams, addr_of_tag,
                               as_of_version=done)

    def _tag_ranges(self, tag, boundaries, teams):
        """EVERY range `tag` serves — the union over all shards whose team
        contains it. Teams may overlap (healing/configure reuse servers), so
        a per-team list would clobber a member's other assignments."""
        return [(boundaries[j],
                 boundaries[j + 1] if j + 1 < len(boundaries) else None)
                for j, t in enumerate(teams) if tag in t]

    def _push_team_ranges(self, team, boundaries, teams, addr_of_tag,
                          as_of_version=None):
        lv = (self.dbinfo.epoch, self.dbinfo.version)
        for tag in team:
            if addr_of_tag.get(tag) is None:
                continue
            self.net.one_way(
                self.process,
                Endpoint(addr_of_tag[tag], Token.STORAGE_SET_SHARDS),
                SetShardsRequest(
                    shard_ranges=self._tag_ranges(tag, boundaries, teams),
                    layout_version=lv, as_of_version=as_of_version))

    async def _publish_layout(self, new_b, new_teams, storages=None):
        """Shared publish step for every DD layout change: the coordinated
        state FIRST (a racing recovery must see a consistent layout), then
        DBInfo for clients. Aborts if the epoch moved or we were deposed."""
        info = self.dbinfo
        if storages is None:
            storages = info.storages
        prior, _gen = await self.cstate.read()
        if prior is None or prior.get("epoch") != info.epoch or self.deposed:
            raise FDBError("coordinators_changed", "layout changed under DD")
        prior["shard_boundaries"] = new_b
        prior["shard_tags"] = new_teams
        prior["storages"] = [list(s) for s in storages]
        await self.cstate.write(prior)
        self.dbinfo = DBInfo(
            version=info.version + 1, epoch=info.epoch, master=info.master,
            proxies=info.proxies, resolvers=info.resolvers,
            log_epochs=info.log_epochs, storages=[tuple(s) for s in storages],
            shard_boundaries=new_b, recovery_state="accepting_commits",
            ratekeeper=info.ratekeeper, shard_tags=new_teams)

    async def _split_and_move(self, i: int, split_key: bytes):
        info = self.dbinfo
        b = list(info.shard_boundaries)
        teams = [list(t) for t in info.teams()]
        addr_of_tag = {t: a for a, t in info.storages}
        old_team = teams[i]
        hi = b[i + 1] if i + 1 < len(b) else None
        # destination: the team serving the fewest shards (itself included:
        # a pure split happens when the source team is least loaded)
        uniq: list[list[int]] = []
        for t in teams:
            if t not in uniq:
                uniq.append(t)
        counts = {tuple(t): sum(1 for x in teams if x == t) for t in uniq}
        dest = min(uniq, key=lambda t: (counts[tuple(t)], tuple(t)))
        new_b = b[:i + 1] + [split_key] + b[i + 1:]
        new_teams = teams[:i + 1] + [dest] + teams[i + 1:]
        # during the handoff the moving range is DUAL-ROUTED to source and
        # destination tags: the source keeps serving (and seeing) acked
        # writes until the layout is published, and a CC crash mid-move
        # leaves the old cstate layout fully correct (the source missed
        # nothing; the destination's partial copy is simply never served)
        from foundationdb_tpu_torch.server import systemdata
        both = sorted(set(old_team) | set(dest))
        TraceEvent("DDSplitShard", self.process.address) \
            .detail("At", split_key.hex()).detail("Move", dest != old_team).log()

        # 1. dual-route via a metadata transaction: \xff/keyServers/<split>
        # = union team flows through the pipeline; every proxy applies it in
        # version order BEFORE routing any later batch, so the txn's commit
        # version IS the fence — every mutation with a later version is
        # routed to both teams (the moveKeys startMoveKeys analogue). The
        # expected-value reads abort the txn (or any delayed ghost of an
        # earlier round) if the layout moved.
        fence = await self._commit_metadata_txn(
            info,
            {systemdata.keyservers_key(b[i]): systemdata.encode_tags(old_team),
             systemdata.keyservers_key(split_key): None},
            [Mutation(MutationType.SET_VALUE,
                      systemdata.keyservers_key(split_key),
                      systemdata.encode_tags(both))])
        # 2. destination fetches at/above the fence (no-op when the team
        # keeps the shard)
        if dest != old_team:
            src = addr_of_tag[old_team[0]]
            for tag in dest:
                await self.loop.timeout(self.net.request(
                    self.process,
                    Endpoint(addr_of_tag[tag], Token.STORAGE_ADD_SHARD),
                    AddShardRequest(begin=split_key, end=hi, source=src,
                                    fence_version=fence)), 30.0)
        # 3. publish: cstate first (a concurrent recovery must see the new
        # layout), then DBInfo for clients; finally shrink the source
        await self._publish_layout(new_b, new_teams)
        # 4. end the dual-route window (finishMoveKeys analogue): final
        # single-team entry, then the source stops serving the moved range
        # (stale clients get wrong_shard_server and re-resolve through the
        # published layout)
        done = await self._commit_metadata_txn(
            info,
            {systemdata.keyservers_key(split_key):
                 systemdata.encode_tags(both)},
            [Mutation(MutationType.SET_VALUE,
                      systemdata.keyservers_key(split_key),
                      systemdata.encode_tags(dest))])
        if dest != old_team:
            self._push_team_ranges(old_team, new_b, new_teams, addr_of_tag,
                                   as_of_version=done)
