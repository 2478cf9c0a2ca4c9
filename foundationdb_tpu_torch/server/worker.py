"""Worker: the role host every server process runs.

Reference: fdbserver/worker.actor.cpp (workerServer :498) — a worker registers
with the cluster controller, serves Initialize*Request RPCs by instantiating
roles in-process (:694-794), and on reboot restores disk-backed roles (the
storage server re-attaches to its files). Here the Initialize* family is
collapsed into one parameterized InitRoleRequest (interfaces.py).
"""

from __future__ import annotations

from foundationdb_tpu_torch.core.sim import Endpoint, SimProcess
from foundationdb_tpu_torch.server.coordination import CoordToken, get_leader
from foundationdb_tpu_torch.server.interfaces import (
    InitRoleReply, InitRoleRequest, RegisterWorkerRequest, Token)
from foundationdb_tpu_torch.ops.batch import validate_conflict_config
from foundationdb_tpu_torch.storage.kvstore import validate_storage_engine
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS


class Worker:
    def __init__(self, process: SimProcess, coordinators: list[str],
                 capabilities: list[str], process_class: str = "unset"):
        # fail at boot on a misconfigured engine, not on the first storage
        # recruitment minutes later (openKVStore would raise eventually, but
        # only on whichever worker happens to get a storage role)
        validate_storage_engine(KNOBS.STORAGE_ENGINE)
        # same contract for the resolver's conflict engine (jax-free check;
        # the device-count bound is enforced at engine construction)
        validate_conflict_config()
        self.process = process
        self.coordinators = coordinators
        self.capabilities = capabilities
        self.process_class = process_class
        self.roles: dict[str, object] = {}  # "proxy:3" -> role object
        process.register(Token.WORKER_PING, self._on_ping)
        process.register(Token.WORKER_INIT_ROLE, self._on_init_role)
        process.spawn(self._register_loop(), "workerRegister")
        # a rebooted process with storage files re-attaches the storage role
        # once the cluster controller can tell it the current log system
        # (worker.actor.cpp: storage servers restore from disk at startup)
        if any(name.startswith("storage-") for name in process.files):
            process.spawn(self._restore_storage(), "restoreStorage")
        # tlog DiskQueue files re-create their generations immediately
        # (TLogServer restorePersistentState): the next master must be able
        # to LOCK and peek the old generation, or a whole-cluster restart
        # wedges on "cannot lock enough old TLogs"
        tlog_uids = sorted({name[len("tlog-"):-len(".dq.0")]
                            for name in process.files
                            if name.startswith("tlog-")
                            and name.endswith(".dq.0")})
        if tlog_uids:
            from foundationdb_tpu_torch.server.tlog import TLogHost
            host = self.roles["tloghost"] = TLogHost(process)
            for uid in tlog_uids:
                host.add(uid=uid).recover_from_file()

    # -- liveness (waitFailureServer analogue) --

    def _on_ping(self, req, reply):
        # the incarnation (reboot count) lets a watcher distinguish "the
        # process is alive" from "the roles I recruited are still alive": a
        # rebooted worker answers pings but its roles died with the process
        reply.send(self.process.reboots)

    async def _register_loop(self):
        """Advertise to the current cluster controller (workerServer's
        registrationClient): repeats so a new CC learns every worker."""
        net = self.process.net
        while True:
            try:
                leader = await get_leader(self.process, self.coordinators)
                if leader:
                    net.one_way(self.process,
                                Endpoint(leader, Token.CC_REGISTER_WORKER),
                                RegisterWorkerRequest(
                                    address=self.process.address,
                                    roles=list(self.capabilities),
                                    process_class=self.process_class,
                                    zone_id=self.process.machine_id,
                                    machine_id=self.process.machine_id,
                                    dc_id=self.process.dc_id))
            except FDBError:
                pass
            await net.loop.delay(1.0)

    # -- recruitment (InitializeTLogRequest etc., worker.actor.cpp:694-794) --

    def _on_init_role(self, req: InitRoleRequest, reply):
        try:
            self._make_role(req.role, req.args)
            reply.send(InitRoleReply(address=self.process.address,
                                     incarnation=self.process.reboots))
        except Exception as e:  # noqa: BLE001 — recruiter sees the failure
            reply.send_error(FDBError("recruitment_failed", repr(e)))

    def _set_role(self, key: str, role):
        """A re-recruited role displaces its predecessor: shut the old one
        down so its background actors (lease pings etc.) don't leak."""
        old = self.roles.get(key)
        if old is not None and hasattr(old, "shutdown"):
            old.shutdown()
        self.roles[key] = role

    def _make_role(self, role: str, args: dict):
        if role == "master":
            from foundationdb_tpu_torch.server.master import Master
            self._set_role("master", Master(self.process, **args))
        elif role == "proxy":
            from foundationdb_tpu_torch.server.proxy import Proxy
            self._set_role(f"proxy:{args['proxy_id']}",
                           Proxy(self.process, **args))
        elif role == "grv_proxy":
            from foundationdb_tpu_torch.server.proxy import Proxy
            self._set_role(f"proxy:{args['proxy_id']}",
                           Proxy(self.process, grv_only=True, **args))
        elif role == "resolver":
            from foundationdb_tpu_torch.server.resolver import Resolver
            self._set_role("resolver", Resolver(self.process, **args))
        elif role == "ratekeeper":
            from foundationdb_tpu_torch.server.ratekeeper import Ratekeeper
            self._set_role("ratekeeper", Ratekeeper(self.process, **args))
        elif role == "tlog":
            from foundationdb_tpu_torch.server.tlog import TLogHost
            host = self.roles.get("tloghost")
            if host is None:
                host = self.roles["tloghost"] = TLogHost(self.process)
            host.add(uid=args["uid"],
                     recovery_version=args.get("recovery_version", 0))
        elif role == "logrouter":
            from foundationdb_tpu_torch.server.logrouter import LogRouter
            from foundationdb_tpu_torch.server.tlog import TLogHost
            host = self.roles.get("tloghost")
            if host is None:
                host = self.roles["tloghost"] = TLogHost(self.process)
            old = host.generations.get(args["uid"])
            if old is not None and hasattr(old, "shutdown"):
                old.shutdown()
            host.generations[args["uid"]] = LogRouter(
                self.process, uid=args["uid"], tags=args["tags"],
                epochs=args["epochs"], begin=args.get("begin", 0))
        elif role == "storage":
            from foundationdb_tpu_torch.server.storage import StorageServer
            self._set_role(f"storage:{args['tag']}",
                           StorageServer(self.process, **args))
        else:
            raise ValueError(f"unknown role {role!r}")

    async def _restore_storage(self):
        """Re-create the storage role from durable files after a reboot,
        binding it to the current log system from the CC's DBInfo."""
        net = self.process.net
        tags = sorted({int(name.split("-")[1].split(".")[0])
                       for name in self.process.files
                       if name.startswith("storage-")})
        while True:
            try:
                leader = await get_leader(self.process, self.coordinators)
                if leader:
                    info = await net.loop.timeout(net.request(
                        self.process, Endpoint(leader, Token.CC_GET_DBINFO),
                        None), 2.0)
                    if info.recovery_state == "accepting_commits":
                        from foundationdb_tpu_torch.server.storage import StorageServer
                        b = info.shard_boundaries
                        shard_tags = info.teams()
                        for tag in tags:
                            key = f"storage:{tag}"
                            if key in self.roles:
                                continue
                            # EVERY shard whose team includes this tag (a
                            # team can serve several shards after DD moves)
                            sranges = [
                                (b[i], b[i + 1] if i + 1 < len(b) else None)
                                for i, team in enumerate(shard_tags)
                                if tag in team]
                            if not sranges:
                                continue  # tag no longer in the layout
                            self.roles[key] = StorageServer(
                                self.process, tag=tag,
                                log_epochs=list(info.log_epochs),
                                recovery_count=info.epoch,
                                shard_ranges=sranges)
                        return
            except FDBError:
                pass
            await net.loop.delay(0.5)
