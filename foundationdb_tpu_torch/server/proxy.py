"""Proxy role: transaction front door — read versions and the commit pipeline.

Reference: fdbserver/MasterProxyServer.actor.cpp.

commitBatch (:321) runs one actor per batch through 5 explicitly-phased steps,
pipelined so batch N+1 resolves while batch N logs (the
latestLocalCommitBatchResolving / latestLocalCommitBatchLogging gates at
:364-366 and :426-428):

  1 pre-resolution: order on (batch-1) resolving; get a commit version from
    the master; split every txn's conflict ranges across resolvers by the
    keyResolvers range map (ResolutionRequestBuilder :240-318)
  2 resolution: release the resolving gate, wait all resolver replies (:420)
  3 post-resolution: order on (batch-1) logging; committed = min over the
    resolvers each txn touched (:492-504); substitute versionstamps; route
    mutations to storage tags by the shard map (:578-716)
  4 logging: push to TLogs, wait quorum (:835)
  5 replies: advance committedVersion, answer each txn (:862-898)

Read versions (GRV): transactionStarter (:985) batches requests and replies
with the last committed version — strict serializability comes from commits
being ordered, not from asking the master.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from foundationdb_tpu_torch.core import sim_validation
from foundationdb_tpu_torch.core.notified import NotifiedVersion
from foundationdb_tpu_torch.core.sim import Endpoint, SimProcess
from foundationdb_tpu_torch.ops.batch import (
    COMMITTED, CONFLICT, TOO_OLD, TxnConflictInfo)
from foundationdb_tpu_torch.server.interfaces import (
    CommitReply, CommitTransactionRequest, GetCommitVersionRequest,
    GetReadVersionReply, GetReadVersionRequest,
    ResolveTransactionBatchRequest, TLogCommitRequest, Token)
from foundationdb_tpu_torch.core.future import all_of
from foundationdb_tpu_torch.utils import keys as keylib
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS
from foundationdb_tpu_torch.utils.stats import CounterCollection, trace_counters_loop
from foundationdb_tpu_torch.utils.trace import g_trace_batch
from foundationdb_tpu_torch.utils.types import (
    Mutation, MutationType, make_versionstamp, substitute_versionstamp)


@dataclass
class ShardMap:
    """Key-range -> storage tag(s). Reference: the keyInfo range map the proxy
    keeps from \\xff/keyServers (ApplyMetadataMutation.h). Static for now;
    data distribution will mutate it transactionally later."""

    boundaries: list[bytes]  # sorted; shard i = [boundaries[i], boundaries[i+1])
    tags: list[list[int]]  # tags serving shard i (len = len(boundaries))

    def tags_for_key(self, key: bytes) -> list[int]:
        if len(self.boundaries) == 1:  # one shard: per-mutation hot path
            return self.tags[0]
        i = self._shard_of(key)
        return self.tags[i]

    def tags_for_range(self, begin: bytes, end: bytes) -> list[int]:
        out: set[int] = set()
        i = self._shard_of(begin)
        while i < len(self.boundaries):
            if i + 1 < len(self.boundaries) and self.boundaries[i + 1] <= begin:
                i += 1
                continue
            if self.boundaries[i] >= end:
                break
            out.update(self.tags[i])
            i += 1
        return sorted(out)

    def _shard_of(self, key: bytes) -> int:
        return keylib.partition_index(self.boundaries, key)

    def all_tags(self) -> list[int]:
        """Every storage tag serving any shard (the broadcast set for
        keyServers private mutations)."""
        out: set[int] = set()
        for team in self.tags:
            out.update(team)
        return sorted(out)


@dataclass
class ResolverMap:
    """Key-range -> resolver index (keyResolvers, MasterProxyServer:283-306)."""

    boundaries: list[bytes]
    endpoints: list[Endpoint]

    def split_ranges(self, ranges: list[tuple[bytes, bytes]]) -> dict[int, list[tuple[bytes, bytes]]]:
        """Partition conflict ranges among resolvers (clipped at boundaries)."""
        if len(self.boundaries) == 1:
            nonempty = [r for r in ranges if r[0] < r[1]]
            return {0: nonempty} if nonempty else {}
        out: dict[int, list[tuple[bytes, bytes]]] = {}
        n = len(self.boundaries)
        for b, e in ranges:
            if not (b < e):
                continue  # empty ranges conflict with nothing
            i = keylib.partition_index(self.boundaries, b)
            while i < n and self.boundaries[i] < e:
                lo = max(b, self.boundaries[i])
                hi = e if i + 1 >= n else min(e, self.boundaries[i + 1])
                if lo < hi:
                    out.setdefault(i, []).append((lo, hi))
                i += 1
        return out


class Proxy:
    def __init__(self, process: SimProcess, proxy_id: int, master: Endpoint,
                 resolvers: ResolverMap | None = None,
                 tlogs: list[Endpoint] | None = None,
                 shards: ShardMap | None = None, recovery_version: int = 0,
                 other_proxies: list[str] | None = None, epoch: int = 0,
                 ratekeeper: str | None = None, n_proxies: int = 1,
                 tlog_uids: list[str] | None = None,
                 die_on_failure: bool = False,
                 system_snapshot: list | None = None,
                 storages: list | None = None,
                 satellites: list[Endpoint] | None = None,
                 satellite_uids: list[str] | None = None,
                 validation_scope: str = "",
                 grv_only: bool = False):
        from foundationdb_tpu_torch.server import systemdata
        self.process = process
        self.loop = process.net.loop
        self.proxy_id = proxy_id
        # GRV-only proxies (the reference's grv_proxy role split,
        # GrvProxyServer.actor.cpp): serve read versions and nothing else, so
        # a client GRV storm stops queueing behind commit batches. They keep
        # the master lease and ratekeeper admission but carry no commit
        # pipeline, txn state, or log system.
        self.grv_only = grv_only
        # sim-only: which DATABASE this proxy belongs to, for the external-
        # consistency oracle — "" (the per-network global oracle, strongest:
        # it survives recoveries) unless several clusters share one sim
        self.validation_scope = validation_scope
        self.master = master
        self.epoch = epoch
        self.resolvers = resolvers
        self.tlogs = tlogs or []
        self.tlog_uids = tlog_uids or [""] * len(self.tlogs)
        # the ILogSystem seam (LogSystem.h:268): pushes fan out through it,
        # so a satellite log set (synchronously quorumed outside the primary
        # DC) slots in without touching the commit pipeline
        from foundationdb_tpu_torch.server.logsystem import LogSystem
        self.log_system = None if grv_only else LogSystem.from_endpoints(
            process, tlogs, uids=self.tlog_uids, satellites=satellites,
            satellite_uids=satellite_uids)
        # txnStateStore: the system keyspace subset this proxy caches,
        # seeded from the recovery snapshot (or synthesized from a directly
        # supplied ShardMap in statically-built clusters) and maintained by
        # metadata mutations flowing through the commit pipeline
        # (ApplyMetadataMutation.h; MasterProxyServer.actor.cpp:452-489)
        if grv_only:
            self.txn_state = None
            self.txn_state_version = recovery_version
            self.shards = None
            self.backup_ranges = []
        else:
            if system_snapshot is None:
                assert shards is not None, "need shards or system_snapshot"
                system_snapshot = systemdata.build_keyservers_snapshot(
                    shards.boundaries, shards.tags)
            self.txn_state = systemdata.TxnStateStore(system_snapshot)
            self.txn_state_version = recovery_version
            self.shards = self._shards_from_txn_state()
            self.backup_ranges = self._backup_ranges_from_txn_state()
        # newest version through which THIS proxy has applied state-mutation
        # windows — the last_receive ack sent to resolvers. Resolvers prune
        # retained state txns by the MIN ack over all proxies, so the ack's
        # contract is "everything <= V is applied here"; advancing it only
        # after phase-3 application (never at dispatch) means a failed batch
        # can never cause a window to be pruned before it was applied.
        self._last_applied_version = recovery_version
        # The recovery snapshot carries keyServers only; an in-flight
        # BACKUP's tee ranges live durably in the database. A recruited
        # proxy reads them from storage BEFORE accepting any commit (the
        # readTransactionSystemState analogue, masterserver.actor.cpp:597):
        # no client write can land in an un-teed gap across a recovery.
        self._storage_addr_of_tag = {t: a for a, t in (storages or [])}
        self._backup_seeded = storages is None or grv_only
        self._seed_task = None
        if not self._backup_seeded:
            self._seed_task = process.spawn(self._seed_backup_ranges(),
                                            "seedBackupRanges")
        self.other_proxies = [Endpoint(a, Token.PROXY_GET_COMMITTED_VERSION)
                              for a in (other_proxies or [])]
        # coalesced getLiveCommittedVersion: GRVs queue here and one peer
        # round serves everything queued when it starts
        self._confirm_waiters: list[tuple] = []
        self._confirm_running = False
        self._request_num = 0
        self._batch_n = 0
        self.latest_resolving = NotifiedVersion(0)  # batch numbers
        self.latest_logging = NotifiedVersion(0)
        self.committed_version = NotifiedVersion(recovery_version)
        self._pending: list[tuple[CommitTransactionRequest, object]] = []
        self._batcher_armed = False
        # adaptive batching state: smoothed commits-in rate keys the target
        # flush interval; pending byte count feeds the BYTES_MIN trigger
        self._pending_bytes = 0
        self._arrival_rate = 0.0
        self._last_arrival = self.loop.now()
        # bounded pipeline window: batches dispatched but not yet finished.
        # _try_flush defers when the window is full; the draining batch
        # re-flushes the deferred pending set when it completes.
        self._inflight_batches = 0
        self._flush_blocked = False
        self._master_last_seen = self.loop.now()
        self.stats = {"commits_in": 0, "committed": 0, "conflicts": 0, "too_old": 0}
        # latency bands + cross-process txn timeline probes (the reference's
        # ProxyStats LatencyBands and g_traceBatch CommitDebug events)
        from foundationdb_tpu_torch.utils.trace import LatencyBands
        self.commit_bands = LatencyBands(f"ProxyCommit{proxy_id}")
        self.grv_bands = LatencyBands(f"ProxyGRV{proxy_id}")
        self.counters = CounterCollection("Proxy", str(process.address))
        self._c_commits_in = self.counters.counter("TxnCommitIn")
        self._c_committed = self.counters.counter("TxnCommitted")
        self._c_conflicts = self.counters.counter("TxnConflicts")
        self._c_too_old = self.counters.counter("TxnTooOld")
        self._c_grv_in = self.counters.counter("GRVIn")
        self._c_throttled = self.counters.counter("TxnThrottled")
        self._c_batches = self.counters.counter("CommitBatches")
        self._c_mutation_bytes = self.counters.counter("MutationBytes")
        self._assembly_t0: float | None = None
        self._infra_failures = 0
        # suicide-on-pipeline-failure only makes sense when a cluster
        # controller exists to observe the death and rebuild the generation;
        # statically-built clusters retry instead (their topology heals)
        self.die_on_failure = die_on_failure
        self.dead = False
        # a GRV-only proxy registers no commit-path tokens. It still owns
        # the GRV/ping/metrics tokens, so recruitment places it on a worker
        # with no other proxy role; die() deregisters exactly what was
        # registered
        if grv_only:
            self._tokens = (Token.PROXY_GET_READ_VERSION, Token.PROXY_PING,
                            Token.PROXY_METRICS)
        else:
            self._tokens = (Token.PROXY_COMMIT, Token.PROXY_GET_READ_VERSION,
                            Token.PROXY_GET_COMMITTED_VERSION,
                            Token.PROXY_PING, Token.PROXY_METRICS)
            process.register(Token.PROXY_COMMIT, self._on_commit)
            process.register(Token.PROXY_GET_COMMITTED_VERSION,
                             self._on_get_committed_version)
        process.register(Token.PROXY_GET_READ_VERSION, self._on_grv)
        process.register(Token.PROXY_PING, self._on_proxy_ping)
        process.register(Token.PROXY_METRICS, self._on_metrics)
        self._counters_task = trace_counters_loop(process, self.counters)
        self._lease_task = process.spawn(self._master_lease_loop(), "masterLease")
        self._last_flush = self.loop.now()
        # idle empty batches (the reference's MAX_COMMIT_BATCH_INTERVAL
        # flush): commit versions advance with the clock at 1M/s, so if no
        # batch ever commits the committed version (and with it every new
        # read version) falls behind the resolvers' MVCC window and ALL
        # transactions become transaction_too_old — a livelock after any
        # multi-second outage. Empty batches keep the pipeline's committed
        # version moving whenever the proxy is idle. Managed (CC-recruited)
        # proxies only: in a static cluster a crashed-and-rebooted TLog
        # rejoins at its old version, and keepalive batches allocated during
        # the outage would leave it a permanent version-chain gap that only
        # a recovery (new generation) could clear.
        self._empty_task = None
        if die_on_failure and not grv_only:
            self._empty_task = process.spawn(self._empty_batch_loop(),
                                             "emptyBatch")
        # admission control (transactionStarter :985 + getRate :86): a token
        # bucket fed by the ratekeeper gates read-version handouts
        self.ratekeeper = ratekeeper
        self.n_proxies = n_proxies
        self._rk_tps: float | None = None
        self._grv_tokens = 1.0
        # contention throttling (docs/contention.md): hot ranges from the
        # ratekeeper's rate reply, each with its own release-rate token
        # bucket; commits touching an exhausted range are rejected with
        # transaction_throttled + a server-advised backoff
        self._throttles: list = []  # ThrottleEntry list, hottest first
        # (begin, end) -> [tokens, last_refill_time]
        self._throttle_buckets: dict = {}
        # deque: under throttle the line grows to thousands of waiters and
        # the pump pops from the front every tick — list.pop(0) would make
        # each handout O(queue)
        self._grv_queue: deque = deque()
        self._rk_tasks = []
        if ratekeeper is not None:
            self._rk_tasks = [
                process.spawn(self._rk_fetch_loop(), "getRate"),
                process.spawn(self._grv_pump(), "transactionStarter")]
        # native GRV fast path (NET_NATIVE_TRANSPORT): a single-proxy
        # topology needs no getLiveCommittedVersion peer round, so GRVs can
        # be answered entirely inside the C transport plane from a pushed
        # (version, allowance) pair. Multi-proxy and grv_only topologies
        # must confirm with peers and always fall through to Python. The
        # native path skips grv_bands and the sim validation oracle — both
        # are inert on the real event loop where the plane runs.
        self._native_grv = False
        self._native_grv_hits = 0
        native_table = getattr(process.net, "native_table", None)
        if (native_table is not None and not grv_only
                and not self.other_proxies
                and getattr(process.net, "_native_grv_owner", None) is None):
            from foundationdb_tpu_torch.net import native_transport
            native_table.enable_grv(*native_transport.grv_wire_ids())
            process.net._native_grv_owner = self
            self._native_grv = True
            self._native_grv_refresh()
        # periodic telemetry dump (the reference's traceCounters cadence):
        # bands are useless if never emitted
        self._bands_task = process.spawn(self._trace_bands_loop(),
                                         "latencyBands")

    def shutdown(self):
        """Displaced by a newer generation on the same worker."""
        self._lease_task.cancel()
        self._bands_task.cancel()
        self._counters_task.cancel()
        if self._seed_task is not None:
            self._seed_task.cancel()
        if self._empty_task is not None:
            self._empty_task.cancel()
        for t in self._rk_tasks:
            t.cancel()
        if self._native_grv:
            self._native_grv = False
            self.process.net.native_table.disable_grv()
            if getattr(self.process.net, "_native_grv_owner", None) is self:
                self.process.net._native_grv_owner = None
        self._master_last_seen = float("-inf")  # fence immediately
        queued, self._grv_queue = self._grv_queue, deque()
        for reply, _n in queued:  # don't strand throttled waiters until timeout
            reply.send_error(FDBError("cluster_not_fully_recovered",
                                      "proxy shut down"))

    def _on_proxy_ping(self, req, reply):
        reply.send(self.epoch)

    def _on_metrics(self, req, reply):
        from foundationdb_tpu_torch.utils.stats import fold_transport_counters
        snap = self.counters.as_dict()
        snap["CommittedVersion"] = self.committed_version.get()
        snap["GRVQueueDepth"] = sum(n for _r, n in self._grv_queue)
        reply.send(fold_transport_counters(self.process, snap))

    def _shards_from_txn_state(self) -> ShardMap:
        """Derive the routing map (keyInfo) from \\xff/keyServers in the
        txnStateStore (ApplyMetadataMutation.h keyInfo maintenance)."""
        from foundationdb_tpu_torch.server import systemdata
        items = self.txn_state.get_range(systemdata.KEY_SERVERS_PREFIX,
                                         systemdata.KEY_SERVERS_END)
        boundaries, teams = systemdata.parse_keyservers(items)
        assert boundaries and boundaries[0] == b"", \
            "keyServers must cover the keyspace from b''"
        return ShardMap(boundaries=boundaries, tags=teams)

    def _apply_metadata(self, mutations, version: int):
        """Fold committed metadata mutations into the txnStateStore and
        refresh the routing map if keyServers changed."""
        from foundationdb_tpu_torch.backup import agent as backup_agent
        from foundationdb_tpu_torch.server import systemdata
        touched_ks = False
        touched_br = False
        for m in mutations:
            self.txn_state.apply(m)
            touched_ks |= systemdata.mutation_overlaps(
                m, systemdata.KEY_SERVERS_PREFIX, systemdata.KEY_SERVERS_END)
            touched_br |= systemdata.mutation_overlaps(
                m, backup_agent.RANGES_PREFIX, backup_agent.RANGES_END)
        if touched_ks:
            self.shards = self._shards_from_txn_state()
        if touched_br:
            self.backup_ranges = self._backup_ranges_from_txn_state()
        self.txn_state_version = max(self.txn_state_version, version)

    async def _seed_backup_ranges(self):
        """Read \\xff/backupRanges from durable storage into the
        txnStateStore; commits are rejected until this lands (bounded only
        by storage catch-up, which recovery requires anyway)."""
        from foundationdb_tpu_torch.backup import agent as backup_agent
        from foundationdb_tpu_torch.server.interfaces import (
            GetKeyValuesRequest, KeySelector)
        team = self.shards.tags_for_key(backup_agent.RANGES_PREFIX)
        while True:
            for tag in team:
                addr = self._storage_addr_of_tag.get(tag)
                if addr is None:
                    continue
                read_version = self.committed_version.get()
                try:
                    reply = await self.loop.timeout(self.process.net.request(
                        self.process,
                        Endpoint(addr, Token.STORAGE_GET_KEY_VALUES),
                        GetKeyValuesRequest(
                            begin=KeySelector.first_greater_or_equal(
                                backup_agent.RANGES_PREFIX),
                            end=KeySelector.first_greater_or_equal(
                                backup_agent.RANGES_END),
                            version=read_version)), 3.0)
                    if self.txn_state_version > read_version:
                        # a metadata txn (possibly a backup stop clearing
                        # these very ranges, committed via another proxy)
                        # was applied while the read was in flight; applying
                        # the stale snapshot would resurrect cleared rows —
                        # re-read at a newer version
                        continue
                    for k, v in reply.data:
                        self.txn_state.set(k, v)
                    self.backup_ranges = self._backup_ranges_from_txn_state()
                    self._backup_seeded = True
                    return
                except FDBError as e:
                    if e.name == "operation_cancelled":
                        raise
            await self.loop.delay(0.5)

    def _backup_ranges_from_txn_state(self) -> list[tuple[bytes, bytes]]:
        """Ranges the proxy tees into \\xff/blog (vecBackupKeys analogue)."""
        from foundationdb_tpu_torch.backup import agent as backup_agent
        return [(k[len(backup_agent.RANGES_PREFIX):], v)
                for k, v in self.txn_state.get_range(
                    backup_agent.RANGES_PREFIX, backup_agent.RANGES_END)]

    def die(self, reason: str):
        """The reference's commit-path contract: a proxy whose pipeline keeps
        failing (resolver or TLog unreachable) dies, the master/CC observes
        the death, and a recovery rebuilds the generation — the failure is
        never allowed to smolder as endless commit_unknown_result."""
        if self.dead:
            return
        self.dead = True
        from foundationdb_tpu_torch.utils.trace import TraceEvent
        TraceEvent("ProxyDied", self.process.address) \
            .detail("Reason", reason).detail("Epoch", self.epoch).log()
        for token in self._tokens:
            self.process.deregister(token)
        self.shutdown()

    async def _trace_bands_loop(self):
        while True:
            await self.loop.delay(30.0)
            if self.commit_bands.total:
                self.commit_bands.trace()
            if self.grv_bands.total:
                self.grv_bands.trace()

    async def _empty_batch_loop(self):
        interval = KNOBS.COMMIT_BATCH_IDLE_INTERVAL
        while True:
            await self.loop.delay(interval)
            if (self.loop.now() - self._last_flush >= interval
                    and not self._pending and self._master_live()
                    and self._inflight_batches < self._window()):
                self._flush()

    def _native_grv_refresh(self):
        """Push (committed version, handout allowance) to the C GRV plane.

        Called at every committed-version advance, pump tick, and lease
        ping, so the plane never holds a version more than one tick stale
        and stops cold (allowance 0) the moment the master lease dies or
        ratekeeper-gated requests start queueing. GRVs the plane served
        since the last refresh are folded into GRVIn and spent from the
        same token bucket the Python path draws from."""
        if not self._native_grv:
            return
        table = self.process.net.native_table
        hits = table.counters()["NativeGRVHits"]
        delta = hits - self._native_grv_hits
        self._native_grv_hits = hits
        if delta:
            # the C plane spends the request's batched count field, so
            # NativeGRVHits counts TRANSACTIONS (not wire flushes) and the
            # delta folds 1:1 against the same token bucket the Python
            # path draws from.
            self._c_grv_in.increment(delta)
            if self._rk_tps is not None:
                self._grv_tokens = max(0.0, self._grv_tokens - delta)
        if not self._master_live() or self._grv_queue:
            allowance = 0
        elif self._rk_tps is None:
            allowance = 1_000_000  # ungated: refreshed every lease ping
        else:
            allowance = max(0, int(self._grv_tokens))
        table.set_grv(self.committed_version.get(), allowance)

    # -- admission control --

    async def _rk_fetch_loop(self):
        ep = Endpoint(self.ratekeeper, Token.RK_GET_RATE)
        while True:
            try:
                r = await self.loop.timeout(self.process.net.request(
                    self.process, ep, self.n_proxies), 1.0)
                self._rk_tps = r.tps
                self._set_throttles(getattr(r, "throttles", None) or [])
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise
            await self.loop.delay(KNOBS.RK_UPDATE_INTERVAL)

    def _set_throttles(self, entries: list):
        """Install the ratekeeper's throttle list, carrying over the token
        bucket of any range that stays throttled (a fresh bucket every rate
        reply would hand hot ranges a free burst each RK interval)."""
        now = self.loop.now()
        buckets = {}
        for t in entries:
            key = (t.begin, t.end)
            prev = self._throttle_buckets.get(key)
            buckets[key] = prev if prev is not None else [1.0, now]
        self._throttles = entries
        self._throttle_buckets = buckets

    def _throttle_check(self, req: CommitTransactionRequest):
        """Return the ThrottleEntry that rejects this commit, or None to
        admit it. A commit touching a throttled range must spend one token
        from that range's release-rate bucket (refilled lazily, capped at a
        one-second burst)."""
        if not self._throttles:
            return None
        now = self.loop.now()
        for t in self._throttles:
            hit = False
            for begin, end in req.write_conflict_ranges:
                if begin < t.end and t.begin < end:
                    hit = True
                    break
            if not hit:
                continue
            bucket = self._throttle_buckets[(t.begin, t.end)]
            tokens, last = bucket
            tokens = min(tokens + (now - last) * t.release_tps,
                         max(1.0, t.release_tps))
            bucket[1] = now
            if tokens >= 1.0:
                bucket[0] = tokens - 1.0
                continue  # admitted through this range's budget
            bucket[0] = tokens
            return t
        return None

    async def _grv_pump(self):
        interval = 0.05
        while True:
            await self.loop.delay(interval)
            if self._rk_tps is not None:
                burst = max(1.0, self._rk_tps * 0.2)
                self._grv_tokens = min(self._grv_tokens
                                       + self._rk_tps * interval, burst)
            self._native_grv_refresh()
            while self._grv_queue and self._grv_tokens >= 1.0:
                reply, n = self._grv_queue.popleft()
                self._grv_tokens -= n  # may overdraw; refill repays at tps
                # the lease can expire while a request waits in line; serving
                # it anyway would hand out a deposed generation's stale
                # committed version past the recovery grace period
                if self._master_live():
                    self._serve_grv(reply)
                else:
                    reply.send_error(FDBError("cluster_not_fully_recovered",
                                              "proxy lost its master"))

    # -- master liveness lease --
    # A proxy whose master is unreachable (dead, or replaced by a recovery)
    # must stop serving read versions: a deposed generation handing out its
    # stale committedVersion would let clients read snapshots that miss the
    # new generation's commits. The reference gets this from the proxy's
    # failure-monitored registration with the master; here it is an explicit
    # ping lease.

    def _master_live(self) -> bool:
        return (self.loop.now() - self._master_last_seen
                < KNOBS.PROXY_MASTER_LEASE_SECONDS)

    async def _master_lease_loop(self):
        ping = Endpoint(self.master.address, Token.MASTER_PING)
        while True:
            try:
                epoch = await self.loop.timeout(
                    self.process.net.request(self.process, ping, None), 1.0)
                if epoch == self.epoch:
                    self._master_last_seen = self.loop.now()
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise
            self._native_grv_refresh()
            await self.loop.delay(KNOBS.PROXY_MASTER_LEASE_SECONDS / 4)

    # -- GRV service --

    def _on_get_committed_version(self, req, reply):
        reply.send(self.committed_version.get())

    def _on_grv(self, req: GetReadVersionRequest, reply):
        if not self._master_live():
            reply.send_error(FDBError("cluster_not_fully_recovered",
                                      "proxy lost its master"))
            return
        # batched fan-in: the client's GRV batcher coalesces N transactions
        # into one wire request carrying count=N (the reference's
        # transactionCount), so the ratekeeper budget is spent in
        # TRANSACTIONS — one flush of 20 waiters costs 20 tokens, not 1 —
        # while the peer confirm rounds downstream stay O(rounds)
        n = max(1, int(getattr(req, "count", 1) or 1))
        self._c_grv_in.increment(n)
        if self._rk_tps is not None:
            # ratekeeper-gated: spend tokens or wait in line. Admission is
            # head-of-line at >= 1 token with the spend allowed to overdraw
            # (the pump refills at tps), so a flush larger than the burst
            # can never starve behind it.
            if not self._grv_queue and self._grv_tokens >= 1.0:
                self._grv_tokens -= n
                self._serve_grv(reply)
            else:
                self._grv_queue.append((reply, n))
            return
        self._serve_grv(reply)

    def _serve_grv(self, reply):
        floor = sim_validation.of(self.process.net,
                                  self.validation_scope).debug_grv_floor()
        if not self.other_proxies:
            self.grv_bands.add(0.0)
            v = self.committed_version.get()
            sim_validation.of(
                self.process.net, self.validation_scope).debug_check_read_version(
                v, floor, self.process.address)
            reply.send(GetReadVersionReply(version=v))
            return
        self._confirm_waiters.append((reply, floor))
        if not self._confirm_running:
            self._confirm_running = True
            self.process.spawn(self._grv_confirm_loop(),
                               "getLiveCommittedVersion")

    async def _grv_confirm_loop(self):
        """getLiveCommittedVersion (:935): a correct read version is >= every
        commit any proxy has acknowledged, so take the max over all proxies.
        Rounds are COALESCED (GrvProxyServer's batched version fetch): one
        peer round serves every GRV queued when it starts, so peer RPC
        volume is O(rounds), not O(GRVs) x O(proxies) — at a few thousand
        GRVs/s the per-request fan-out is what made multi-proxy topologies
        pay for their second proxy. A GRV arriving mid-round waits for the
        next round: its version must come from a fetch started after it
        arrived, or acks landing during the round could be missed."""
        try:
            while self._confirm_waiters:
                waiters, self._confirm_waiters = self._confirm_waiters, []
                t0 = self.loop.now()
                try:
                    others = await all_of([
                        self.process.net.request(self.process, ep, None)
                        for ep in self.other_proxies])
                except FDBError as e:
                    for reply, _ in waiters:
                        reply.send_error(FDBError(e.name, e.detail))
                    if e.name == "operation_cancelled":
                        raise
                    continue
                version = max([self.committed_version.get()] + others)
                self.grv_bands.add(self.loop.now() - t0)
                # external consistency oracle: >= every commit acked before
                # the GRV arrived (debug_checkMinCommittedVersion)
                val = sim_validation.of(self.process.net, self.validation_scope)
                for reply, floor in waiters:
                    val.debug_check_read_version(version, floor,
                                                 self.process.address)
                    reply.send(GetReadVersionReply(version=version))
        finally:
            self._confirm_running = False

    # -- commit batching (queueTransactionStartRequests/batcher pattern) --

    def _on_commit(self, req: CommitTransactionRequest, reply):
        if not self._master_live():
            reply.send_error(FDBError("cluster_not_fully_recovered",
                                      "proxy lost its master"))
            return
        if not self._backup_seeded:
            reply.send_error(FDBError("cluster_not_fully_recovered",
                                      "proxy still seeding txn state"))
            return
        self.stats["commits_in"] += 1
        self._c_commits_in.increment()
        t = self._throttle_check(req)
        if t is not None:
            self._c_throttled.increment()
            # detail is the informed-backoff contract (utils/errors.py):
            # "<advised_backoff> <begin_hex> <end_hex>"
            reply.send_error(FDBError(
                "transaction_throttled",
                f"{t.backoff:.6f} {t.begin.hex()} {t.end.hex()}"))
            return
        now_t = self.loop.now()
        # smoothed commits-in rate (the commitBatcher's lastBatchIntervalRate
        # feedback, collapsed to an explicit EWMA over interarrival gaps so
        # the adaptive interval is a pure function of sim-deterministic state)
        dt = max(now_t - self._last_arrival, 1e-6)
        self._last_arrival = now_t
        alpha = KNOBS.COMMIT_BATCH_RATE_SMOOTHING
        self._arrival_rate += alpha * (1.0 / dt - self._arrival_rate)
        if not self._pending:
            self._assembly_t0 = now_t  # batch-assembly span start
        self._pending.append((req, reply, now_t))
        self._pending_bytes += sum(len(m.param1) + len(m.param2)
                                   for m in req.mutations)
        if (len(self._pending) >= KNOBS.COMMIT_TRANSACTION_BATCH_COUNT_MAX
                or self._pending_bytes
                >= KNOBS.COMMIT_TRANSACTION_BATCH_BYTES_MIN):
            self._try_flush()
        elif not self._batcher_armed:
            self._batcher_armed = True
            self.process.spawn(self._batch_timer(), "commitBatcher")

    def _target_interval(self) -> float:
        """Arrival-rate-keyed flush interval: light load flushes at
        INTERVAL_MIN (latency), and the interval slides linearly toward
        INTERVAL_MAX as the smoothed rate approaches RATE_SATURATION
        (amortizing per-batch pipeline cost under heavy load). The rate
        is keyed CLUSTER-wide (per-proxy rate x pool size): the
        per-batch downstream cost (master version fetch, resolver
        dispatch, tlog push) lands on shared singleton roles, so a proxy
        in a pool of n seeing 1/n of the load must batch as if it saw
        the whole cluster's — otherwise fan-out re-fragments batches and
        the shared roles pay n-fold per-batch overhead (the JAX
        package's bench saw that fan-out collapse with 2 proxies).
        The CAP stays at INTERVAL_MAX regardless of pool size: clients
        run closed-loop against an admission budget, so commit
        throughput is in-flight/latency and a stretched flush wait is
        repaid as lost throughput, not saved work."""
        lo = KNOBS.COMMIT_TRANSACTION_BATCH_INTERVAL_MIN
        hi = KNOBS.COMMIT_TRANSACTION_BATCH_INTERVAL_MAX
        if hi <= lo:
            return lo
        n = max(1, self.n_proxies)
        sat = max(1e-9, KNOBS.COMMIT_BATCH_RATE_SATURATION)
        return lo + (hi - lo) * min(1.0, n * self._arrival_rate / sat)

    async def _batch_timer(self):
        await self.loop.delay(self._target_interval())
        self._batcher_armed = False
        if self._pending:
            self._try_flush()

    def _window(self) -> int:
        # COMMIT_PIPELINE_DEPTH bounds concurrent version batches through
        # the SHARED master→resolver→tlog pipeline, so it is divided across
        # the commit-proxy pool: n proxies each running the full depth would
        # run n x DEPTH interleaved batches downstream, and every extra
        # concurrent batch is another version-order wait at the resolvers
        # and tlogs.
        return max(1, KNOBS.COMMIT_PIPELINE_DEPTH // max(1, self.n_proxies))

    def _try_flush(self):
        """Flush unless the pipeline window is full; a deferred flush is
        re-attempted when the draining batch completes."""
        if not self._pending:
            return
        if self._inflight_batches >= self._window():
            self._flush_blocked = True
            return
        self._flush()

    def _flush(self):
        batch, self._pending = self._pending, []
        self._pending_bytes = 0
        self._flush_blocked = False
        self._batch_n += 1
        self._inflight_batches += 1
        self._last_flush = self.loop.now()
        self._c_batches.increment()
        # the assembly span's begin time predates the batch id, so both
        # records are emitted here with explicit timestamps
        bid = f"b{self.proxy_id}.{self._batch_n}"
        t_arrival = self._assembly_t0
        if batch and t_arrival is not None:
            g_trace_batch.span_begin("CommitSpan", bid, "Proxy.BatchAssembly",
                                     at=t_arrival)
            g_trace_batch.span_end("CommitSpan", bid, "Proxy.BatchAssembly",
                                   at=self._last_flush)
        self._assembly_t0 = None
        self.process.spawn(
            self._commit_batch(self._batch_n, batch, t_arrival), "commitBatch")

    def _batch_done(self):
        """Pipeline-window bookkeeping: a finished batch frees a slot and
        drains any flush that deferred while the window was full."""
        self._inflight_batches -= 1
        if self._flush_blocked:
            self._try_flush()

    def _band_replies(self, t_ins):
        """Record commit latency per request, from RECEIPT (including the
        batcher queueing delay) to reply — the reference's
        commitLatencyBands measures the same residency."""
        now = self.loop.now()
        for t0 in t_ins:
            self.commit_bands.add(now - t0)

    # -- the 5-phase pipeline --

    async def _commit_batch(self, batch_n: int, batch,
                            t_arrival: float | None = None):
        requests = [req for req, _rep, _t in batch]
        replies = [rep for _req, rep, _t in batch]
        t_ins = [t for _req, _rep, t in batch]
        resolution_started = False
        state_applied = False
        version_assigned = False
        push_initiated = False
        batch_meta: list[list | None] = []  # per request
        bid = f"b{self.proxy_id}.{batch_n}"
        now = self.loop.now
        # stage spans left open by a failed batch are closed in the except
        # handler, so the span stream stays well-formed on every path
        open_spans: list[str] = []

        def _sb(span: str):
            open_spans.append(span)
            g_trace_batch.span_begin("CommitSpan", bid, span, at=now())

        def _se(span: str):
            open_spans.remove(span)
            g_trace_batch.span_end("CommitSpan", bid, span, at=now())

        g_trace_batch.add_event("CommitDebug", bid,
                                "Proxy.commitBatch.Before", at=now())
        for req in requests:
            if req.debug_id:  # stitch the client's commit span to this batch
                g_trace_batch.add_attach("CommitAttach", req.debug_id, bid,
                                         at=now())
        try:
            # ---- Phase 1: pre-resolution (:363) ----
            await self.latest_resolving.when_at_least(batch_n - 1)
            # queueing made visible: arrival of the batch's first request →
            # pipeline dispatch (batcher wait + window admission + resolving
            # gate). Both records carry explicit timestamps, emitted here so
            # a batch that never passes the gate emits no dangling begin.
            if requests and t_arrival is not None:
                g_trace_batch.span_begin("CommitSpan", bid,
                                         "Proxy.QueueDelay", at=t_arrival)
                g_trace_batch.span_end("CommitSpan", bid,
                                       "Proxy.QueueDelay", at=now())
            _sb("Proxy.GetCommitVersion")
            self._request_num += 1
            # RETRY the version fetch with the SAME request_num until the
            # master answers (it dedupes retransmits :834-843): a timed-out
            # fetch still ASSIGNED the version on the master, and abandoning
            # it would leave a permanent gap in the resolvers' prevVersion
            # chain that wedges every later batch
            req = GetCommitVersionRequest(self.proxy_id, self._request_num,
                                          self.epoch)
            ver = None
            while ver is None:
                try:
                    ver = await self.process.net.request(
                        self.process, self.master, req)
                except FDBError as e:
                    if e.name in ("operation_cancelled",
                                  "master_recovery_failed"):
                        raise  # cancelled, or fenced by a newer generation
                    if not self._master_live():
                        raise  # master gone: recovery will replace us
                    await self.loop.delay(0.2)
            commit_version, prev_version = ver.version, ver.prev_version
            version_assigned = True
            _se("Proxy.GetCommitVersion")
            # stitch the batch to its commit version: resolver + tlog spans
            # downstream carry v<version> idents
            g_trace_batch.add_attach("CommitAttach", bid,
                                     f"v{commit_version}", at=now())

            from foundationdb_tpu_torch.server import systemdata
            n_res = len(self.resolvers.endpoints)
            # per-resolver transaction lists + mapping back (transactionResolverMap)
            res_txns: list[list[TxnConflictInfo]] = [[] for _ in range(n_res)]
            txn_resolver_slots: list[list[tuple[int, int]]] = []
            # state txns registered with EVERY resolver; mutations ride only
            # in resolver 0's request (ResolutionRequestBuilder :307-311)
            state_idx: list[list[int]] = [[] for _ in range(n_res)]
            state_muts: list[list[list]] = [[] for _ in range(n_res)]
            sys_prefix = systemdata.SYSTEM_PREFIX
            for req in requests:
                # cheap prefilter: a mutation can only touch the system
                # keyspace if one of its params sorts at/after \xff (covers
                # point keys AND clear-range ends), so ordinary traffic
                # skips the full is_metadata_mutation call entirely
                meta = [m for m in req.mutations
                        if (m.param1 >= sys_prefix or m.param2 >= sys_prefix)
                        and systemdata.is_metadata_mutation(m)]
                batch_meta.append(meta or None)
                if n_res == 1 and not meta:
                    # single resolver, no state txn: the split is the
                    # identity and the slot list is one entry
                    txn_resolver_slots.append([(0, len(res_txns[0]))])
                    res_txns[0].append(TxnConflictInfo(
                        read_snapshot=req.read_snapshot,
                        read_ranges=[r for r in req.read_conflict_ranges
                                     if r[0] < r[1]],
                        write_ranges=[r for r in req.write_conflict_ranges
                                      if r[0] < r[1]]))
                    continue
                split_r = self.resolvers.split_ranges(req.read_conflict_ranges)
                split_w = self.resolvers.split_ranges(req.write_conflict_ranges)
                touched = set(split_r) | set(split_w)
                if meta:
                    touched |= set(range(n_res))
                touched = sorted(touched) or [0]
                slots = []
                for r in touched:
                    idx = len(res_txns[r])
                    slots.append((r, idx))
                    res_txns[r].append(TxnConflictInfo(
                        read_snapshot=req.read_snapshot,
                        read_ranges=split_r.get(r, []),
                        write_ranges=split_w.get(r, [])))
                    if meta:
                        state_idx[r].append(idx)
                        state_muts[r].append(meta if r == 0 else [])
                txn_resolver_slots.append(slots)

            # ack only APPLIED windows (see _last_applied_version): an older
            # ack just widens the reply window, and already-applied versions
            # are skipped below — so dispatch needn't wait on the previous
            # batch's phase 3 and resolution stays pipelined
            last_receive = self._last_applied_version
            _sb("Proxy.Resolve")
            resolve_futures = [
                self.process.net.request(
                    self.process, self.resolvers.endpoints[r],
                    ResolveTransactionBatchRequest(
                        prev_version=prev_version, version=commit_version,
                        last_receive_version=last_receive,
                        transactions=res_txns[r],
                        proxy_id=self.proxy_id,
                        state_txn_indices=state_idx[r],
                        state_txn_mutations=state_muts[r]))
                for r in range(n_res)]

            # ---- Phase 2: resolution (:419) ----
            resolution_started = True
            self.latest_resolving.set(batch_n)  # pipelining gate (:417)
            g_trace_batch.add_event(
                "CommitDebug", bid,
                "Proxy.commitBatch.GettingCommitVersion", at=now())
            resolutions = await all_of(resolve_futures)
            _se("Proxy.Resolve")
            g_trace_batch.add_event(
                "CommitDebug", bid,
                "Proxy.commitBatch.AfterResolution", at=now())

            # ---- Phase 3: post-resolution (:425) ----
            await self.latest_logging.when_at_least(batch_n - 1)
            # tag set BEFORE this batch's metadata lands: a keyServers
            # change must also reach the tags it REMOVES (they fence
            # themselves on it — see the broadcast in the routing loop),
            # and those can be absent from the post-apply map
            pre_move_tags = set(self.shards.all_tags())
            # FIRST: other proxies' metadata txns from the resolver replies,
            # in version order, global verdict = AND over all resolvers'
            # local verdicts (MasterProxyServer.actor.cpp:452-489). This must
            # precede routing so every batch with version > V routes with
            # the map produced by the metadata committed at V — the fence
            # property data distribution relies on.
            aligned = [dict(r.state_mutations or []) for r in resolutions]
            relevant = [set(v for v in d if v > self.txn_state_version)
                        for d in aligned]
            if any(s != relevant[0] for s in relevant[1:]):
                # resolvers disagree about WHICH versions carried state txns
                # (e.g. one lost its retained window across a partial
                # restart): guessing would fork this proxy's txnStateStore
                # from its peers' — fatal, in either direction
                raise FDBError(
                    "internal_error",
                    f"resolver state windows diverge: "
                    f"{[sorted(s) for s in relevant]}")
            for version, entries0 in (resolutions[0].state_mutations or []):
                if version <= self.txn_state_version:
                    continue  # already applied (overlapping window)
                for r in range(1, n_res):
                    if len(aligned[r][version]) != len(entries0):
                        raise FDBError(
                            "internal_error",
                            f"resolver state windows diverge at {version}")
                for i, (c0, muts) in enumerate(entries0):
                    committed = c0 and all(
                        aligned[r][version][i][0] for r in range(1, n_res))
                    if committed:
                        self._apply_metadata(muts, version)
            state_applied = True

            if n_res == 1:
                # one slot per txn, appended in request order
                committed0 = resolutions[0].committed
                statuses = [committed0[slots[0][1]]
                            for slots in txn_resolver_slots]
            else:
                statuses = []
                for slots in txn_resolver_slots:
                    # committed iff every touched resolver says committed
                    # (:492-504)
                    s = min(resolutions[r].committed[i] for r, i in slots)
                    statuses.append(s)

            # own batch's committed metadata txns — ALL applied before any
            # mutation is routed (:540 precedes the routing loop :578), so
            # the whole batch routes with the map its own metadata produced
            for status, meta in zip(statuses, batch_meta):
                if status == COMMITTED and meta:
                    self._apply_metadata(meta, commit_version)
            # every state window <= commit_version is now applied here:
            # phase 3 runs in batch order (latest_logging gate), this reply
            # covered (last_receive, commit_version), and own metadata just
            # landed — so future batches may ack through commit_version
            self._last_applied_version = max(self._last_applied_version,
                                             commit_version)

            messages: dict[int, list[Mutation]] = {}
            batch_order = 0
            mutation_bytes = 0
            blog: list[Mutation] = []  # backup tee (:664-776)
            # per-mutation loop: hoist attribute lookups and skip the
            # backup scan when no backup ranges are registered
            tags_for_range = self.shards.tags_for_range
            tags_for_key = self.shards.tags_for_key
            backup_ranges = self.backup_ranges
            ks_prefix = systemdata.KEY_SERVERS_PREFIX
            ks_tags: list[int] | None = None  # built lazily (moves are rare)
            clear_t = MutationType.CLEAR_RANGE
            vs_key = MutationType.SET_VERSIONSTAMPED_KEY
            vs_val = MutationType.SET_VERSIONSTAMPED_VALUE
            for req, status in zip(requests, statuses):
                if status != COMMITTED:
                    continue
                stamp = make_versionstamp(commit_version, batch_order)
                batch_order += 1
                for m in req.mutations:
                    mt = m.type
                    if mt == vs_key or mt == vs_val:
                        m = self._substitute(m, stamp)
                        mt = m.type
                    mutation_bytes += len(m.param1) + len(m.param2)
                    if m.param1 >= sys_prefix and m.param1.startswith(ks_prefix):
                        # keyServers changes BROADCAST to every storage tag,
                        # old teams included (ApplyMetadataMutation's private
                        # serverKeys mutations): each server sees the team
                        # change in its OWN tag stream at the commit version,
                        # so shard revocation is fenced by the version stream
                        # itself instead of racing the DD layout push — the
                        # race that let an old owner serve stale reads at
                        # post-move versions (storage._apply_shard_private)
                        if ks_tags is None:
                            ks_tags = sorted(
                                pre_move_tags.union(self.shards.all_tags()))
                        tags = ks_tags
                    elif mt == clear_t:
                        tags = tags_for_range(m.param1, m.param2)
                    else:
                        tags = tags_for_key(m.param1)
                    for t in tags:
                        lst = messages.get(t)
                        if lst is None:
                            lst = messages[t] = []
                        lst.append(m)
                    if backup_ranges:
                        for rb_, re_ in backup_ranges:
                            if systemdata.mutation_overlaps(m, rb_, re_):
                                blog.append(m)
                                break
            self._c_mutation_bytes.increment(mutation_bytes)
            if blog:
                # tee into \xff/blog/<version><seq> INSIDE the same batch:
                # the log row commits atomically with the data it records
                from foundationdb_tpu_torch.backup.agent import blog_key
                from foundationdb_tpu_torch.utils import wire as wirelib
                for seq in range(0, len(blog), 50):
                    bm = Mutation(
                        MutationType.SET_VALUE,
                        blog_key(commit_version, seq),
                        wirelib.dumps(blog[seq:seq + 50]))
                    for t in self.shards.tags_for_key(bm.param1):
                        messages.setdefault(t, []).append(bm)

            # ---- Phase 4: logging (:835) ----
            # push through the log system: per-set quorum (primary
            # N - antiquorum, plus every satellite set's own quorum)
            _sb("Proxy.TLogPush")
            push_f = self.log_system.push(
                prev_version, commit_version, messages,
                self.committed_version.get())
            push_initiated = True
            # release the logging gate at push INITIATION, not completion
            # (the reference releases latestLocalCommitBatchLogging before
            # waiting on the push, :426/:835): the TLogs order concurrent
            # pushes on the prevVersion chain themselves and dedupe replays,
            # so batch N+1 may route and push while this push is in flight —
            # without this, every push serializes behind the previous one's
            # network round trip and the batcher idles. Max-set because a
            # LATER batch that failed early already max-set past batch_n in
            # its except handler; a plain set would throw here.
            self.latest_logging.set(max(self.latest_logging.get(), batch_n))
            await push_f
            _se("Proxy.TLogPush")

            # ---- Phase 5: replies (:862) ----
            g_trace_batch.add_event(
                "CommitDebug", bid,
                "Proxy.commitBatch.AfterLogPush", at=now())
            _sb("Proxy.Reply")
            self._band_replies(t_ins)
            self._infra_failures = 0
            if commit_version > self.committed_version.get():
                self.committed_version.set(commit_version)
                self._native_grv_refresh()
            acked_any = False
            for rep, status in zip(replies, statuses):
                if status == COMMITTED:
                    self.stats["committed"] += 1
                    self._c_committed.increment()
                    acked_any = True
                    rep.send(CommitReply(version=commit_version))
                elif status == TOO_OLD:
                    self.stats["too_old"] += 1
                    self._c_too_old.increment()
                    rep.send_error(FDBError("transaction_too_old"))
                else:
                    self.stats["conflicts"] += 1
                    self._c_conflicts.increment()
                    rep.send_error(FDBError("not_committed"))
            _se("Proxy.Reply")
            if acked_any:
                # sim-only oracle (debug_advanceMaxCommittedVersion,
                # MasterProxyServer.actor.cpp:820): acked versions are
                # unique per batch, and every later GRV must be >= this
                sim_validation.of(
                    self.process.net,
                    self.validation_scope).debug_advance_max_committed(
                    commit_version, f"{self.process.address}/b{batch_n}")
        except Exception as e:  # noqa: BLE001
            # a failed stage fails the whole batch; clients retry
            # (commit_unknown_result semantics: the batch may have logged)
            for span in reversed(open_spans):
                g_trace_batch.span_end("CommitSpan", bid, span, at=now())
            open_spans.clear()
            self.latest_resolving.set(max(self.latest_resolving.get(), batch_n))
            self.latest_logging.set(max(self.latest_logging.get(), batch_n))
            detail = getattr(e, "name", type(e).__name__)
            # NOTE: _last_applied_version is deliberately NOT advanced for a
            # failed batch — its state window stays un-acked, the resolvers
            # retain the entries, and a later batch's (older-ack, wider)
            # window re-covers them
            for rep in replies:
                if not rep.is_set():
                    rep.send_error(FDBError("commit_unknown_result", detail))
            if detail != "operation_cancelled":
                self._infra_failures += 1
                state_batch_lost = (resolution_started
                                    and any(m for m in batch_meta))
                # a batch abandoned between version assignment and push
                # INITIATION leaves a permanent gap in the TLogs' prevVersion
                # chain (the tlog orders pushes exactly like the resolver
                # orders batches — see the version-fetch retry above for the
                # resolver-side twin): every later push wedges behind the
                # missing version until a recovery re-anchors the chain, so
                # retry slack is doomed time — take the recovery NOW
                tlog_chain_gapped = version_assigned and not push_initiated
                if self.die_on_failure and (state_batch_lost
                                            or tlog_chain_gapped
                                            or self._infra_failures >= 3):
                    # a post-resolution failure of a batch CARRYING state
                    # transactions is immediately fatal: the resolvers
                    # recorded committed verdicts other proxies will apply
                    # to their txnStateStores, but the batch may never be
                    # durable — only a recovery reconciles that (the
                    # reference kills the proxy on any commit-pipeline
                    # error). Plain data batches keep retry slack so a
                    # transient TLog blip doesn't churn generations.
                    self.die(f"commit pipeline failing: {detail}")
        finally:
            self._batch_done()

    def _substitute(self, m: Mutation, stamp: bytes) -> Mutation:
        if m.type == MutationType.SET_VERSIONSTAMPED_KEY:
            return Mutation(MutationType.SET_VALUE,
                            substitute_versionstamp(m.param1, stamp), m.param2)
        if m.type == MutationType.SET_VERSIONSTAMPED_VALUE:
            return Mutation(MutationType.SET_VALUE, m.param1,
                            substitute_versionstamp(m.param2, stamp))
        return m
