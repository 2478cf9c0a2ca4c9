"""Database: client handle bound to a cluster (proxies + storage endpoints).

Reference: fdbclient/NativeAPI.actor.cpp Database/DatabaseContext — owns the
shard-location cache (getKeyLocation :1040 / getKeyRangeLocations :1083 with
wrong_shard_server invalidation), the read-version batcher (:2709), and the
retry-loop helper every binding exposes as `@fdb.transactional` (the RYW
commit/onError loop, bindings/python/fdb/impl.py).

The GRV batcher coalesces concurrent read-version requests into one proxy
round-trip per GRV_BATCH_INTERVAL, like readVersionBatcher.
"""

from __future__ import annotations

from collections import deque

from foundationdb_tpu_torch.client.transaction import Transaction
from foundationdb_tpu_torch.core.eventloop import ActorTask
from foundationdb_tpu_torch.core.future import Future, all_of
from foundationdb_tpu_torch.core.sim import Endpoint, SimProcess
from foundationdb_tpu_torch.server.interfaces import (
    GetKeyValuesReply, GetKeyValuesRequest, GetReadVersionRequest,
    GetValueRequest, KeySelector, Token, WatchValueRequest)
from foundationdb_tpu_torch.utils import keys as keylib
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS
from foundationdb_tpu_torch.utils.rng import DeterministicRandom
from foundationdb_tpu_torch.utils.trace import g_trace_batch


class LocationCache:
    """Client-side shard map: sorted begin-boundaries -> storage team
    (replica address list).

    The cache is a HINT (NativeAPI keyServersInfo cache): a stale entry makes
    a storage server answer wrong_shard_server, which invalidates the cache;
    the next access re-resolves through the cluster (refresh). Reads
    load-balance across a shard's replicas and fail over on errors
    (fdbrpc/LoadBalance.actor.h:159)."""

    def __init__(self, boundaries: list[bytes] | None = None,
                 teams: list | None = None):
        self.boundaries = list(boundaries or [])
        # each entry: list of replica addresses (a bare str is promoted)
        self.teams = [[t] if isinstance(t, str) else list(t)
                      for t in (teams or [])]

    @property
    def valid(self) -> bool:
        return bool(self.boundaries)

    def update(self, boundaries: list[bytes], teams: list):
        self.boundaries = list(boundaries)
        self.teams = [[t] if isinstance(t, str) else list(t) for t in teams]

    def invalidate(self):
        self.boundaries = []
        self.teams = []

    def locate(self, key: bytes) -> tuple[list[str], bytes | None]:
        """(replica addresses, end of the containing shard; None = +inf)."""
        if len(self.boundaries) == 1:  # one shard owns everything
            return self.teams[0], None
        i = keylib.partition_index(self.boundaries, key)
        end = self.boundaries[i + 1] if i + 1 < len(self.boundaries) else None
        return self.teams[i], end

    def locate_before(self, end: bytes) -> tuple[list[str], bytes]:
        """Shard containing keys strictly below `end` (reverse iteration):
        (replica addresses, begin of that shard)."""
        i = keylib.partition_index(self.boundaries, end)
        if self.boundaries[i] == end and i > 0:
            i -= 1
        return self.teams[i], self.boundaries[i]


# Errors that mean "the cluster moved under us": refresh the cluster layout
# from the coordinators and retry (NativeAPI's monitorClientInfo reaction to
# proxy failure; proxies_changed/broken_promise handling in tryCommit).
_CLUSTER_ERRORS = frozenset({
    "broken_promise", "cluster_not_fully_recovered", "tlog_stopped",
    "coordinators_changed", "timed_out", "commit_unknown_result",
})

# errors that mean "this replica is down, not the shard": try the next one
_FAILOVER_ERRORS = ("broken_promise", "request_maybe_delivered")


class ReplicaStats:
    """Per-replica smoothed request latency plus outstanding depth (the
    QueueModel backing loadBalance, fdbrpc/QueueModel.h): one EWMA per
    address, fed by every completed read, and a client-side count of this
    handle's in-flight requests per replica. Unknown replicas report the
    team's best known latency so a fresh replica gets probed instead of
    starved."""

    __slots__ = ("ewma", "inflight")

    def __init__(self):
        self.ewma: dict[str, float] = {}
        self.inflight: dict[str, int] = {}

    def record(self, addr: str, latency: float):
        prev = self.ewma.get(addr)
        alpha = KNOBS.LOAD_BALANCE_EWMA_ALPHA
        self.ewma[addr] = latency if prev is None \
            else prev + alpha * (latency - prev)

    def begin(self, addr: str):
        self.inflight[addr] = self.inflight.get(addr, 0) + 1

    def end(self, addr: str):
        n = self.inflight.get(addr, 0) - 1
        if n > 0:
            self.inflight[addr] = n
        else:
            self.inflight.pop(addr, None)

    def expected(self, addr: str, default: float) -> float:
        return self.ewma.get(addr, default)

    def order(self, team: list[str], rng) -> list[str]:
        """Team sorted fastest-first. Unknown replicas inherit the best
        known EWMA, every estimate gets a small multiplicative jitter —
        near-equal replicas keep swapping places (so load spreads and the
        model keeps sampling everyone), while a genuinely slow replica
        stays last — and queued depth multiplies the estimate (QueueModel's
        outstanding penalty: a replica already holding this client's
        batches costs its latency times the queue it must drain first)."""
        if len(team) <= 1:
            return list(team)
        known = [v for a in team if (v := self.ewma.get(a)) is not None]
        default = min(known) if known else 0.0
        inflight = self.inflight
        return sorted(team, key=lambda a: self.expected(a, default)
                      * (0.8 + 0.4 * rng.random())
                      * (1.0 + inflight.get(a, 0)))


def _relay_list(subs: list[Future], f: Future):
    """Resolve `f` with the list of `subs` values (first error wins) — the
    reassembly step for a multiget decomposed across shards."""
    inner = all_of(subs)

    def relay(s):
        if f.is_ready():
            return
        if s.is_error():
            f._set_error(s._result)
        else:
            f._set(s._result)
    inner.add_callback(relay)


class Database:
    def __init__(self, process: SimProcess, proxies: list[str] | None = None,
                 locations: LocationCache | None = None,
                 rng: DeterministicRandom | None = None,
                 coordinators: list[str] | None = None,
                 grv_proxies: list[str] | None = None):
        """`locations` is the shard-location cache; statically-built clusters
        seed it directly, coordinator-discovered ones fill it via refresh().

        With `coordinators`, the client discovers (and re-discovers, after
        recoveries) the proxy list and storage layout through the elected
        cluster controller's DBInfo — the cluster-file path of the reference
        (MonitorLeader.actor.cpp + monitorClientInfo, NativeAPI:497)."""
        self.process = process
        self.loop = process.net.loop
        self.proxies = list(proxies or [])  # commit proxy process addresses
        # dedicated GRV pool (grv_proxy/commit_proxy split): read-version
        # requests route here when non-empty, commits to `proxies`
        self.grv_proxies = list(grv_proxies or [])
        self.locations = locations or LocationCache()
        self.coordinators = list(coordinators or [])
        self._rng = rng or DeterministicRandom(0xDB)
        self._grv_waiters: list[Future] = []
        self._grv_armed = False
        # read batcher (readVersionBatcher pattern on the data path): every
        # concurrent point read in this process is coalesced into per-team
        # GetValuesRequest RPCs — the per-message cost, not the lookup,
        # dominates a Python host's read path
        self._read_queue: list[tuple[bytes, int, Future]] = []
        self._read_armed = False
        # knob cached off the hot path (re-read at every flush): the knob
        # registry's __getattr__ is measurable at per-read frequency
        self._read_batch_max = KNOBS.READ_BATCH_MAX
        # per-replica latency model driving read load balance + hedging
        self._replica_stats = ReplicaStats()
        # read load-balance telemetry, folded into metrics snapshots via
        # lb_snapshot(): backup requests launched/won, replica failovers,
        # and per-entry fallback re-resolutions across this handle
        self.lb_counters = {"hedges": 0, "hedge_wins": 0, "failovers": 0,
                            "fallbacks": 0}
        # client-side span idents (NativeAPI debugTransaction): one sequence
        # per database, address-prefixed so traces from many client processes
        # merge without collisions
        self._span_seq = 0
        # informed-retry penalty cache (docs/contention.md): throttled range
        # -> sim time the server-advised penalty expires. Shared across all
        # this database's transactions, so one throttled commit teaches
        # every subsequent retry touching that range to wait it out.
        self._range_penalties: dict[tuple[bytes, bytes], float] = {}
        # commit admission control (docs/performance.md): an AIMD budget
        # bounds in-flight commits per Database, so N client coroutines
        # sharing this handle stop stuffing the proxy queue they are
        # measuring. Deferred commits wait in FIFO order.
        self._commit_budget = float(KNOBS.CLIENT_COMMIT_INITIAL_IN_FLIGHT)
        self._commits_in_flight = 0
        self._commit_queue: deque = deque()  # deferred send thunks
        self._commit_lat_floor: float | None = None
        self._last_budget_cut = float("-inf")

    def _note_throttle(self, error) -> float:
        """Record a transaction_throttled error's advised backoff in the
        penalty cache. detail is "<backoff> <begin_hex> <end_hex>" (set at
        the proxy, utils/errors.py); returns the advised seconds."""
        try:
            parts = error.detail.split()
            backoff = float(parts[0])
            begin = bytes.fromhex(parts[1])
            end = bytes.fromhex(parts[2])
        except (ValueError, IndexError):
            return KNOBS.DEFAULT_BACKOFF  # malformed detail: jitter only
        expiry = self.loop.now() + backoff
        key = (begin, end)
        if self._range_penalties.get(key, 0.0) < expiry:
            self._range_penalties[key] = expiry
        return backoff

    def _penalty_wait(self, write_ranges) -> float:
        """Remaining advised penalty (seconds) over `write_ranges`, pruning
        expired cache entries as a side effect."""
        if not self._range_penalties:
            return 0.0
        now = self.loop.now()
        for k in [k for k, t in self._range_penalties.items() if t <= now]:
            del self._range_penalties[k]
        wait = 0.0
        for (pb, pe), expiry in self._range_penalties.items():
            for b, e in write_ranges:
                if b < pe and pb < e:
                    wait = max(wait, expiry - now)
                    break
        return wait

    def _next_span_id(self, kind: str) -> str:
        self._span_seq += 1
        return f"{kind}{self.process.address}.{self._span_seq}"

    def create_transaction(self) -> Transaction:
        return Transaction(self)

    async def transact(self, fn, max_retries: int = 100):
        """Run `await fn(tr)` then commit, retrying per onError — the
        @fdb.transactional contract. Cluster-layout errors trigger a
        coordinator-driven refresh before the retry."""
        tr = self.create_transaction()
        for _ in range(max_retries):
            try:
                result = await fn(tr)
                await tr.commit()
                return result
            except FDBError as e:
                if self.coordinators and e.name in _CLUSTER_ERRORS:
                    try:
                        await self.refresh()
                    except FDBError as re:
                        if re.name == "operation_cancelled":
                            raise
                        # no recovered cluster yet: burn one retry and keep
                        # trying — a slow recovery is a retryable condition
                    # back off: right after a role dies the CC's DBInfo can
                    # still list it for a failure-detection interval, so a
                    # free refresh + instant retry would spin through the
                    # whole retry budget inside that window
                    await self.loop.delay(0.1 * (0.5 + self._rng.random()))
                    tr = self.create_transaction()
                    continue
                await tr.on_error(e)  # re-raises when not retryable
        raise FDBError("operation_failed", "transact: retry limit exhausted")

    async def refresh(self, max_wait: float = 30.0):
        """Re-resolve the cluster layout via the coordinators: leader ->
        DBInfo -> proxies + shard map. Blocks (bounded) until a recovered
        generation is available."""
        from foundationdb_tpu_torch.core.sim import Endpoint
        from foundationdb_tpu_torch.server.coordination import get_leader
        from foundationdb_tpu_torch.server.interfaces import Token

        deadline = self.loop.now() + max_wait
        while self.loop.now() < deadline:
            try:
                leader = await get_leader(self.process, self.coordinators)
                if leader:
                    info = await self.loop.timeout(self.process.net.request(
                        self.process, Endpoint(leader, Token.CC_GET_DBINFO),
                        None), 2.0)
                    if info.recovery_state == "accepting_commits" and info.proxies:
                        self.proxies = list(info.proxies)
                        self.grv_proxies = list(
                            getattr(info, "grv_proxies", None) or [])
                        addr_of_tag = {tag: addr for addr, tag in info.storages}
                        boundaries = list(info.shard_boundaries)
                        self.locations.update(
                            boundaries,
                            [[addr_of_tag[t] for t in team]
                             for team in info.teams()])
                        return
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise
            await self.loop.delay(0.5)
        raise FDBError("coordinators_changed", "no recovered cluster found")

    async def get_status(self) -> dict:
        """Cluster status JSON via the elected CC (StatusClient.actor.cpp /
        the \\xff\\xff/status/json read)."""
        from foundationdb_tpu_torch.server.coordination import get_leader
        leader = await get_leader(self.process, self.coordinators)
        if leader is None:
            raise FDBError("coordinators_changed", "no leader for status")
        return await self.loop.timeout(self.process.net.request(
            self.process, Endpoint(leader, Token.CC_GET_STATUS), None), 5.0)

    # -- RPC plumbing used by Transaction --

    def _pick_proxy(self, token: int) -> Endpoint:
        pool = self.proxies
        if token == Token.PROXY_GET_READ_VERSION and self.grv_proxies:
            pool = self.grv_proxies
        if not pool:
            raise FDBError("cluster_not_fully_recovered", "no proxies known")
        addr = pool[self._rng.randint(0, len(pool) - 1)]
        return Endpoint(addr, token)

    def _grv(self) -> Future:
        """Batched read-version fetch (readVersionBatcher :2709). Fixed-
        interval flushes, several allowed in flight: serializing rounds
        behind one RTT measurably hurts tail latency under commit load."""
        f = Future()
        self._grv_waiters.append(f)
        if not self._grv_armed:
            self._grv_armed = True
            self.process.spawn(self._grv_flush(), "grvBatcher")
        return f

    async def _grv_flush(self):
        await self.loop.delay(KNOBS.GRV_BATCH_INTERVAL)
        waiters, self._grv_waiters = self._grv_waiters, []
        self._grv_armed = False
        span_id = self._next_span_id("grv")
        t0 = self.loop.now()

        def settle(reply, err):
            # both records after the round trip: a failed flush must not
            # strand an open span in the trace
            g_trace_batch.span_begin("CommitSpan", span_id, "Client.GRV",
                                     at=t0)
            g_trace_batch.span_end("CommitSpan", span_id, "Client.GRV",
                                   at=self.loop.now())
            for w in waiters:
                if not w.is_ready():
                    if err is not None:
                        w._set_error(err)
                    else:
                        w._set(reply)

        try:
            inner = self.process.net.request(
                self.process, self._pick_proxy(Token.PROXY_GET_READ_VERSION),
                GetReadVersionRequest(debug_id=span_id, count=len(waiters)))
        except FDBError as e:
            settle(None, FDBError(e.name, e.detail))
            return

        # settle the waiters from the reply callback, not after an await:
        # the version reaches every waiting transaction in the same loop
        # tick the reply frame settles in, instead of one actor-resume
        # later (the frame-to-future collapse of the native client plane)
        def on_reply(s: Future):
            if s.is_error():
                e = s._result
                if isinstance(e, FDBError):
                    e = FDBError(e.name, e.detail)
                settle(None, e)
            else:
                settle(s._result, None)

        inner.add_callback(on_reply)

    async def _ensure_locations(self):
        if not self.locations.valid:
            if not self.coordinators:
                raise FDBError("cluster_not_fully_recovered", "no layout known")
            await self.refresh()

    def lb_snapshot(self) -> dict:
        """Load-balance telemetry for metrics snapshots: the hedge/failover
        tallies plus the per-replica latency model and outstanding depth."""
        snap = dict(self.lb_counters)
        snap["replica_ewma_ms"] = {
            a: round(v * 1000.0, 3)
            for a, v in sorted(self._replica_stats.ewma.items())}
        snap["replica_inflight"] = dict(self._replica_stats.inflight)
        return snap

    def _team_order(self, team: list[str]) -> list[str]:
        """Load balance: replicas ordered by smoothed latency (EWMA), the
        rest as failover/backup targets (loadBalance's firstRequest /
        backupRequest pattern over QueueModel estimates)."""
        return self._replica_stats.order(team, self._rng)

    def _backup_delay(self, addr: str) -> float:
        """How long `addr`'s request may stay in flight before a duplicate
        goes to the next replica (LoadBalance.actor.h:159 backup request)."""
        expected = self._replica_stats.expected(
            addr, KNOBS.LOAD_BALANCE_MIN_BACKUP_DELAY)
        return max(KNOBS.LOAD_BALANCE_MIN_BACKUP_DELAY,
                   KNOBS.LOAD_BALANCE_BACKUP_MULT * expected)

    def _as_future(self, awaitable) -> Future:
        """Normalize fn(addr)'s result: net.request hands back a Future
        already; async wrappers (range fetches) come back as coroutines."""
        if isinstance(awaitable, Future):
            return awaitable
        return self.process.spawn(awaitable, "lbAttempt")

    def _first_settled(self, futs: list[Future],
                       timeout: float | None) -> Future:
        """Future of whichever of `futs` settles first (value OR error —
        unlike any_of, an error must not win past a slower success here);
        resolves to None at `timeout` so the caller can hedge."""
        sel = Future()

        def on_done(f: Future):
            if not sel.is_ready():
                sel._set(f)

        for f in futs:
            f.add_callback(on_done)
        if timeout is not None:
            self.loop._schedule(
                timeout, 0,
                lambda: sel._set(None) if not sel.is_ready() else None)
        return sel

    async def _on_team(self, team: list[str], fn):
        """Run `await fn(addr)` against the team: fastest-known replica
        first, a duplicate backup request to the next replica once the
        first exceeds its expected-latency deadline (first settled answer
        wins), and hard failover on down-replica errors. wrong_shard_server
        escapes for the caller's cache re-resolution; anything else
        propagates. THE single read-path policy (loadBalance,
        fdbrpc/LoadBalance.actor.h:159)."""
        order = self._team_order(team)
        stats = self._replica_stats
        if len(order) == 1:  # merged topologies: skip the hedging machinery
            start = self.loop.now()
            result = await fn(order[0])
            stats.record(order[0], self.loop.now() - start)
            return result
        inflight: list[tuple[str, float, Future]] = []
        last: FDBError | None = None
        idx = 0
        launch = True
        try:
            while True:
                if launch and idx < len(order):
                    addr = order[idx]
                    idx += 1
                    inflight.append((addr, self.loop.now(),
                                     self._as_future(fn(addr))))
                launch = False
                if not inflight:
                    raise last or FDBError("all_alternatives_failed")
                # hedge off the OLDEST in-flight request's deadline
                addr0, start0, _f0 = inflight[0]
                remaining = None
                if idx < len(order):
                    remaining = max(
                        0.0,
                        start0 + self._backup_delay(addr0) - self.loop.now())
                winner = await self._first_settled(
                    [f for _a, _s, f in inflight], remaining)
                if winner is None:
                    # deadline passed: the laggard's outstanding time IS a
                    # latency observation (it may never settle in-window),
                    # so the model stops preferring it; then hedge
                    stats.record(addr0, self.loop.now() - start0)
                    self.lb_counters["hedges"] += 1
                    launch = True
                    continue
                pos = next(i for i, (_a, _s, f) in enumerate(inflight)
                           if f is winner)
                addr, start, _f = inflight.pop(pos)
                if not winner.is_error():
                    stats.record(addr, self.loop.now() - start)
                    if pos > 0:  # a younger duplicate beat the original
                        self.lb_counters["hedge_wins"] += 1
                    return winner.get()
                e = winner._result
                if not isinstance(e, FDBError) \
                        or e.name == "operation_cancelled":
                    raise e
                # a failed attempt reads as slow so ordering learns from it
                stats.record(addr, self._backup_delay(addr))
                last = e
                if e.name == "wrong_shard_server" \
                        and (inflight or idx < len(order)):
                    # replica-LOCAL rejection first (a fetched-version
                    # watermark or revocation fence on one copy): another
                    # replica may hold the history, so the shard has only
                    # truly moved when every replica says so — then the
                    # exhausted raise below sends the caller to re-resolve
                    self.lb_counters["failovers"] += 1
                    launch = not inflight
                    continue
                if e.name in _FAILOVER_ERRORS:
                    self.lb_counters["failovers"] += 1
                    launch = not inflight  # replica down: move on
                    continue
                raise e
        finally:
            for _a, _s, f in inflight:
                if isinstance(f, ActorTask):
                    f.cancel()

    async def _storage_request(self, key: bytes, token: int, req,
                               max_attempts: int = 5):
        """Locate `key`'s team and send with failover; wrong_shard_server
        (stale cache after a shard move) invalidates and re-resolves
        (NativeAPI:1177 getValue's retry)."""
        for _ in range(max_attempts):
            await self._ensure_locations()
            team, _end = self.locations.locate(key)
            try:
                return await self._on_team(
                    team, lambda addr: self.process.net.request(
                        self.process, Endpoint(addr, token), req))
            except FDBError as e:
                if e.name == "wrong_shard_server" and self.coordinators:
                    self.locations.invalidate()
                    continue
                raise
        raise FDBError("wrong_shard_server", "location cache cannot converge")

    def _read_get(self, key: bytes, version: int) -> Future:
        """Batched point read resolving to the RAW value (bytes | None) —
        one future per read, shared all the way to the caller."""
        f = Future()
        queue = self._read_queue
        queue.append((key, version, f))
        if len(queue) >= self._read_batch_max:
            self._read_queue = []
            self.process.spawn(self._send_read_batches(queue), "readBatch")
        elif not self._read_armed:
            self._read_armed = True
            self.process.spawn(self._read_flush(), "readBatcher")
        return f

    def _read_get_many(self, keys, version: int) -> Future:
        """Batched multiget: ONE future resolving to the list of raw values
        for `keys` (order preserved). Rides the same read batcher as
        _read_get — queue entries whose key slot is a tuple carry several
        reads — so a transaction's point reads cost one future + one queue
        entry instead of N of each. (The batch-size knob counts entries,
        not keys; multigets make batches proportionally larger.)"""
        f = Future()
        if not keys:
            f._set([])
            return f
        queue = self._read_queue
        queue.append((tuple(keys), version, f))
        if len(queue) >= self._read_batch_max:
            self._read_queue = []
            self.process.spawn(self._send_read_batches(queue), "readBatch")
        elif not self._read_armed:
            self._read_armed = True
            self.process.spawn(self._read_flush(), "readBatcher")
        return f

    async def _read_flush(self):
        self._read_batch_max = KNOBS.READ_BATCH_MAX
        await self.loop.delay(KNOBS.READ_BATCH_INTERVAL)
        self._read_armed = False
        queue, self._read_queue = self._read_queue, []
        if queue:
            await self._send_read_batches(queue)

    async def _send_read_batches(self, entries):
        """Group queued reads by storage team and fan the batches out."""
        try:
            await self._ensure_locations()
        except FDBError as e:
            for _k, _v, f in entries:
                if not f.is_ready():
                    f._set_error(FDBError(e.name, e.detail))
            return
        teams = self.locations.teams
        if len(teams) == 1:  # unsharded cluster: the whole batch is one group
            await self._send_read_group(list(teams[0]), entries)
            return
        locate = self.locations.locate
        groups: dict[tuple, list] = {}
        for ent in entries:
            k = ent[0]
            if type(k) is bytes:
                team, _end = locate(k)
                groups.setdefault(tuple(team), []).append(ent)
                continue
            # multiget entry: keep it whole when one team covers every key,
            # else decompose into per-key futures and reassemble
            t0 = tuple(locate(k[0])[0])
            if all(tuple(locate(kk)[0]) == t0 for kk in k[1:]):
                groups.setdefault(t0, []).append(ent)
                continue
            keys, v, f = ent
            subs = [Future() for _ in keys]
            for kk, sf in zip(keys, subs):
                team, _end = locate(kk)
                groups.setdefault(tuple(team), []).append((kk, v, sf))
            _relay_list(subs, f)
        for team, ents in groups.items():
            self.process.spawn(self._send_read_group(list(team), ents),
                               "readBatchGroup")

    def _read_fallback(self, k, v: int, f: Future):
        """Per-entry path for a read that fell out of a batch: re-resolves
        the location cache and fails over on its own. `k` is a single key
        (bytes) or a multiget's key tuple."""
        self.lb_counters["fallbacks"] += 1
        if type(k) is bytes:
            inner = self.loop.spawn(self._storage_request(
                k, Token.STORAGE_GET_VALUE,
                GetValueRequest(key=k, version=v)), "getValue")

            def relay(s):
                if f.is_ready():
                    return
                if s.is_error():
                    f._set_error(s._result)
                else:
                    f._set(s._result.value)
            inner.add_callback(relay)
            return

        async def gather():
            out = []
            for kk in k:
                rep = await self._storage_request(
                    kk, Token.STORAGE_GET_VALUE,
                    GetValueRequest(key=kk, version=v))
                out.append(rep.value)
            return out

        inner = self.loop.spawn(gather(), "getValues")

        def relay_many(s):
            if f.is_ready():
                return
            if s.is_error():
                f._set_error(s._result)
            else:
                f._set(s._result)
        inner.add_callback(relay_many)

    async def _send_read_group(self, team: list[str], ents):
        from foundationdb_tpu_torch.server.interfaces import GetValuesRequest
        reads = []
        append = reads.append
        flat = True
        for k, v, _f in ents:
            if type(k) is bytes:
                append((k, v))
            else:
                flat = False
                for kk in k:
                    append((kk, v))
        req = GetValuesRequest(reads=reads)
        order = self._team_order(team)
        if len(order) == 1:
            # single-replica fast path, collapsed to a reply callback: the
            # batch's futures settle in the SAME loop tick the reply frame
            # arrives in, instead of resuming this coroutine first (one
            # loop-schedule hop per batch — the client-side half of the
            # frame-to-future path; the hedged path below keeps the
            # coroutine since it genuinely multiplexes attempts).
            addr = order[0]
            stats = self._replica_stats
            span_id = self._next_span_id("read")
            t0 = self.loop.now()
            stats.begin(addr)
            inner = self.process.net.request(
                self.process, Endpoint(addr, Token.STORAGE_GET_VALUES), req)

            def on_reply(s: Future):
                stats.end(addr)
                g_trace_batch.span_begin("CommitSpan", span_id,
                                         "Client.Read", at=t0)
                g_trace_batch.span_end("CommitSpan", span_id, "Client.Read",
                                       at=self.loop.now())
                if not s.is_error():
                    stats.record(addr, self.loop.now() - t0)
                    self._distribute_read_results(ents, s._result.results,
                                                  flat)
                    return
                e = s._result
                if not isinstance(e, FDBError) \
                        or e.name == "operation_cancelled":
                    for _k, _v, f in ents:
                        if not f.is_ready():
                            f._set_error(e)
                    return
                # whole-batch failure (replica down, future_version, stale
                # shard): per-entry re-resolution, as the awaited path
                if e.name == "wrong_shard_server" and self.coordinators:
                    self.locations.invalidate()
                for k, v, f in ents:
                    if not f.is_ready():
                        self._read_fallback(k, v, f)

            inner.add_callback(on_reply)
            return
        self._send_read_group_hedged(order, req, ents, flat)

    def _send_read_group_hedged(self, order: list[str], req, ents,
                                flat: bool) -> None:
        """Multi-replica batched read, collapsed to reply callbacks like
        the single-replica fast path but multiplexed across the team: send
        to the EWMA-best replica, arm a backup-request timer off its
        expected latency, and let the first successful reply settle the
        whole batch in its own loop tick (LoadBalance.actor.h:159's backup
        request without the per-batch coroutine — what wires the replica
        hedging to the batched multi-replica read path). Replica-LOCAL
        rejections (down replica, fetched-version watermark) fail over to
        the next replica; the batch falls back to per-entry re-resolution
        only when the team is exhausted or the error is not replica-local."""
        stats = self._replica_stats
        counters = self.lb_counters
        state = {"idx": 0, "pending": 0, "done": False}
        span_id = self._next_span_id("read")
        t00 = self.loop.now()

        def settle_done():
            state["done"] = True
            g_trace_batch.span_begin("CommitSpan", span_id, "Client.Read",
                                     at=t00)
            g_trace_batch.span_end("CommitSpan", span_id, "Client.Read",
                                   at=self.loop.now())

        def fallback_all(invalidate: bool):
            settle_done()
            if invalidate and self.coordinators:
                self.locations.invalidate()
            for k, v, f in ents:
                if not f.is_ready():
                    self._read_fallback(k, v, f)

        def launch():
            if state["done"] or state["idx"] >= len(order):
                return
            addr = order[state["idx"]]
            state["idx"] += 1
            was_hedge = state["pending"] > 0
            t0 = self.loop.now()
            settled = [False]
            stats.begin(addr)
            state["pending"] += 1
            try:
                inner = self.process.net.request(
                    self.process, Endpoint(addr, Token.STORAGE_GET_VALUES),
                    req)
            except Exception as e:  # noqa: BLE001 — relay like a reply error
                settled[0] = True
                stats.end(addr)
                state["pending"] -= 1
                if not state["done"] and state["pending"] == 0:
                    settle_done()
                    for _k, _v, f in ents:
                        if not f.is_ready():
                            f._set_error(e)
                return

            def on_reply(s: Future):
                settled[0] = True
                stats.end(addr)
                state["pending"] -= 1
                if state["done"]:
                    return
                if not s.is_error():
                    stats.record(addr, self.loop.now() - t0)
                    if was_hedge:
                        counters["hedge_wins"] += 1
                    settle_done()
                    self._distribute_read_results(ents, s._result.results,
                                                  flat)
                    return
                e = s._result
                if not isinstance(e, FDBError) \
                        or e.name == "operation_cancelled":
                    settle_done()
                    for _k, _v, f in ents:
                        if not f.is_ready():
                            f._set_error(e)
                    return
                # a failed attempt reads as slow so ordering learns from it
                stats.record(addr, self._backup_delay(addr))
                replica_local = (e.name in _FAILOVER_ERRORS
                                 or e.name == "wrong_shard_server")
                if replica_local and (state["pending"] > 0
                                      or state["idx"] < len(order)):
                    counters["failovers"] += 1
                    if state["pending"] == 0:
                        launch()
                    return
                # team exhausted, or a whole-batch condition
                # (future_version, transaction_too_old)
                fallback_all(e.name == "wrong_shard_server")

            inner.add_callback(on_reply)
            if state["idx"] < len(order):
                delay = self._backup_delay(addr)

                def hedge():
                    if state["done"] or settled[0]:
                        return
                    # the laggard's outstanding time IS a latency
                    # observation, so the model stops preferring it
                    stats.record(addr, self.loop.now() - t0)
                    counters["hedges"] += 1
                    launch()

                self.loop._schedule(delay, 0, hedge)

        launch()

    def _distribute_read_results(self, ents, results, flat: bool) -> None:
        """Fan one GetValuesReply back out to the batch's futures: parallel
        to the request's reads, (0, value) per key or (1, error name) for
        per-key failures (wrong_shard_server re-resolves individually)."""
        if flat:
            for (k, v, f), (code, payload) in zip(ents, results):
                if f.is_ready():
                    continue
                if code == 0:
                    f._set(payload)
                elif payload == "wrong_shard_server" and self.coordinators:
                    # only this key's shard moved: re-resolve individually
                    self.locations.invalidate()
                    self._read_fallback(k, v, f)
                else:
                    f._set_error(FDBError(payload))
            return
        i = 0
        for k, v, f in ents:
            if type(k) is bytes:
                code, payload = results[i]
                i += 1
                if f.is_ready():
                    continue
                if code == 0:
                    f._set(payload)
                elif payload == "wrong_shard_server" and self.coordinators:
                    self.locations.invalidate()
                    self._read_fallback(k, v, f)
                else:
                    f._set_error(FDBError(payload))
                continue
            n = i + len(k)
            chunk = results[i:n]
            i = n
            if f.is_ready():
                continue
            bad = None
            for code, payload in chunk:
                if code != 0:
                    bad = payload
                    break
            if bad is None:
                f._set([p for _c, p in chunk])
            elif bad == "wrong_shard_server" and self.coordinators:
                # some key's shard moved: redo the whole multiget key-wise
                self.locations.invalidate()
                self._read_fallback(k, v, f)
            else:
                f._set_error(FDBError(bad))


    def _get_range(self, req: GetKeyValuesRequest) -> Future:
        return self.loop.spawn(self._get_range_shards(req), "getRangeShards")

    async def _get_range_shards(self, req: GetKeyValuesRequest):
        """Cross-shard range read: iterate the shards covering [begin, end)
        (in reverse order for reverse reads), clamping each sub-request to
        its shard, and combine — the reference's getKeyRangeLocations
        (:1083) fan-out with per-shard continuations. The caller's
        continuation loop handles `more` exactly as for one shard."""
        begin, end = req.begin.key, req.end.key
        rows: list[tuple[bytes, bytes]] = []
        remaining = req.limit

        async def fetch(addr, lo, hi):
            sub = GetKeyValuesRequest(
                begin=KeySelector.first_greater_or_equal(lo),
                end=KeySelector.first_greater_or_equal(hi),
                version=req.version, limit=remaining,
                limit_bytes=req.limit_bytes, reverse=req.reverse)
            return await self.process.net.request(
                self.process, Endpoint(addr, Token.STORAGE_GET_KEY_VALUES), sub)

        async def fetch_team(team, lo, hi):
            return await self._on_team(
                team, lambda addr: fetch(addr, lo, hi))

        attempts = 0
        if not req.reverse:
            cur = begin
            while cur < end:
                await self._ensure_locations()
                team, shard_end = self.locations.locate(cur)
                hi = end if shard_end is None else min(end, shard_end)
                try:
                    reply = await fetch_team(team, cur, hi)
                except FDBError as e:
                    if e.name == "wrong_shard_server" and self.coordinators \
                            and attempts < 5:
                        attempts += 1
                        self.locations.invalidate()
                        continue
                    raise
                rows.extend(reply.data)
                if reply.more:
                    return GetKeyValuesReply(data=rows, more=True,
                                             version=req.version)
                if req.limit:
                    remaining = req.limit - len(rows)
                    if remaining <= 0:
                        more = hi < end
                        return GetKeyValuesReply(data=rows, more=more,
                                                 version=req.version)
                cur = hi
            return GetKeyValuesReply(data=rows, more=False, version=req.version)

        cur = end
        while begin < cur:
            await self._ensure_locations()
            team, shard_begin = self.locations.locate_before(cur)
            lo = max(begin, shard_begin)
            try:
                reply = await fetch_team(team, lo, cur)
            except FDBError as e:
                if e.name == "wrong_shard_server" and self.coordinators \
                        and attempts < 5:
                    attempts += 1
                    self.locations.invalidate()
                    continue
                raise
            rows.extend(reply.data)
            if reply.more:
                return GetKeyValuesReply(data=rows, more=True,
                                         version=req.version)
            if req.limit:
                remaining = req.limit - len(rows)
                if remaining <= 0:
                    return GetKeyValuesReply(data=rows, more=begin < lo,
                                             version=req.version)
            cur = lo
        return GetKeyValuesReply(data=rows, more=False, version=req.version)

    def _watch(self, req: WatchValueRequest) -> Future:
        async def watch():
            # same failover/re-resolution as other reads; the accepted wait
            # itself is unbounded (watchValueQ blocks until the value
            # changes), so only the request's DELIVERY is fenced: a replica
            # that dies while holding the watch surfaces broken_promise and
            # fails over to another team member
            for _ in range(5):
                await self._ensure_locations()
                team, _end = self.locations.locate(req.key)
                try:
                    return await self._on_team(
                        team, lambda addr: self.process.net.request(
                            self.process,
                            Endpoint(addr, Token.STORAGE_WATCH_VALUE),
                            req, timeout=None))
                except FDBError as e:
                    if e.name == "wrong_shard_server" and self.coordinators:
                        self.locations.invalidate()
                        continue
                    raise
            raise FDBError("wrong_shard_server",
                           "location cache cannot converge")
        return self.loop.spawn(watch(), "watch")

    def _commit(self, req) -> Future:
        span_id = self._next_span_id("c")
        req.debug_id = span_id  # proxy attaches this to its batch span
        t_q = self.loop.now()  # arrival at the client, before admission wait
        out = Future()

        def send():
            self._commits_in_flight += 1
            t_send = self.loop.now()
            if t_send - t_q > 1e-9:
                # time spent parked behind the admission budget — client-side
                # backpressure, not server queueing, so it gets its own span
                # rather than inflating Client.Commit.
                g_trace_batch.span_begin("CommitSpan", span_id,
                                         "Client.AdmissionWait", at=t_q)
                g_trace_batch.span_end("CommitSpan", span_id,
                                       "Client.AdmissionWait", at=t_send)
            try:
                f = self.process.net.request(
                    self.process, self._pick_proxy(Token.PROXY_COMMIT), req)
            except Exception as e:  # noqa: BLE001 — relay to the waiter
                self._commits_in_flight -= 1
                out._set_error(e)
                self._admit_next()
                return

            def _close(_f):
                self._commits_in_flight -= 1
                # feed the budget BEFORE admitting the next commit so a cut
                # takes effect on this very drain
                self._admission_feedback(_f, self.loop.now() - t_send)
                # emit-on-settle: both records land together whether the
                # commit succeeded, conflicted, or the proxy died mid-flight.
                # Begin is t_send: Client.Commit measures the commit RPC the
                # server is responsible for; deferral behind the admission
                # budget is the separate Client.AdmissionWait span above.
                g_trace_batch.span_begin("CommitSpan", span_id,
                                         "Client.Commit", at=t_send)
                g_trace_batch.span_end("CommitSpan", span_id, "Client.Commit",
                                       at=self.loop.now())
                if _f.is_error():
                    out._set_error(_f._result)
                else:
                    out._set(_f._result)
                self._admit_next()
            f.add_callback(_close)

        if (not self._commit_queue
                and self._commits_in_flight < max(1, int(self._commit_budget))):
            send()
        else:
            self._commit_queue.append(send)
        return out

    def _admit_next(self):
        while (self._commit_queue and self._commits_in_flight
               < max(1, int(self._commit_budget))):
            self._commit_queue.popleft()()

    def _admission_feedback(self, f: Future, latency: float):
        """AIMD on the in-flight commit budget. Multiplicative decrease on
        the proxy's transaction_throttled signal or when a successful
        commit's latency inflates past CLIENT_ADMISSION_LATENCY_RATIO x the
        learned baseline — the queueing signature (server stages stay flat
        while end-to-end latency grows, as the JAX package's bench showed). Additive increase
        (~1 per budget's worth of acks) on healthy commits."""
        err = f._result if f.is_error() else None
        now = self.loop.now()
        if isinstance(err, FDBError) and err.name == "transaction_throttled":
            self._cut_budget(now, latency)
            return
        if err is not None:
            return  # conflicts/timeouts say nothing about queueing
        floor = self._commit_lat_floor
        # decaying min: snaps down to fast samples, drifts up slowly so a
        # permanently shifted baseline (topology change) is re-learned
        self._commit_lat_floor = latency if floor is None else min(
            latency, floor + 0.02 * (latency - floor))
        if (floor is not None
                and latency > KNOBS.CLIENT_ADMISSION_LATENCY_RATIO * floor):
            self._cut_budget(now, latency)
        else:
            self._commit_budget = min(
                float(KNOBS.CLIENT_COMMIT_MAX_IN_FLIGHT),
                self._commit_budget + 1.0 / max(1.0, self._commit_budget))

    def _cut_budget(self, now: float, latency: float):
        # one cut per RTT-ish window: every in-flight commit observes the
        # same congestion event, and N cuts for one event would collapse
        # the budget straight to the floor
        if now - self._last_budget_cut >= max(latency, 0.01):
            self._commit_budget = max(
                1.0, self._commit_budget * KNOBS.CLIENT_ADMISSION_DECREASE)
            self._last_budget_cut = now
