"""Workload library + spec runner: correctness invariants under fault cocktails.

Reference: fdbserver/workloads/workloads.h (:55-72 TestWorkload's
setup/start/check phases), fdbserver/workloads/Cycle.actor.cpp (:27-80 the
serializability ring), RandomClogging.actor.cpp, MachineAttrition.actor.cpp,
and the spec grammar of tests/fast/CycleTest.txt (a correctness workload runs
IN PARALLEL with fault workloads; at the end the cluster quiesces and check()
asserts the invariant). Swizzle-clogging (tests/slow/SwizzledCycleTest.txt,
documentation/sphinx/source/testing.rst): clog a whole set of links, then
unclog in reverse order — a rolling partial partition.

Every workload draws randomness ONLY from the forked DeterministicRandom it
is given, so a failing (seed, spec) pair replays identically.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from foundationdb_tpu_torch.core.future import all_of
from foundationdb_tpu_torch.core.sim import KillType
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS
from foundationdb_tpu_torch.utils.trace import TraceEvent


class Workload:
    """setup() -> start() (runs until stop_at) -> check() after quiesce."""

    name = "workload"

    def init(self, cluster, rng, stop_at: float):
        self.cluster = cluster
        self.rng = rng
        self.stop_at = stop_at

    async def setup(self, db):
        pass

    async def start(self, db):
        pass

    async def check(self, db):
        pass

    def _time_left(self) -> bool:
        return self.cluster.loop.now() < self.stop_at

    async def _commit_resolved(self, db, fn, marker, token):
        """Run fn+commit manually; resolve commit_unknown_result through the
        marker so the model only advances for transactions that landed."""
        for _ in range(200):
            tr = db.create_transaction()
            try:
                overlay = await fn(tr)
                await tr.commit()
                return overlay
            except FDBError as e:
                if e.name == "commit_unknown_result":
                    async def probe(t):
                        return await t.get(marker)
                    if await db.transact(probe, max_retries=500) == token:
                        return overlay
                    continue
                if e.name in ("not_committed", "transaction_too_old",
                              "transaction_throttled",
                              "future_version", "timed_out",
                              "proxies_changed", "cluster_not_fully_recovered",
                              "operation_failed", "wrong_shard_server",
                              "request_maybe_delivered", "broken_promise"):
                    await self.cluster.loop.delay(
                        0.2 * (0.5 + self.rng.random()))
                    continue
                raise
        return None


class CycleWorkload(Workload):
    """N keys form a ring by value; transactional 3-key rotations preserve
    the ring under ANY interleaving iff the system is serializable."""

    name = "Cycle"

    def __init__(self, n_keys: int = 5, prefix: bytes = b"cycle/"):
        self.n = n_keys
        self.prefix = prefix
        self.rotations = 0

    def key(self, i: int) -> bytes:
        return self.prefix + b"%02d" % i

    async def setup(self, db):
        async def fn(tr):
            for i in range(self.n):
                tr.set(self.key(i), b"%02d" % ((i + 1) % self.n))
        await db.transact(fn)

    async def start(self, db):
        while self._time_left():
            async def rotate(tr):
                r = self.rng.randint(0, self.n - 1)
                a = self.key(r)
                b_idx = int(await tr.get(a))
                b = self.key(b_idx)
                c_idx = int(await tr.get(b))
                ck = self.key(c_idx)
                d_idx = int(await tr.get(ck))
                tr.set(a, b"%02d" % c_idx)
                tr.set(b, b"%02d" % d_idx)
                tr.set(ck, b"%02d" % b_idx)
            await db.transact(rotate, max_retries=2000)
            self.rotations += 1
            await self.cluster.loop.delay(0.05 * self.rng.random())

    async def check(self, db):
        async def read_ring(tr):
            seen = set()
            i = 0
            for _ in range(self.n):
                seen.add(i)
                i = int(await tr.get(self.key(i)))
            return i, seen
        i, seen = await db.transact(read_ring, max_retries=1000)
        assert i == 0 and len(seen) == self.n, \
            f"ring broken after {self.rotations} rotations: {seen}"
        assert self.rotations > 0, "workload made no progress"


class RandomCloggingWorkload(Workload):
    """Randomly clog links between cluster processes (RandomClogging)."""

    name = "RandomClogging"

    def __init__(self, interval: float = 2.0, max_seconds: float = 2.5):
        self.interval = interval
        self.max_seconds = max_seconds

    async def start(self, db):
        procs = [p.address for p in self.cluster.worker_procs] + \
                [p.address for p in self.cluster.storage_worker_procs]
        while self._time_left():
            await self.cluster.loop.delay(self.interval * (0.5 + self.rng.random()))
            a = procs[self.rng.randint(0, len(procs) - 1)]
            b = procs[self.rng.randint(0, len(procs) - 1)]
            if a != b:
                self.cluster.net.clog_pair(a, b, self.max_seconds * self.rng.random())


class SwizzleCloggingWorkload(Workload):
    """Clog a random subset of processes' links one at a time, then unclog in
    reverse order ("swizzle", testing.rst) — catches recovery paths that only
    work when failures resolve in FIFO order."""

    name = "SwizzledClogging"

    def __init__(self, interval: float = 5.0):
        self.interval = interval

    async def start(self, db):
        loop = self.cluster.loop
        procs = [p.address for p in self.cluster.worker_procs]
        while self._time_left():
            await loop.delay(self.interval * (0.5 + self.rng.random()))
            subset = [a for a in procs if self.rng.coinflip(0.5)]
            self.rng.shuffle(subset)
            cloggged = []
            for a in subset:
                for b in procs:
                    if a != b:
                        self.cluster.net.clog_pair(a, b, 30.0)
                cloggged.append(a)
                await loop.delay(0.3 * self.rng.random())
            for a in reversed(cloggged):
                # unclog by re-clogging with 0 duration is not possible;
                # heal link-by-link via the clog map
                for b in procs:
                    self.cluster.net._clogged_until.pop((a, b), None)
                    self.cluster.net._clogged_until.pop((b, a), None)
                await loop.delay(0.3 * self.rng.random())


class AttritionWorkload(Workload):
    """Kill/reboot transaction-subsystem processes at random intervals
    (MachineAttrition). With replication > 1, storage workers get HARD
    KILLS too (stay down past the DD failure timeout, forcing redundancy
    healing to re-replicate their shards); single-replica storage only gets
    reboots (the data would otherwise be unrecoverable)."""

    name = "Attrition"

    def __init__(self, interval: float = 6.0):
        self.interval = interval

    async def start(self, db):
        loop = self.cluster.loop
        replicated = getattr(self.cluster.config, "n_replicas", 1) > 1
        while self._time_left():
            await loop.delay(self.interval * (0.5 + self.rng.random()))
            if self.rng.coinflip(0.3):
                victim = self.cluster.storage_worker_procs[
                    self.rng.randint(0, len(self.cluster.storage_worker_procs) - 1)]
                if replicated and self.rng.coinflip(0.5):
                    # permanent(ish) loss: down long enough that the DD
                    # declares the server failed and heals the teams; the
                    # eventual reboot returns it as a spare
                    TraceEvent("AttritionStorageKill", victim.address).log()
                    self.cluster.net.kill(victim.address, KillType.KillProcess)

                    async def reboot_much_later(addr=victim.address):
                        await loop.delay(
                            2.5 * KNOBS.DD_STORAGE_FAILURE_SECONDS
                            + 10.0 * self.rng.random())
                        self.cluster.net.reboot(addr)
                    loop.spawn(reboot_much_later(), name="attritionSReboot")
                    continue
                TraceEvent("AttritionReboot", victim.address).log()
                self.cluster.net.kill(victim.address, KillType.RebootProcess)
            else:
                victim = self.cluster.worker_procs[
                    self.rng.randint(0, len(self.cluster.worker_procs) - 1)]
                TraceEvent("AttritionKill", victim.address).log()
                # hard kill: the process stays DOWN for a while (capacity
                # genuinely lost, recovery must re-place its roles), then an
                # explicit reboot restores the worker
                self.cluster.net.kill(victim.address, KillType.KillProcess)

                async def reboot_later(addr=victim.address):
                    await loop.delay(2.0 + 4.0 * self.rng.random())
                    self.cluster.net.reboot(addr)
                loop.spawn(reboot_later(), name="attritionReboot")


async def quiet_database(c, db, max_wait: float = 120.0,
                         max_tlog_bytes: int = 100_000,
                         max_storage_lag: int = 2_000_000):
    """QuietDatabase (fdbserver/QuietDatabase.actor.cpp): checks may only
    run on a SETTLED cluster — every TLog queue drained below a threshold,
    every storage server's durability lag bounded, and data distribution
    idle (no in-flight relocation) — otherwise invariant checks race the
    pipeline's own catch-up work."""
    from foundationdb_tpu_torch.core.sim import Endpoint
    from foundationdb_tpu_torch.server.interfaces import Token
    loop = c.loop
    deadline = loop.now() + max_wait
    client = db.process
    while loop.now() < deadline:
        cc = c.current_cc()
        if cc is None:
            await loop.delay(0.5)
            continue
        info = cc.dbinfo
        ok = not getattr(cc, "_dd_moving", False)
        worst_log = worst_lag = 0
        last_ep = info.log_epochs[-1] if info.log_epochs else None
        addrs = (list(last_ep.addrs) if last_ep else []) +                 [a for a, _t in info.storages]
        for addr in addrs:
            try:
                st = await loop.timeout(c.net.request(
                    client, Endpoint(addr, Token.QUEUE_STATS), None), 1.0)
                worst_log = max(worst_log, st.queue_bytes)
                worst_lag = max(worst_lag, st.lag_versions)
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise
                ok = False
                break
        if ok and worst_log <= max_tlog_bytes \
                and worst_lag <= max_storage_lag:
            TraceEvent("QuietDatabaseDone", "spec") \
                .detail("TLogBytes", worst_log) \
                .detail("StorageLag", worst_lag).log()
            return
        await loop.delay(1.0)
    TraceEvent("QuietDatabaseTimeout", "spec", severity=30).log()


@dataclass
class SpecResult:
    seed: int
    rotations: int
    epochs: int
    elapsed: float


def run_spec(seed: int, workloads: list[Workload] | None = None,
             duration: float = 60.0, buggify: bool = True,
             max_time: float = 600_000.0, cluster_factory=None,
             **cluster_kw) -> SpecResult:
    """Boot a RecoverableCluster, run `workloads` in parallel for `duration`
    virtual seconds, quiesce (heal + wait for a recovered generation), then
    run every workload's check(). The whole run is a pure function of
    (seed, spec): the reference's `fdbserver -r simulation -f spec.txt`.

    `cluster_factory(cluster_seed) -> RecoverableCluster` overrides the
    default flat topology — the randomized harness (testing/simulated_cluster)
    uses it to boot whatever shape the seed drew, including two-region
    clusters built via RecoverableCluster.two_region().
    """
    from foundationdb_tpu_torch.server.cluster import RecoverableCluster
    from foundationdb_tpu_torch.utils.rng import DeterministicRandom

    rng = DeterministicRandom(seed)
    if buggify:
        KNOBS.buggify(rng.fork())
    if workloads is None:
        workloads = [CycleWorkload(), RandomCloggingWorkload(),
                     AttritionWorkload()]

    if cluster_factory is not None:
        c = cluster_factory(rng.randint(0, 1 << 30))
    else:
        cluster_kw.setdefault("n_workers", 5)
        cluster_kw.setdefault("n_proxies", 2)
        cluster_kw.setdefault("n_tlogs", 2)
        cluster_kw.setdefault("n_storage", 2)
        c = RecoverableCluster(seed=rng.randint(0, 1 << 30), **cluster_kw)
    db = c.database()

    async def spec():
        await db.refresh(max_wait=120.0)
        stop_at = c.loop.now() + duration
        for w in workloads:
            w.init(c, rng.fork(), stop_at)
        for w in workloads:
            await w.setup(db)
        await all_of([c.loop.spawn(w.start(db), name=w.name)
                      for w in workloads])
        # quiesce (QuietDatabase): heal every fault, then wait until a CC
        # reaches accepting_commits and transactions flow again
        c.net.heal()
        for p in c.cluster_procs():
            if not p.alive:
                c.net.reboot(p.address)
        for _ in range(600):
            if c.current_cc() is not None:
                try:
                    async def probe(tr):
                        await tr.get(b"\x00quiesce-probe")
                    await db.transact(probe, max_retries=50)
                    break
                except FDBError:
                    pass
            await c.loop.delay(0.5)
        await quiet_database(c, db)
        for w in workloads:
            await w.check(db)

    c.run(c.loop.spawn(spec()), max_time=max_time)
    cyc = next((w for w in workloads if isinstance(w, CycleWorkload)), None)
    cc = c.current_cc()
    return SpecResult(seed=seed,
                      rotations=cyc.rotations if cyc else 0,
                      epochs=cc.dbinfo.epoch if cc else -1,
                      elapsed=c.loop.now())


class ConsistencyCheckWorkload(Workload):
    """Compare every shard's replicas row-for-row at one version
    (fdbserver/workloads/ConsistencyCheck.actor.cpp): after the cluster
    quiesces, all team members must hold identical data."""

    name = "ConsistencyCheck"

    async def check(self, db):
        from foundationdb_tpu_torch.core.sim import Endpoint
        from foundationdb_tpu_torch.server.interfaces import (
            GetKeyValuesRequest, KeySelector, Token)
        await db.refresh()
        cc = self.cluster.current_cc()
        info = cc.dbinfo
        addr_of_tag = {tag: addr for addr, tag in info.storages}
        b = info.shard_boundaries
        shard_tags = info.teams()
        from foundationdb_tpu_torch.utils.errors import FDBError

        async def read_replica(tag: int, lo, hi, version):
            req = GetKeyValuesRequest(
                begin=KeySelector.first_greater_or_equal(lo),
                end=KeySelector.first_greater_or_equal(hi),
                version=version)
            rows = []
            while True:
                # a reply-error here (replica rebooting, version aged out)
                # propagates to the per-shard retry loop below, which
                # re-reads the WHOLE shard at a fresh version — handling it
                # per-page would splice rows from two versions
                reply = await db.process.net.request(  # protolint: ignore[PROTO008]

                    db.process,
                    Endpoint(addr_of_tag[tag], Token.STORAGE_GET_KEY_VALUES),
                    req)
                rows.extend(reply.data)
                if not (reply.more and reply.data):
                    return rows
                req = GetKeyValuesRequest(
                    begin=KeySelector.first_greater_or_equal(
                        reply.data[-1][0] + b"\x00"),
                    end=KeySelector.first_greater_or_equal(hi),
                    version=version)

        for i, team in enumerate(shard_tags):
            lo = b[i]
            hi = b[i + 1] if i + 1 < len(b) else b"\xff" * 16
            # transient read errors (a replica still catching up after a
            # late reboot: future_version; dropped packets; a version aging
            # out mid-check) retry the whole shard at a FRESH version — only
            # a clean same-version comparison may vote
            for attempt in range(60):
                try:
                    tr = db.create_transaction()
                    version = await tr.get_read_version()
                    per_replica = [(tag, await read_replica(tag, lo, hi,
                                                            version))
                                   for tag in team]
                    break
                except FDBError as e:
                    if e.name == "operation_cancelled":
                        raise
                    await self.cluster.loop.delay(1.0)
            else:
                raise AssertionError(
                    f"shard {i}: replicas unreadable for the checker")
            first_tag, first_rows = per_replica[0]
            for tag, rows in per_replica[1:]:
                assert rows == first_rows, \
                    (f"shard {i}: replica tag {tag} diverges from tag "
                     f"{first_tag}: {len(rows)} vs {len(first_rows)} rows")


class ConflictRangeWorkload(Workload):
    """System-level RESOLVER ORACLE (fdbserver/workloads/ConflictRange.actor.cpp):
    transaction A performs 1-3 randomized range reads (random shapes,
    optionally LIMITED and/or REVERSE — the registered conflict range is then
    clipped to the window actually observed — optionally SNAPSHOT, which
    registers nothing); transaction B then commits a random plan of
    sets/clears/range-clears; A commits a write of its own. A's outcome is
    forced: not_committed iff B touched a window A actually registered,
    committed otherwise — snapshot reads are exempt, and keys beyond a
    limit-clipped window are exempt. Every verdict cross-checks the whole
    conflict pipeline — client conflict-range registration (including the
    clipping), proxy range splitting, and the device/sharded/oracle engine's
    decision — against an independent host model, which also validates every
    range read's row set."""

    name = "ConflictRange"

    def __init__(self, n_keys: int = 48, prefix: bytes = b"cr/"):
        self.n = n_keys
        self.prefix = prefix
        self.present: set[int] = set()
        self.checked = 0
        self.conflicts = 0
        self.snapshot_exempt = 0   # B touched a snapshot read: no conflict
        self.clip_exempt = 0       # B touched only beyond a clipped window
        self.clipped_reads = 0

    def key(self, i: int) -> bytes:
        return self.prefix + b"%04d" % i

    async def setup(self, db):
        async def fn(tr):
            for i in range(0, self.n, 2):
                tr.set(self.key(i), b"v%04d" % i)
        await db.transact(fn)
        self.present = set(range(0, self.n, 2))

    # -- draw helpers (all randomness from self.rng: replayable) --

    def _draw_reads(self, rng):
        """1-3 range-read shapes: (lo_i, hi_i, limit, reverse). A limit is
        only drawn strictly below the number of rows present, so the client
        is guaranteed to clip its registered conflict range."""
        reads = []
        for _ in range(rng.randint(1, 3)):
            lo_i = rng.randint(0, self.n - 2)
            hi_i = rng.randint(lo_i + 1, self.n)
            avail = sum(1 for i in self.present if lo_i <= i < hi_i)
            limit = 0
            if avail >= 2 and rng.coinflip(0.4):
                limit = rng.randint(1, avail - 1)
            reads.append((lo_i, hi_i, limit, rng.coinflip(0.3)))
        return reads

    def _draw_plan(self, rng):
        """B's mutation plan, fixed up front so transact() retries replay
        identical (idempotent) mutations."""
        plan = []
        for _ in range(rng.randint(1, 4)):
            r = rng.random()
            if r < 0.5:
                plan.append(("set", rng.randint(0, self.n - 1),
                             rng.randint(0, 1 << 30)))
            elif r < 0.8:
                plan.append(("clear", rng.randint(0, self.n - 1), 0))
            else:
                i = rng.randint(0, self.n - 2)
                plan.append(("clear_range", i, rng.randint(i + 1, self.n)))
        return plan

    def _apply_plan(self, plan):
        for kind, a, b in plan:
            if kind == "set":
                self.present.add(a)
            elif kind == "clear":
                self.present.discard(a)
            else:
                for i in [i for i in self.present if a <= i < b]:
                    self.present.discard(i)

    def _plan_touches(self, plan, lo: bytes, hi: bytes) -> bool:
        for kind, a, b in plan:
            if kind == "clear_range":
                if self.key(a) < hi and lo < self.key(b):
                    return True
            elif lo <= self.key(a) < hi:
                return True
        return False

    def _registered_window(self, lo, hi, limit, reverse, rows):
        """Mirror of Transaction.get_range's conflict registration: a
        satisfied limit clips the window to the span actually observed."""
        if limit and len(rows) == limit:
            self.clipped_reads += 1
            if reverse:
                return (rows[-1][0], hi)
            return (lo, rows[-1][0] + b"\x00")
        return (lo, hi)

    async def _resync(self, db):
        """B's fate unknown (retry budget exhausted): reload the key model
        from the database before judging any further verdicts."""
        async def rd(tr):
            return await tr.get_range(self.key(0), self.key(self.n),
                                      limit=self.n + 1)
        rows = await db.transact(rd, max_retries=500)
        self.present = {int(k[len(self.prefix):]) for k, _v in rows}

    async def start(self, db):
        it = 0
        while self._time_left():
            it += 1
            rng = self.rng
            snapshot = rng.coinflip(0.2)
            reads = self._draw_reads(rng)
            plan = self._draw_plan(rng)
            marker = self.prefix + b"__marker__"
            token = b"t%08d" % it
            trA = db.create_transaction()
            windows = []
            b_touched_any_read = False
            try:
                await trA.get_read_version()
                for lo_i, hi_i, limit, reverse in reads:
                    lo, hi = self.key(lo_i), self.key(hi_i)
                    rows = await trA.get_range(lo, hi, limit=limit,
                                               reverse=reverse,
                                               snapshot=snapshot)
                    want = [self.key(i) for i in sorted(self.present)
                            if lo_i <= i < hi_i]
                    if reverse:
                        want = want[::-1]
                    if limit:
                        want = want[:limit]
                    got = [k for k, _v in rows]
                    assert got == want, \
                        (f"getRange[{lo_i},{hi_i}) limit={limit} "
                         f"reverse={reverse} diverges from model: "
                         f"{got} vs {want}")
                    if self._plan_touches(plan, lo, hi):
                        b_touched_any_read = True
                    windows.append(self._registered_window(
                        lo, hi, limit, reverse, rows))
            except FDBError:
                continue  # clog/recovery noise before B ran: no verdict
            # B commits its plan (idempotent; transact retries replay it)
            async def bfn(tr, plan=plan):
                for kind, a, b, in plan:
                    if kind == "set":
                        tr.set(self.key(a), b"b%08d" % b)
                    elif kind == "clear":
                        tr.clear(self.key(a))
                    else:
                        tr.clear_range(self.key(a), self.key(b))
            try:
                await db.transact(bfn, max_retries=500)
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise
                await self._resync(db)
                continue
            self._apply_plan(plan)
            # expectation: conflict iff B touched a REGISTERED window
            touches = (not snapshot) and any(
                self._plan_touches(plan, wl, wh) for wl, wh in windows)
            trA.set(marker, token)
            try:
                await trA.commit()
                committed = True
            except FDBError as e:
                if e.name == "not_committed":
                    committed = False
                elif e.name == "commit_unknown_result":
                    async def probe(tr):
                        return await tr.get(marker)
                    committed = (await db.transact(probe, max_retries=500)
                                 == token)
                else:
                    continue  # infrastructure noise: no verdict
            assert committed == (not touches), \
                (f"resolver verdict wrong: B touched A's registered "
                 f"range={touches}, A committed={committed} (iter {it}, "
                 f"snapshot={snapshot}, reads {reads}, plan {plan})")
            self.checked += 1
            self.conflicts += 0 if committed else 1
            if committed and snapshot and b_touched_any_read:
                self.snapshot_exempt += 1
            if committed and not snapshot and b_touched_any_read:
                # touched a read but no registered window: clip exemption
                self.clip_exempt += 1

    async def check(self, db):
        assert self.checked > 0, "no conflict-range verdicts were checked"
        assert self.conflicts > 0, \
            "workload never produced a conflict (coverage bug)"


class ApiCorrectnessWorkload(Workload):
    """Model-based API conformance (workloads/ApiCorrectness.actor.cpp):
    a single writer drives random set/clear/clear_range/atomic-add ops plus
    get/get_range/get_key reads, mirroring every committed mutation into a
    host dict; every read must match the model exactly. Composable with
    clogging: commit_unknown_result is resolved through a per-transaction
    marker before the model advances."""

    name = "ApiCorrectness"

    def __init__(self, n_keys: int = 60, prefix: bytes = b"api/"):
        self.n = n_keys
        self.prefix = prefix
        self.model: dict[bytes, bytes] = {}
        self.txns = 0

    def key(self, i: int) -> bytes:
        return self.prefix + b"%04d" % i

    def _apply(self, model, ops):
        from foundationdb_tpu_torch.utils.types import MutationType, apply_atomic_op
        for op in ops:
            kind = op[0]
            if kind == "set":
                model[op[1]] = op[2]
            elif kind == "clear":
                model.pop(op[1], None)
            elif kind == "clear_range":
                for k in [k for k in model if op[1] <= k < op[2]]:
                    del model[k]
            elif kind == "add":
                model[op[1]] = apply_atomic_op(
                    MutationType.ADD_VALUE, model.get(op[1]), op[2])

    async def start(self, db):
        from foundationdb_tpu_torch.server.interfaces import KeySelector
        from foundationdb_tpu_torch.utils.types import MutationType
        it = 0
        while self._time_left():
            it += 1
            rng = self.rng
            ops = []
            for _ in range(rng.randint(1, 6)):
                r = rng.random()
                k = self.key(rng.randint(0, self.n - 1))
                if r < 0.45:
                    ops.append(("set", k, b"v%06d" % rng.randint(0, 1 << 20)))
                elif r < 0.6:
                    ops.append(("clear", k))
                elif r < 0.75:
                    i = rng.randint(0, self.n - 2)
                    j = rng.randint(i + 1, self.n)
                    ops.append(("clear_range", self.key(i), self.key(j)))
                else:
                    ops.append(("add", k,
                                rng.randint(1, 1000).to_bytes(8, "little")))
            marker = self.prefix + b"__marker__"
            token = b"t%08d" % it

            async def fn(tr, ops=ops, token=token):
                overlay = dict(self.model)
                self._apply(overlay, ops)
                for op in ops:
                    if op[0] == "set":
                        tr.set(op[1], op[2])
                    elif op[0] == "clear":
                        tr.clear(op[1])
                    elif op[0] == "clear_range":
                        tr.clear_range(op[1], op[2])
                    else:
                        tr.atomic_op(MutationType.ADD_VALUE, op[1], op[2])
                # reads through the RYW overlay must equal the model
                for _ in range(2):
                    k = self.key(self.rng.randint(0, self.n - 1))
                    got = await tr.get(k)
                    want = overlay.get(k)
                    assert got == want, f"get({k}) = {got}, model {want}"
                i = self.rng.randint(0, self.n - 2)
                j = self.rng.randint(i + 1, self.n)
                rows = await tr.get_range(self.key(i), self.key(j))
                want_rows = sorted((k, v) for k, v in overlay.items()
                                   if self.key(i) <= k < self.key(j)
                                   and not k.endswith(b"__marker__"))
                got_rows = [(k, v) for k, v in rows
                            if not k.endswith(b"__marker__")]
                assert got_rows == want_rows, \
                    f"get_range[{i},{j}) diverges from model"
                # selector read: first key at-or-after a random point
                k = self.key(self.rng.randint(0, self.n - 1))
                got_k = await tr.get_key(KeySelector.first_greater_or_equal(k))
                cand = sorted(kk for kk in overlay if kk >= k)
                if cand and cand[0] < self.prefix + b"\xff":
                    assert got_k == cand[0], \
                        f"get_key(>={k}) = {got_k}, model {cand[0]}"
                tr.set(marker, token)
                return overlay

            try:
                overlay = await self._commit_resolved(db, fn, marker, token)
            except FDBError:
                continue  # infrastructure noise; model unchanged
            if overlay is not None:
                overlay.pop(marker, None)
                self.model = overlay
                self.txns += 1

    async def check(self, db):
        assert self.txns > 0, "no API transactions committed"
        async def read_all(tr):
            return await tr.get_range(self.prefix, self.prefix + b"\xff",
                                      limit=10_000)
        rows = await db.transact(read_all, max_retries=1000)
        got = {k: v for k, v in rows if not k.endswith(b"__marker__")}
        want = dict(self.model)
        assert got == want, \
            (f"final state diverges from model: {len(got)} vs {len(want)} "
             f"rows after {self.txns} txns")


class WriteDuringReadWorkload(Workload):
    """RYW-overlay conformance under interleaved reads and writes INSIDE one
    transaction (workloads/WriteDuringRead.actor.cpp): after every mutation,
    plain and snapshot reads must both see the overlay state (snapshot reads
    skip conflict registration, not the overlay); aborted transactions must
    leave no trace."""

    name = "WriteDuringRead"

    def __init__(self, n_keys: int = 30, prefix: bytes = b"wdr/"):
        self.n = n_keys
        self.prefix = prefix
        self.model: dict[bytes, bytes] = {}
        self.txns = 0

    def key(self, i: int) -> bytes:
        return self.prefix + b"%04d" % i

    async def start(self, db):
        from foundationdb_tpu_torch.utils.types import MutationType, apply_atomic_op
        it = 0
        while self._time_left():
            it += 1
            rng = self.rng
            commit_it = rng.coinflip(0.6)
            marker = self.prefix + b"__marker__"
            token = b"t%08d" % it
            steps = rng.randint(2, 8)
            plan = [rng.randint(0, 1 << 30) for _ in range(steps)]

            async def fn(tr, plan=plan, token=token):
                overlay = dict(self.model)
                for step in plan:
                    srng = step
                    k = self.key(srng % self.n)
                    kind = (srng >> 8) % 4
                    if kind == 0:
                        v = b"w%08d" % (srng % 10_000_019)
                        tr.set(k, v)
                        overlay[k] = v
                    elif kind == 1:
                        tr.clear(k)
                        overlay.pop(k, None)
                    elif kind == 2:
                        d = (1 + srng % 999).to_bytes(8, "little")
                        tr.atomic_op(MutationType.ADD_VALUE, k, d)
                        overlay[k] = apply_atomic_op(
                            MutationType.ADD_VALUE, overlay.get(k), d)
                    # read-after-write, both plain and snapshot
                    got = await tr.get(k)
                    assert got == overlay.get(k), \
                        f"RYW get({k}) = {got}, overlay {overlay.get(k)}"
                    got_s = await tr.get(k, snapshot=True)
                    assert got_s == overlay.get(k), \
                        f"snapshot get({k}) = {got_s}, overlay {overlay.get(k)}"
                rows = await tr.get_range(self.prefix, self.prefix + b"\xf0")
                want = sorted((kk, vv) for kk, vv in overlay.items()
                              if not kk.endswith(b"__marker__"))
                got_rows = [(kk, vv) for kk, vv in rows
                            if not kk.endswith(b"__marker__")]
                assert got_rows == want, "RYW range diverges from overlay"
                tr.set(marker, token)
                return overlay

            if not commit_it:
                # run and abandon: an uncommitted transaction's writes must
                # never become visible
                tr = db.create_transaction()
                try:
                    await fn(tr)
                except FDBError:
                    pass
                tr.reset()
                continue
            try:
                overlay = await self._commit_resolved(db, fn, marker, token)
            except FDBError:
                continue
            if overlay is not None:
                overlay.pop(marker, None)
                self.model = overlay
                self.txns += 1

    async def check(self, db):
        assert self.txns > 0, "no write-during-read transactions committed"
        async def read_all(tr):
            return await tr.get_range(self.prefix, self.prefix + b"\xff",
                                      limit=10_000)
        rows = await db.transact(read_all, max_retries=1000)
        got = {k: v for k, v in rows if not k.endswith(b"__marker__")}
        assert got == dict(self.model), "abandoned writes leaked or state lost"


class AtomicOpsWorkload(Workload):
    """Atomic-op consistency under retries and faults
    (workloads/AtomicOps.actor.cpp): every transaction atomically ADDs a
    delta to one of K counters AND writes a VERSIONSTAMPED log row carrying
    the same delta — the two ride one commit, so even a duplicated
    commit_unknown_result retry keeps the invariant sum(logs) == counter."""

    name = "AtomicOps"

    def __init__(self, n_counters: int = 4, prefix: bytes = b"aops/"):
        self.k = n_counters
        self.prefix = prefix
        self.attempted = 0

    async def start(self, db):
        from foundationdb_tpu_torch.utils.types import MutationType
        while self._time_left():
            rng = self.rng
            c = rng.randint(0, self.k - 1)
            d = rng.randint(1, 1000)

            async def fn(tr, c=c, d=d):
                tr.atomic_op(MutationType.ADD_VALUE,
                             self.prefix + b"sum/%02d" % c,
                             d.to_bytes(8, "little"))
                # log key gets the commit versionstamp: EVERY application
                # (including a duplicated retry) produces its own row
                body = self.prefix + b"log/%02d/" % c + b"\x00" * 10
                key = body + (len(body) - 10).to_bytes(4, "little")
                tr.atomic_op(MutationType.SET_VERSIONSTAMPED_KEY, key,
                             d.to_bytes(8, "little"))
            try:
                await db.transact(fn, max_retries=1000)
                self.attempted += 1
            except FDBError:
                pass
            await self.cluster.loop.delay(0.02 * self.rng.random())

    async def check(self, db):
        assert self.attempted > 0, "no atomic transactions ran"
        async def read_all(tr):
            sums = {}
            logs = {}
            for c in range(self.k):
                v = await tr.get(self.prefix + b"sum/%02d" % c)
                sums[c] = int.from_bytes(v or b"", "little")
                rows = await tr.get_range(self.prefix + b"log/%02d/" % c,
                                          self.prefix + b"log/%02d0" % c,
                                          limit=100_000)
                logs[c] = sum(int.from_bytes(v, "little") for _k, v in rows)
            return sums, logs
        sums, logs = await db.transact(read_all, max_retries=1000)
        for c in range(self.k):
            assert sums[c] == logs[c], \
                (f"counter {c}: atomic sum {sums[c]} != logged sum "
                 f"{logs[c]} — an atomic op was lost or half-applied")
        assert sum(sums.values()) > 0, "no atomic op landed"


class RandomMoveKeysWorkload(Workload):
    """Drive shard splits/moves/merges WHILE data workloads run
    (workloads/RandomMoveKeys.actor.cpp): correctness must survive layouts
    changing under live traffic; the composed Cycle + ConsistencyCheck
    workloads assert it."""

    name = "RandomMoveKeys"

    def __init__(self, interval: float = 3.0):
        self.interval = interval
        self.moves = 0

    async def start(self, db):
        loop = self.cluster.loop
        while self._time_left():
            await loop.delay(self.interval * (0.5 + self.rng.random()))
            cc = self.cluster.current_cc()
            if cc is None or not getattr(cc, "_initial_meta_done", False):
                continue
            info = cc.dbinfo
            b = list(info.shard_boundaries)
            teams = [list(t) for t in info.teams()]
            try:
                if len(b) > 1 and self.rng.coinflip(0.35):
                    # merge a random same-team boundary if one exists
                    cands = [i for i in range(len(b) - 1)
                             if teams[i] == teams[i + 1]]
                    if not cands:
                        continue
                    i = cands[self.rng.randint(0, len(cands) - 1)]
                    await cc._merge(i)
                else:
                    i = self.rng.randint(0, len(b) - 1)
                    lo = b[i]
                    hi = b[i + 1] if i + 1 < len(b) else None
                    async def sample(tr):
                        return await tr.get_range(
                            lo or b"\x00", hi or b"\xf0", limit=50)
                    rows = await db.transact(sample, max_retries=50)
                    if len(rows) < 2:
                        continue
                    split = rows[len(rows) // 2][0]
                    if split <= lo or (hi is not None and split >= hi):
                        continue
                    await cc._split_and_move(i, split)
                self.moves += 1
            except (FDBError, AssertionError):
                continue  # moves legitimately race recoveries/other moves

    async def check(self, db):
        assert self.moves > 0, "no shard was ever moved"


class IncrementWorkload(Workload):
    """Atomic counter increments with exact accounting
    (workloads/Increment.actor.cpp): every CONFIRMED transaction added
    exactly 1 to one of K counters; a per-transaction marker resolves
    commit_unknown_result, so at check() the counter total equals the
    confirmed count exactly — lost or doubled increments both fail."""

    name = "Increment"

    def __init__(self, n_counters: int = 5, prefix: bytes = b"incr/"):
        self.k = n_counters
        self.prefix = prefix
        self.confirmed = 0

    async def start(self, db):
        from foundationdb_tpu_torch.utils.types import MutationType
        it = 0
        while self._time_left():
            it += 1
            c = self.rng.randint(0, self.k - 1)
            marker = self.prefix + b"__m__"
            token = b"t%08d" % it

            async def fn(tr, c=c, token=token):
                tr.atomic_op(MutationType.ADD_VALUE,
                             self.prefix + b"c%02d" % c,
                             (1).to_bytes(8, "little"))
                tr.set(marker, token)
                return True
            try:
                if await self._commit_resolved(db, fn, marker, token):
                    self.confirmed += 1
            except FDBError:
                pass
            await self.cluster.loop.delay(0.01 * self.rng.random())

    async def check(self, db):
        assert self.confirmed > 0
        async def rd(tr):
            total = 0
            for c in range(self.k):
                v = await tr.get(self.prefix + b"c%02d" % c)
                total += int.from_bytes(v or b"", "little")
            return total
        total = await db.transact(rd, max_retries=1000)
        assert total == self.confirmed, \
            (f"increment accounting broken: counters sum {total}, "
             f"confirmed {self.confirmed}")


class SelectorCorrectnessWorkload(Workload):
    """Key-selector resolution vs a host model
    (workloads/SelectorCorrectness.actor.cpp): a FIXED key set, then random
    (or_equal, offset) selectors resolved by the database must match the
    model's walk over the sorted keys, including selectors inside
    uncommitted-write overlays."""

    name = "SelectorCorrectness"

    def __init__(self, n_keys: int = 20, prefix: bytes = b"sel/"):
        self.n = n_keys
        self.prefix = prefix
        self.checked = 0

    def key(self, i: int) -> bytes:
        return self.prefix + b"%04d" % i

    async def setup(self, db):
        async def fn(tr):
            for i in range(0, self.n, 2):  # only even keys exist
                tr.set(self.key(i), b"v")
        await db.transact(fn)

    def _model_resolve(self, keys, base, or_equal, offset):
        """The selector contract: start at the first key > base (or >= if
        not or_equal... the reference defines or_equal on the BASE), then
        move offset-1 forward / -offset back (workloads SelectorCorrectness
        uses the same arithmetic)."""
        import bisect
        if offset >= 1:
            start = bisect.bisect_right(keys, base) if or_equal \
                else bisect.bisect_left(keys, base)
            i = start + (offset - 1)
            if i < len(keys):
                return keys[i]
            return b"<end>"
        start = bisect.bisect_right(keys, base) if or_equal \
            else bisect.bisect_left(keys, base)
        i = start - (1 - offset)
        if i >= 0:
            return keys[i]
        return b"<begin>"

    async def start(self, db):
        from foundationdb_tpu_torch.server.interfaces import KeySelector
        keys = [self.key(i) for i in range(0, self.n, 2)]
        while self._time_left():
            base = self.key(self.rng.randint(0, self.n - 1))
            or_equal = self.rng.coinflip(0.5)
            offset = self.rng.randint(-2, 3)
            if offset == 0:
                offset = 1

            async def fn(tr, base=base, or_equal=or_equal, offset=offset):
                got = await tr.get_key(KeySelector(key=base,
                                                  or_equal=or_equal,
                                                  offset=offset))
                if not got.startswith(self.prefix):
                    got = b"<end>" if got > self.prefix else b"<begin>"
                want = self._model_resolve(keys, base, or_equal, offset)
                assert got == want, \
                    (f"selector({base}, or_equal={or_equal}, "
                     f"offset={offset}) = {got}, model {want}")
            try:
                tr = db.create_transaction()
                await fn(tr)
                tr.reset()
                self.checked += 1
            except FDBError:
                pass
            await self.cluster.loop.delay(0.01 * self.rng.random())

    async def check(self, db):
        assert self.checked > 10, f"only {self.checked} selectors checked"


class WatchesWorkload(Workload):
    """Watch semantics (workloads/Watches.actor.cpp): a watch on a key
    resolves when (and only when) the value changes; a watch armed on the
    CURRENT value does not fire spuriously."""

    name = "Watches"

    def __init__(self, prefix: bytes = b"watch/"):
        self.prefix = prefix
        self.fired = 0

    async def start(self, db):
        loop = self.cluster.loop
        it = 0
        while self._time_left():
            it += 1
            k = self.prefix + b"%02d" % self.rng.randint(0, 4)
            new_val = b"w%06d" % it

            # arm the watch (watch() registers at current value)
            tr = db.create_transaction()
            try:
                fut = await tr.watch(k)
            except FDBError:
                await loop.delay(0.2)
                continue

            async def write(tr2, k=k, new_val=new_val):
                tr2.set(k, new_val)
            try:
                await db.transact(write, max_retries=500)
            except FDBError:
                continue
            try:
                await loop.timeout(fut, 15.0)
                self.fired += 1
            except FDBError:
                pass  # watch lost to a recovery: the client re-arms
            await loop.delay(0.05 * self.rng.random())

    async def check(self, db):
        assert self.fired > 3, f"only {self.fired} watches fired"


class VersionStampWorkload(Workload):
    """Versionstamped keys (workloads/VersionStamp.actor.cpp): stamped keys
    materialize with the COMMIT version big-endian in the placeholder, so
    they sort in commit order and decode back to the version the commit
    reported."""

    name = "VersionStamp"

    def __init__(self, prefix: bytes = b"vs/"):
        self.prefix = prefix
        self.stamps: list[tuple[int, bytes]] = []  # (committed_version, tag)

    async def start(self, db):
        from foundationdb_tpu_torch.utils.types import MutationType
        it = 0
        while self._time_left():
            it += 1
            tag = b"%06d" % it
            body = self.prefix + b"\x00" * 10
            key = body + (len(self.prefix)).to_bytes(4, "little")
            tr = db.create_transaction()
            try:
                tr.atomic_op(MutationType.SET_VERSIONSTAMPED_KEY, key, tag)
                await tr.commit()
                self.stamps.append((tr.committed_version, tag))
            except FDBError:
                pass
            await self.cluster.loop.delay(0.02 * self.rng.random())

    async def check(self, db):
        assert len(self.stamps) > 5
        async def rd(tr):
            return await tr.get_range(self.prefix, self.prefix + b"\xff",
                                      limit=100_000)
        rows = await db.transact(rd, max_retries=1000)
        by_tag = {}
        for k, v in rows:
            stamp = k[len(self.prefix):]
            version = int.from_bytes(stamp[:8], "big")
            by_tag.setdefault(v, []).append(version)
        versions_in_key_order = [
            int.from_bytes(k[len(self.prefix):][:8], "big") for k, _v in rows]
        assert versions_in_key_order == sorted(versions_in_key_order), \
            "stamped keys not in commit order"
        for committed, tag in self.stamps:
            assert tag in by_tag, f"stamped row for {tag} missing"
            assert committed in by_tag[tag], \
                (f"stamp for {tag}: committed_version {committed} not in "
                 f"{by_tag[tag]} (stamp != reported commit version)")
