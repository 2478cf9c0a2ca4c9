"""Fuzz workload battery: the highest-value reference workloads we were
missing, ported onto the Workload/spec machinery.

Reference: fdbserver/workloads/ApiCorrectness.actor.cpp (random API ops vs an
in-memory model), Serializability.actor.cpp (concurrent histories replayed in
commit order), RYWPerformance/RyowCorrectness.actor.cpp (read-your-writes
overlay vs model), ChangeConfig.actor.cpp (live `configure` churn mid-load),
RemoveServersSafely.actor.cpp (exclusion drains before a kill), KillRegion
(configuration.rst region failover), and BackupToDBCorrectness /
BackupCorrectness.actor.cpp (live backup + restore byte-diff under faults).

Every workload draws randomness ONLY from its forked DeterministicRandom and
advances its host-side model ONLY for transactions proven to have landed
(marker probe via Workload._commit_resolved), so a failing (seed, spec) pair
replays identically.
"""

from __future__ import annotations

from foundationdb_tpu_torch.testing.workloads import Workload
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.trace import TraceEvent
from foundationdb_tpu_torch.utils.types import MutationType, apply_atomic_op

# atomic ops the fuzzers draw from (key-valued ops only: the versionstamp
# ops need placeholder-offset trailers and are covered by VersionStamp /
# Serializability's history rows)
_FUZZ_ATOMICS = (
    MutationType.ADD_VALUE, MutationType.AND, MutationType.OR,
    MutationType.XOR, MutationType.MAX, MutationType.MIN,
    MutationType.BYTE_MIN, MutationType.BYTE_MAX,
    MutationType.APPEND_IF_FITS,
)


class FuzzApiCorrectnessWorkload(Workload):
    """Random API ops (set/clear/clear_range/atomic-ops) committed against a
    host-side model dict (workloads/ApiCorrectness.actor.cpp). The model
    advances only for commits proven to have landed; interleaved read passes
    and the final check assert db == model byte-for-byte."""

    name = "FuzzApiCorrectness"

    def __init__(self, n_keys: int = 32, prefix: bytes = b"fuzz/"):
        self.n = n_keys
        self.prefix = prefix
        self.model: dict[bytes, bytes] = {}
        self.committed = 0
        self.reads_checked = 0
        self.atomics = 0

    def key(self, i: int) -> bytes:
        return self.prefix + b"%03d" % i

    def _draw_plan(self, rng):
        plan = []
        for _ in range(rng.randint(1, 5)):
            r = rng.random()
            i = rng.randint(0, self.n - 1)
            if r < 0.40:
                plan.append(("set", i, b"v%08d" % rng.randint(0, 1 << 26)))
            elif r < 0.55:
                plan.append(("clear", i, b""))
            elif r < 0.65:
                j = rng.randint(i, self.n)
                plan.append(("clear_range", i, b"%03d" % j))
            else:
                op = _FUZZ_ATOMICS[rng.randint(0, len(_FUZZ_ATOMICS) - 1)]
                width = (1, 4, 8)[rng.randint(0, 2)]
                operand = rng.randint(0, (1 << (8 * width)) - 1) \
                    .to_bytes(width, "little")
                plan.append(("atomic", i, (op, operand)))
        return plan

    def _apply_to_model(self, plan):
        for kind, i, arg in plan:
            k = self.key(i)
            if kind == "set":
                self.model[k] = arg
            elif kind == "clear":
                self.model.pop(k, None)
            elif kind == "clear_range":
                hi = self.prefix + arg
                for kk in [kk for kk in self.model if k <= kk < hi]:
                    del self.model[kk]
            else:
                op, operand = arg
                self.model[k] = apply_atomic_op(op, self.model.get(k),
                                                operand)

    async def _resync(self, db):
        async def rd(tr):
            return await tr.get_range(self.prefix, self.prefix + b"\xff",
                                      limit=self.n * 4)
        rows = await db.transact(rd, max_retries=500)
        self.model = {k: v for k, v in rows
                      if not k.endswith(b"__marker__")}

    async def start(self, db):
        marker = self.prefix + b"__marker__"
        it = 0
        while self._time_left():
            it += 1
            rng = self.rng
            if rng.coinflip(0.3):
                # read pass: point + range reads must match the model
                lo_i = rng.randint(0, self.n - 1)
                hi_i = rng.randint(lo_i + 1, self.n)

                async def rd(tr, lo_i=lo_i, hi_i=hi_i):
                    pt = await tr.get(self.key(lo_i))
                    rows = await tr.get_range(self.key(lo_i),
                                              self.prefix + b"%03d" % hi_i)
                    return pt, rows
                try:
                    pt, rows = await db.transact(rd, max_retries=500)
                except FDBError:
                    continue
                want_pt = self.model.get(self.key(lo_i))
                want = sorted((k, v) for k, v in self.model.items()
                              if self.key(lo_i) <= k < self.prefix
                              + b"%03d" % hi_i)
                assert pt == want_pt and list(rows) == want, \
                    (f"fuzz read diverged from model (iter {it}): "
                     f"{pt!r}/{rows} vs {want_pt!r}/{want}")
                self.reads_checked += 1
                continue
            plan = self._draw_plan(rng)
            token = b"t%08d" % it

            async def fn(tr, plan=plan, token=token):
                for kind, i, arg in plan:
                    k = self.key(i)
                    if kind == "set":
                        tr.set(k, arg)
                    elif kind == "clear":
                        tr.clear(k)
                    elif kind == "clear_range":
                        tr.clear_range(k, self.prefix + arg)
                    else:
                        tr.atomic_op(arg[0], k, arg[1])
                tr.set(marker, token)
                return True
            landed = await self._commit_resolved(db, fn, marker, token)
            if landed:
                self._apply_to_model(plan)
                self.committed += 1
                self.atomics += sum(1 for kind, _i, _a in plan
                                    if kind == "atomic")
            else:
                await self._resync(db)
            await self.cluster.loop.delay(0.02 * rng.random())

    async def check(self, db):
        assert self.committed > 0, "no fuzz transaction landed"
        assert self.reads_checked > 0, "no read pass ran (coverage bug)"
        assert self.atomics > 0, "no atomic op drawn (coverage bug)"

        async def rd(tr):
            return await tr.get_range(self.prefix, self.prefix + b"\xff",
                                      limit=self.n * 4)
        rows = await db.transact(rd, max_retries=1000)
        got = {k: v for k, v in rows if not k.endswith(b"__marker__")}
        assert got == self.model, \
            (f"final state diverged from model after {self.committed} "
             f"commits: missing={set(self.model) - set(got)} "
             f"extra={set(got) - set(self.model)} "
             f"diff={[k for k in got if self.model.get(k) != got[k]]}")


class ZipfianHotKeyWorkload(Workload):
    """Concurrent read-modify-write increments over a zipfian-skewed key
    population (rank 0 is the hot key): the contention generator behind the
    conflict-hotspot loop. Every landed commit adds exactly ONE to its key,
    so after quiesce each counter must equal the host-side count of proven
    commits — serializability under sustained write-write conflict. The skew
    concentrates conflicts on a narrow range, driving the resolver's
    hot-range sketch, the ratekeeper's throttle list and the proxy's
    transaction_throttled rejections (all retried inside _commit_resolved),
    so the spec exercises the whole contention-management loop under the
    same fault battery as every other spec."""

    name = "ZipfianHotKey"

    def __init__(self, n_keys: int = 16, n_actors: int = 6,
                 theta: float = 1.2, prefix: bytes = b"zipf/"):
        self.n = n_keys
        self.n_actors = n_actors
        self.prefix = prefix
        # zipfian CDF over ranks: P(rank i) ~ 1/(i+1)^theta
        w = [1.0 / float(i + 1) ** theta for i in range(n_keys)]
        tot = sum(w)
        acc = 0.0
        self.cdf = []
        for x in w:
            acc += x
            self.cdf.append(acc / tot)
        self.model = [0] * n_keys
        self.committed = 0
        self.attempts = 0

    def key(self, i: int) -> bytes:
        return self.prefix + b"%03d" % i

    def _draw_key(self, rng) -> int:
        r = rng.random()
        for i, c in enumerate(self.cdf):
            if r <= c:
                return i
        return self.n - 1

    async def _actor(self, db, aid: int, rng):
        marker = self.prefix + b"__marker%02d__" % aid
        it = 0
        while self._time_left():
            it += 1
            i = self._draw_key(rng)
            token = b"a%02d-%06d" % (aid, it)

            async def fn(tr, i=i, token=token):
                self.attempts += 1
                v = await tr.get(self.key(i))
                tr.set(self.key(i), b"%d" % (int(v or b"0") + 1))
                tr.set(marker, token)
                return True

            landed = await self._commit_resolved(db, fn, marker, token)
            if landed:
                self.model[i] += 1
                self.committed += 1
            await self.cluster.loop.delay(0.01 * rng.random())

    async def start(self, db):
        # one forked rng per actor, drawn up front: the actors interleave on
        # the deterministic sim loop, so per-actor streams keep the whole
        # run a pure function of the seed
        rngs = [self.rng.fork() for _ in range(self.n_actors)]
        tasks = [self.cluster.loop.spawn(self._actor(db, a, rngs[a]),
                                         f"zipf{a}")
                 for a in range(self.n_actors)]
        for t in tasks:
            await t

    async def check(self, db):
        assert self.committed > 0, "no zipfian increment landed"
        assert self.attempts > self.committed, \
            "no retry pressure: the hot key never drew a conflict"

        async def rd(tr):
            return await tr.get_range(self.prefix, self.prefix + b"\xff",
                                      limit=self.n * 4)
        rows = await db.transact(rd, max_retries=1000)
        got = {k: v for k, v in rows if b"__marker" not in k}
        want = {self.key(i): b"%d" % c
                for i, c in enumerate(self.model) if c}
        assert got == want, (
            f"counters diverged from proven-commit counts after "
            f"{self.committed} commits / {self.attempts} attempts: "
            f"got={got} want={want}")


class ZipfianReadHotspotWorkload(Workload):
    """Read-heavy zipfian skew against replicated storage: writer actors
    RMW-increment a narrow hot key set (proven via _commit_resolved markers,
    so the host ledger counts exactly the landed commits) while reader
    actors hammer the same keys through the client's replica-balanced read
    path and the storage-side versioned hot-key cache.

    The readers keep, per key, the highest-version observation seen so far
    and compare every new (read_version, counter) pair against it:

      v2 == v1  =>  c2 == c1   (two reads at one version must agree — a
                                divergent replica or a stale cache entry
                                surfaces here)
      v2 >  v1  =>  c2 >= c1   (counters only grow; a lower counter at a
                                higher version is a lost or stale read)
      v2 <  v1  =>  c2 <= c1   (a read at an OLDER version returning a
                                newer counter means a replica or cache
                                served data from the future)

    Because the battery runs clogging + attrition, the observations span
    shard moves, replica catch-up after recoveries, and cache
    invalidation/rebuild — exactly the windows where a fencing bug would
    leak a wrong-version value. After quiesce, the final counters must
    equal the proven-commit ledger, and (when the cache knob is on) the
    storage roles must report cache hits: the hot path actually engaged."""

    name = "ZipfianReadHotspot"

    def __init__(self, n_keys: int = 8, n_writers: int = 2,
                 n_readers: int = 4, theta: float = 1.2,
                 prefix: bytes = b"zrh/"):
        self.n = n_keys
        self.n_writers = n_writers
        self.n_readers = n_readers
        self.prefix = prefix
        w = [1.0 / float(i + 1) ** theta for i in range(n_keys)]
        tot = sum(w)
        acc = 0.0
        self.cdf = []
        for x in w:
            acc += x
            self.cdf.append(acc / tot)
        self.model = [0] * n_keys
        self.committed = 0
        self.reads = 0
        self.distinct_versions = 0
        self.cache_hits_seen = 0
        # per-key highest-version observation: key index -> (version, count)
        self._best: dict[int, tuple[int, int]] = {}

    def key(self, i: int) -> bytes:
        return self.prefix + b"%03d" % i

    def _draw_key(self, rng) -> int:
        r = rng.random()
        for i, c in enumerate(self.cdf):
            if r <= c:
                return i
        return self.n - 1

    async def setup(self, db):
        async def fn(tr):
            for i in range(self.n):
                tr.set(self.key(i), b"0")
        await db.transact(fn)

    def _observe(self, i: int, version: int, count: int):
        """Fold one (read_version, counter) sighting into the per-key
        monotonicity invariant."""
        prev = self._best.get(i)
        if prev is None:
            self._best[i] = (version, count)
            return
        v1, c1 = prev
        if version == v1:
            assert count == c1, (
                f"replica/cache divergence on key {i}: two reads at "
                f"version {version} returned {c1} and {count}")
        elif version > v1:
            assert count >= c1, (
                f"stale read on key {i}: version {version} > {v1} but "
                f"counter went {c1} -> {count}")
            if count > c1:
                self.distinct_versions += 1
            self._best[i] = (version, count)
        else:
            assert count <= c1, (
                f"future leak on key {i}: version {version} < {v1} but "
                f"counter {count} > {c1} seen at the newer version")

    async def _writer(self, db, aid: int, rng):
        marker = self.prefix + b"__marker%02d__" % aid
        it = 0
        while self._time_left():
            it += 1
            i = self._draw_key(rng)
            token = b"w%02d-%06d" % (aid, it)

            async def fn(tr, i=i, token=token):
                v = await tr.get(self.key(i))
                tr.set(self.key(i), b"%d" % (int(v or b"0") + 1))
                tr.set(marker, token)
                return True

            if await self._commit_resolved(db, fn, marker, token):
                self.model[i] += 1
                self.committed += 1
            await self.cluster.loop.delay(0.05 * (0.5 + rng.random()))

    async def _reader(self, db, rng):
        retryable = ("transaction_too_old", "future_version", "timed_out",
                     "transaction_throttled", "proxies_changed",
                     "cluster_not_fully_recovered", "operation_failed",
                     "wrong_shard_server", "request_maybe_delivered",
                     "broken_promise", "all_alternatives_failed")
        while self._time_left():
            ks = sorted({self._draw_key(rng)
                         for _ in range(rng.randint(1, 4))})
            tr = db.create_transaction()
            try:
                vals = await tr.get_many([self.key(i) for i in ks],
                                         snapshot=True)
                version = await tr.get_read_version()
            except FDBError as e:
                if e.name in retryable:
                    await self.cluster.loop.delay(
                        0.1 * (0.5 + rng.random()))
                    continue
                raise
            for i, val in zip(ks, vals):
                self._observe(i, version, int(val or b"0"))
            self.reads += len(ks)
            await self.cluster.loop.delay(0.01 * rng.random())

    def _sample_cache_hits(self) -> int:
        from foundationdb_tpu_torch.server.storage import StorageServer
        hits = 0
        for p in self.cluster.storage_worker_procs:
            w = getattr(p, "worker", None)
            if w is None or not p.alive:
                continue
            for role in w.roles.values():
                # rc.hits is the live tally; the CounterCollection copy only
                # syncs on a STORAGE_METRICS fetch, so read the source
                if isinstance(role, StorageServer) \
                        and role._read_cache is not None:
                    hits += role._read_cache.hits
        return hits

    async def _cache_monitor(self):
        """Attrition + the quiesce recovery re-create storage roles (fresh
        counter collections), so the post-quiesce ledger can legitimately
        read 0: sample the live roles DURING the run and keep the peak."""
        while self._time_left():
            self.cache_hits_seen = max(self.cache_hits_seen,
                                       self._sample_cache_hits())
            await self.cluster.loop.delay(0.5)

    async def start(self, db):
        rngs = [self.rng.fork()
                for _ in range(self.n_writers + self.n_readers)]
        tasks = [self.cluster.loop.spawn(self._writer(db, a, rngs[a]),
                                         f"zrhW{a}")
                 for a in range(self.n_writers)]
        tasks += [self.cluster.loop.spawn(
                      self._reader(db, rngs[self.n_writers + r]),
                      f"zrhR{r}")
                  for r in range(self.n_readers)]
        tasks.append(self.cluster.loop.spawn(self._cache_monitor(),
                                             "zrhCache"))
        for t in tasks:
            await t

    async def check(self, db):
        from foundationdb_tpu_torch.utils.knobs import KNOBS
        assert self.committed > 0, "no hot-key increment landed"
        assert self.reads > 0, "readers made no progress"
        assert self.distinct_versions > 0, \
            "readers never saw a counter advance: no read/write overlap"

        async def rd(tr):
            return await tr.get_range(self.prefix, self.prefix + b"\xff",
                                      limit=self.n * 4)
        rows = await db.transact(rd, max_retries=1000)
        got = {k: v for k, v in rows if b"__marker" not in k}
        want = {self.key(i): b"%d" % c for i, c in enumerate(self.model)}
        assert got == want, (
            f"final counters diverged from the proven-commit ledger after "
            f"{self.committed} commits / {self.reads} reads: "
            f"got={got} want={want}")

        # the cache must have ENGAGED when the knob is on (the spec pins
        # hot-rate/sample knobs so the skew crosses the sketch's bar);
        # buggify can flip the knob off, in which case hits stay 0 by design
        if KNOBS.READ_CACHE_ENABLED:
            hits = max(self.cache_hits_seen, self._sample_cache_hits())
            assert hits > 0, (
                f"read cache never hit across {self.reads} skewed reads "
                f"with READ_CACHE_ENABLED on")


class SerializabilityWorkload(Workload):
    """Concurrent register transactions leave a versionstamped history row
    per commit recording (reads seen, writes made); after quiesce the rows —
    sorted by key, i.e. by commit version — must replay as a SERIAL history
    against a model (workloads/Serializability.actor.cpp). Each transaction's
    recorded reads must equal the model state at its commit point: exactly
    the strict-serializability guarantee the resolver enforces."""

    name = "Serializability"

    def __init__(self, n_regs: int = 8, prefix: bytes = b"ser/"):
        self.k = n_regs
        self.prefix = prefix
        self.attempted = 0

    def reg(self, i: int) -> bytes:
        return self.prefix + b"r%02d" % i

    async def setup(self, db):
        async def fn(tr):
            for i in range(self.k):
                tr.set(self.reg(i), b"%08d" % 0)
        await db.transact(fn)

    async def start(self, db):
        while self._time_left():
            rng = self.rng
            n_read = rng.randint(1, 3)
            read_idx = sorted({rng.randint(0, self.k - 1)
                               for _ in range(n_read)})
            write_idx = sorted({read_idx[rng.randint(0, len(read_idx) - 1)],
                                rng.randint(0, self.k - 1)})
            salt = rng.randint(0, 1 << 20)

            async def fn(tr, read_idx=read_idx, write_idx=write_idx,
                         salt=salt):
                vals = []
                for i in read_idx:
                    vals.append(int(await tr.get(self.reg(i))))
                newv = (sum(vals) * 31 + salt) % 100_000_000
                for i in write_idx:
                    tr.set(self.reg(i), b"%08d" % newv)
                rec = b"r=" + b",".join(
                    b"%02d:%08d" % (i, v)
                    for i, v in zip(read_idx, vals)) + \
                    b";w=" + b",".join(b"%02d" % i for i in write_idx) + \
                    b";v=%08d" % newv
                # history key gets the commit versionstamp: rows sort in
                # commit order, and even a duplicated unknown-result retry
                # produces its own (still serially-consistent) row
                body = self.prefix + b"h/" + b"\x00" * 10
                key = body + (len(body) - 10).to_bytes(4, "little")
                tr.atomic_op(MutationType.SET_VERSIONSTAMPED_KEY, key, rec)
            try:
                await db.transact(fn, max_retries=1000)
                self.attempted += 1
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise
            await self.cluster.loop.delay(0.02 * self.rng.random())

    async def check(self, db):
        assert self.attempted > 0, "no serializability transaction ran"

        async def rd(tr):
            regs = [int(await tr.get(self.reg(i))) for i in range(self.k)]
            hist = await tr.get_range(self.prefix + b"h/",
                                      self.prefix + b"h0", limit=1_000_000)
            return regs, hist
        regs, hist = await db.transact(rd, max_retries=1000)
        assert hist, "no history row committed"
        model = [0] * self.k
        for n, (_key, rec) in enumerate(hist):
            r_part, w_part, v_part = rec.split(b";")
            for item in r_part[2:].split(b","):
                i, v = item.split(b":")
                assert model[int(i)] == int(v), \
                    (f"history row {n} read reg {int(i)}={int(v)} but the "
                     f"serial replay has {model[int(i)]}: the concurrent "
                     f"history is NOT equivalent to commit order")
            newv = int(v_part[2:])
            for i in w_part[2:].split(b","):
                model[int(i)] = newv
        assert regs == model, \
            f"final registers {regs} != serial replay {model}"


class RyowCorrectnessWorkload(Workload):
    """A single transaction interleaves writes (set/clear/clear_range) with
    reads (get/get_range); every read must see the transaction's OWN prior
    writes overlaid on the committed state (workloads/RyowCorrectness
    pattern). The committed model advances only for proven commits."""

    name = "RyowCorrectness"

    def __init__(self, n_keys: int = 24, prefix: bytes = b"ryow/"):
        self.n = n_keys
        self.prefix = prefix
        self.model: dict[bytes, bytes] = {}
        self.committed = 0
        self.ryw_hits = 0  # reads that observed an own-write

    def key(self, i: int) -> bytes:
        return self.prefix + b"%03d" % i

    def _draw_ops(self, rng):
        ops = []
        written: set[int] = set()
        hits = 0
        for _ in range(rng.randint(4, 10)):
            r = rng.random()
            i = rng.randint(0, self.n - 1)
            if r < 0.30:
                ops.append(("set", i, b"w%08d" % rng.randint(0, 1 << 26)))
                written.add(i)
            elif r < 0.42:
                ops.append(("clear", i, 0))
                written.add(i)
            elif r < 0.52:
                j = rng.randint(i + 1, self.n)
                ops.append(("clear_range", i, j))
                written.update(range(i, j))
            elif r < 0.80:
                if written and rng.coinflip(0.6):
                    i = sorted(written)[rng.randint(0, len(written) - 1)]
                    hits += 1
                ops.append(("get", i, 0))
            else:
                j = rng.randint(i + 1, self.n)
                ops.append(("get_range", i, j))
                if any(i <= w < j for w in written):
                    hits += 1
        return ops, hits

    async def _resync(self, db):
        async def rd(tr):
            return await tr.get_range(self.prefix, self.prefix + b"\xff",
                                      limit=self.n * 4)
        rows = await db.transact(rd, max_retries=500)
        self.model = {k: v for k, v in rows
                      if not k.endswith(b"__marker__")}

    async def start(self, db):
        marker = self.prefix + b"__marker__"
        it = 0
        while self._time_left():
            it += 1
            rng = self.rng
            ops, hits = self._draw_ops(rng)
            token = b"t%08d" % it

            async def fn(tr, ops=ops, token=token):
                ov = dict(self.model)
                for kind, a, b in ops:
                    k = self.key(a)
                    if kind == "set":
                        tr.set(k, b)
                        ov[k] = b
                    elif kind == "clear":
                        tr.clear(k)
                        ov.pop(k, None)
                    elif kind == "clear_range":
                        hi = self.key(b)
                        tr.clear_range(k, hi)
                        for kk in [kk for kk in ov if k <= kk < hi]:
                            del ov[kk]
                    elif kind == "get":
                        got = await tr.get(k)
                        assert got == ov.get(k), \
                            (f"RYW get({k!r}) = {got!r}, overlay says "
                             f"{ov.get(k)!r} (ops {ops})")
                    else:
                        hi = self.key(b)
                        rows = await tr.get_range(k, hi)
                        want = sorted((kk, vv) for kk, vv in ov.items()
                                      if k <= kk < hi)
                        assert list(rows) == want, \
                            (f"RYW get_range[{k!r},{hi!r}) = {rows}, "
                             f"overlay says {want} (ops {ops})")
                tr.set(marker, token)
                return ov
            ov = await self._commit_resolved(db, fn, marker, token)
            if ov is not None:
                self.model = ov
                self.committed += 1
                self.ryw_hits += hits
            else:
                await self._resync(db)
            await self.cluster.loop.delay(0.02 * rng.random())

    async def check(self, db):
        assert self.committed > 0, "no RYW transaction landed"
        assert self.ryw_hits > 0, \
            "no read ever observed an own-write (coverage bug)"

        async def rd(tr):
            return await tr.get_range(self.prefix, self.prefix + b"\xff",
                                      limit=self.n * 4)
        rows = await db.transact(rd, max_retries=1000)
        got = {k: v for k, v in rows if not k.endswith(b"__marker__")}
        assert got == self.model, "final state diverged from RYW model"


class ChangeConfigWorkload(Workload):
    """Live `configure` churn while data workloads run
    (workloads/ChangeConfig.actor.cpp): the txn-subsystem shape (proxies /
    tlogs / resolvers) is rewritten mid-load; each change makes the CC
    trigger a recovery onto the new shape and traffic must ride through."""

    name = "ChangeConfig"

    def __init__(self, interval: float = 6.0):
        self.interval = interval
        self.changes = 0
        self.last: dict = {}

    async def start(self, db):
        from foundationdb_tpu_torch.client import management
        loop = self.cluster.loop
        # recruitment needs max(n_proxies, n_resolvers) stateless workers
        # plus tlog hosts: cap the draw so a change can always recruit
        nw = len(getattr(self.cluster, "worker_procs", [])) or 5
        hi = max(1, min(3, nw - 2))
        while self._time_left():
            await loop.delay(self.interval * (0.5 + self.rng.random()))
            r = self.rng.random()
            if r < 0.4:
                params = {"n_proxies": self.rng.randint(1, hi)}
            elif r < 0.8:
                params = {"n_tlogs": self.rng.randint(1, hi)}
            else:
                params = {"n_resolvers": self.rng.randint(1, min(2, hi))}
            try:
                await management.configure(db, **params)
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise
                continue
            self.changes += 1
            self.last.update(params)
            TraceEvent("ChangeConfigApplied", "workload") \
                .detail("Params", str(params)).log()

    async def check(self, db):
        from foundationdb_tpu_torch.client import management
        assert self.changes > 0, "no configure ever committed"
        conf = await management.get_configuration(db)
        for k, v in self.last.items():
            assert conf.get(k) == v, \
                f"\\xff/conf lost {k}: wanted {v}, holds {conf.get(k)}"
        # the cluster must converge onto the last written shape (the CC
        # reads conf each DD round and recovers into it)
        want_proxies = self.last.get("n_proxies")
        if want_proxies is not None:
            for _ in range(240):
                cc = self.cluster.current_cc()
                if cc is not None \
                        and len(cc.dbinfo.proxies) == want_proxies:
                    break
                await self.cluster.loop.delay(0.5)
            cc = self.cluster.current_cc()
            assert cc is not None \
                and len(cc.dbinfo.proxies) == want_proxies, \
                (f"cluster never recovered onto n_proxies={want_proxies}: "
                 f"{len(cc.dbinfo.proxies) if cc else None}")


class RemoveServersSafelyWorkload(Workload):
    """Exclude a storage worker under load, wait for the DD to drain every
    shard off it, kill it (now safe: it holds no data), then include it back
    (workloads/RemoveServersSafely.actor.cpp). Requires spare storage
    workers so healing has somewhere to re-replicate."""

    name = "RemoveServersSafely"

    def __init__(self, drain_wait: float = 90.0):
        self.drain_wait = drain_wait
        self.excluded = 0
        self.drained = 0

    async def start(self, db):
        from foundationdb_tpu_torch.client import management
        from foundationdb_tpu_torch.core.sim import KillType
        c = self.cluster
        loop = c.loop
        while self._time_left():
            await loop.delay(2.0 + 3.0 * self.rng.random())
            cc = c.current_cc()
            if cc is None:
                continue
            storages = cc.dbinfo.storages
            if len({a for a, _t in storages}) < 2:
                continue
            victim = storages[self.rng.randint(0, len(storages) - 1)][0]
            try:
                await management.exclude_servers(db, [victim])
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise
                continue
            self.excluded += 1
            deadline = loop.now() + self.drain_wait
            drained = False
            while loop.now() < deadline:
                await loop.delay(0.5)
                cc = c.current_cc()
                if cc is None:
                    continue
                info = cc.dbinfo
                victim_tags = {t for a, t in info.storages if a == victim}
                if victim_tags and not any(
                        t in team for t in victim_tags
                        for team in info.teams()):
                    drained = True
                    break
            if drained:
                self.drained += 1
                # now the kill is safe: the server holds no shard
                proc = c.net.processes.get(victim)
                if proc is not None and proc.alive:
                    c.net.kill(victim, KillType.RebootProcess)
                TraceEvent("RemovedServerSafely", "workload") \
                    .detail("Victim", victim).log()
            try:
                await management.include_servers(db, [victim])
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise

    async def check(self, db):
        assert self.excluded > 0, "no exclusion was ever written"
        assert self.drained > 0, \
            "no exclusion ever drained (DD healing never completed)"


class KillRegionWorkload(Workload):
    """Region loss under load (configuration.rst regions; the KillRegion
    test spec): kill every process in one datacenter — standby, satellite,
    or the PRIMARY itself (the satellite log means no acked commit is lost)
    — let the survivors fail over, then reboot the region and let it
    rejoin. Requires a two-region cluster."""

    name = "KillRegion"

    def __init__(self, first_delay: float = 6.0):
        self.first_delay = first_delay
        self.kills = 0
        self.killed_dcs: list[str] = []

    async def start(self, db):
        c = self.cluster
        loop = c.loop
        await loop.delay(self.first_delay)
        while self._time_left():
            r = self.rng.random()
            dc = "dc1" if r < 0.4 else ("sat0" if r < 0.7 else "dc0")
            victims = [p for p in c.net.processes.values()
                       if p.dc_id == dc and p.alive]
            if victims:
                TraceEvent("KillRegion", "workload").detail("DC", dc).log()
                c.kill_dc(dc)
                self.kills += 1
                self.killed_dcs.append(dc)
            await loop.delay(6.0 + 6.0 * self.rng.random())
            c.net.reboot_dead([p.address for p in victims])
            await loop.delay(4.0 + 4.0 * self.rng.random())

    async def check(self, db):
        assert self.kills > 0, "no region was ever killed"


class BackupUnderAttritionWorkload(Workload):
    """Live backup while the spec's fault workloads kill and clog the
    cluster (BackupCorrectness.actor.cpp under Attrition): snapshot chunks +
    the mutation-log tee run to completion through the faults; check()
    restores into a fresh cluster on the same simulation and byte-diffs this
    workload's keyspace against the source. The writer quiesces BEFORE the
    backup stops, so the source's final bk/ rows ARE the end-version truth
    (no pinned-version read racing the MVCC window)."""

    name = "BackupAttrition"

    def __init__(self, n_keys: int = 40, chunks: int = 3,
                 prefix: bytes = b"bk/"):
        self.n = n_keys
        self.chunks = chunks
        self.prefix = prefix
        self.container = None
        self.end_version = 0
        self.writes = 0

    async def setup(self, db):
        async def fn(tr):
            for i in range(self.n):
                tr.set(self.prefix + b"%03d" % i, b"v%d" % i)
        await db.transact(fn, max_retries=500)

    async def start(self, db):
        from foundationdb_tpu_torch.backup import BackupAgent, BackupContainer
        loop = self.cluster.loop
        self.container = BackupContainer()
        agent = BackupAgent(db, self.container, chunks=self.chunks)
        await agent.start()

        state = {"stop": False}

        async def writer():
            n = 0
            while not state["stop"]:
                async def w(tr, n=n):
                    tr.set(self.prefix + b"%03d" % (n % self.n),
                           b"updated%d" % n)
                    if n % 5 == 0:
                        tr.clear(self.prefix + b"%03d"
                                 % ((n * 7) % self.n))
                    tr.atomic_op(MutationType.ADD_VALUE,
                                 self.prefix + b"counter",
                                 (1).to_bytes(8, "little"))
                try:
                    await db.transact(w, max_retries=500)
                    self.writes += 1
                except FDBError as e:
                    if e.name == "operation_cancelled":
                        raise
                n += 1
                await loop.delay(0.1)
        wtask = loop.spawn(writer(), name="bkWriter")

        a1 = loop.spawn(agent.run_agent(), name="bkAgent")
        tailer = loop.spawn(agent.run_log_tailer(), name="bkTailer")
        await a1
        await loop.delay(1.0)  # a few more teed writes past the snapshot
        state["stop"] = True
        await wtask  # writer fully quiesced BEFORE the backup's end version
        self.end_version = await agent.stop()
        await tailer

    async def check(self, db):
        from foundationdb_tpu_torch.backup import RestoreAgent
        from foundationdb_tpu_torch.server.cluster import SimCluster
        assert self.writes > 0, "no live writes landed during the backup"
        assert self.end_version > 0, "backup never produced an end version"
        c = self.cluster

        async def rd(tr):
            return await tr.get_range(self.prefix, self.prefix + b"\xff")
        truth = await db.transact(rd, max_retries=1000)

        dst = SimCluster(seed=self.rng.randint(0, 1 << 30), n_proxies=1,
                         n_resolvers=1, n_tlogs=1, n_storage=1,
                         loop=c.loop, net=c.net, name_prefix="bkrestore-")
        db2 = dst.database()
        await RestoreAgent(db2, self.container).restore()
        got = await db2.transact(rd, max_retries=500)
        assert got == truth, (
            f"restore mismatch on {self.prefix!r}: {len(got)} vs "
            f"{len(truth)} rows; missing={set(dict(truth)) - set(dict(got))} "
            f"extra={set(dict(got)) - set(dict(truth))}")
