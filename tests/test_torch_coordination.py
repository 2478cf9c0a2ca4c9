"""The reference's coordination, management, replication, fitness, data
distribution and two-region tests on the port, each held to the JAX
package.

Each test is its counterpart in tests/test_coordination.py,
test_management.py (configure, exclude and include),
test_replication_policy.py, test_fitness.py, test_datadistribution.py or
test_tworegion.py, with the same seed, knobs and checks, run on the port.
A test that drives a simulation runs it on the JAX package too, and the
two runs must be equal: a RecoverableCluster's record (every attempt's
outcome, every published DBInfo, the final contents and the virtual end
time; test_torch_recovery.py), or what a coordination test observes and
the virtual time it ends at. The policy tests compare the port's answers
with the JAX module's on the same inputs.
"""

from foundationdb_tpu.core import eventloop as j_eventloop
from foundationdb_tpu.server import coordination as j_coordination
from foundationdb_tpu.server import replication as j_replication
from foundationdb_tpu.utils import rng as j_rng
from foundationdb_tpu_torch.core import eventloop as t_eventloop
from foundationdb_tpu_torch.server import coordination as t_coordination
from foundationdb_tpu_torch.server import replication as t_replication
from foundationdb_tpu_torch.utils import rng as t_rng
from test_torch_recovery import (JAX, PORT, STACKS, both, check_ring,
                                 setup_ring, set_knobs, two_region_client)
from test_torch_recovery import _knobs  # noqa: F401  (autouse, both banks)

for S, ev, co, rep, rn in ((PORT, t_eventloop, t_coordination, t_replication,
                            t_rng),
                           (JAX, j_eventloop, j_coordination, j_replication,
                            j_rng)):
    S.eventloop, S.coordination, S.replication, S.rng = ev, co, rep, rn


def on_both(fn):
    """fn(S) on the port and on the JAX package; equal results."""
    port, jax = (fn(S) for S in STACKS)
    assert port == jax
    return port


# ---------------------------------------------------------------------------
# test_coordination.py
# ---------------------------------------------------------------------------

def _mk(S, n_coord=3, seed=1):
    loop = S.eventloop.EventLoop()
    net = S.sim.SimNetwork(loop, S.rng.DeterministicRandom(seed))
    coords = []
    for i in range(n_coord):
        p = net.new_process(f"coord:{i}")
        S.coordination.Coordinator(p)
        coords.append(p.address)
    return loop, net, coords


def test_coordinated_state_read_write():
    def run(S):
        loop, net, coords = _mk(S)
        cs = S.coordination.CoordinatedStateClient(
            net.new_process("client:0"), coords)
        result = {}

        async def t():
            v0, g0 = await cs.read()
            assert v0 is None
            await cs.write({"epoch": 1, "tlogs": ["a"]})
            v1, g1 = await cs.read()
            result["v"] = v1
            result["gens"] = (g0, g1)

        loop.run_future(loop.spawn(t()), max_time=60.0)
        assert result["v"] == {"epoch": 1, "tlogs": ["a"]}
        return result, loop.now()
    on_both(run)


def test_coordinated_state_survives_coordinator_minority_failure():
    def run(S):
        loop, net, coords = _mk(S)
        cs = S.coordination.CoordinatedStateClient(
            net.new_process("client:0"), coords)
        result = {}

        async def t():
            await cs.write({"epoch": 2})
            net.kill(coords[0], S.sim.KillType.KillProcess)
            v, _ = await cs.read()
            result["v"] = v
            await cs.write({"epoch": 3})
            v2, _ = await cs.read()
            result["v2"] = v2

        loop.run_future(loop.spawn(t()), max_time=60.0)
        assert result["v"] == {"epoch": 2}
        assert result["v2"] == {"epoch": 3}
        return result, loop.now()
    on_both(run)


def test_coordinated_state_majority_failure_blocks():
    def run(S):
        loop, net, coords = _mk(S)
        cs = S.coordination.CoordinatedStateClient(
            net.new_process("client:0"), coords)
        result = {}

        async def t():
            net.kill(coords[0], S.sim.KillType.KillProcess)
            net.kill(coords[1], S.sim.KillType.KillProcess)
            try:
                await cs.write({"epoch": 9})
                result["r"] = "wrote"
            except S.errors.FDBError as e:
                result["r"] = e.name

        loop.run_future(loop.spawn(t()), max_time=60.0)
        assert result["r"] == "coordinators_changed"
        return result, loop.now()
    on_both(run)


def test_competing_writers_serialize():
    def run(S):
        loop, net, coords = _mk(S)
        CSC = S.coordination.CoordinatedStateClient
        a = CSC(net.new_process("writer:a"), coords)
        b = CSC(net.new_process("writer:b"), coords)
        outcomes = {}

        async def writer(name, cs, value):
            try:
                await cs.write(value)
                outcomes[name] = "ok"
            except S.errors.FDBError as e:
                outcomes[name] = e.name

        t1 = loop.spawn(writer("a", a, {"who": "a"}))
        t2 = loop.spawn(writer("b", b, {"who": "b"}))
        loop.run_future(S.future.all_of([t1, t2]), max_time=60.0)
        reader = CSC(net.new_process("reader:0"), coords)
        out = {}

        async def check():
            v, _ = await reader.read()
            out["v"] = v

        loop.run_future(loop.spawn(check()), max_time=60.0)
        assert out["v"] in ({"who": "a"}, {"who": "b"})
        return outcomes, out, loop.now()
    on_both(run)


def test_leader_election_converges_and_fails_over():
    def run(S):
        loop, net, coords = _mk(S)
        w1 = net.new_process("worker:1")
        w2 = net.new_process("worker:2")
        state = {}
        elect = S.coordination.elect_leader

        async def candidate(proc, prio, key):
            await elect(proc, coords, priority=prio, lease_seconds=3.0,
                        poll_interval=0.5)
            state[key] = loop.now()
            while proc.alive:
                await elect(proc, coords, priority=prio, lease_seconds=3.0,
                            poll_interval=0.5)
                await loop.delay(1.0)

        net.processes["worker:1"].spawn(candidate(w1, 10, "w1_leader"))
        net.processes["worker:2"].spawn(candidate(w2, 5, "w2_leader"))
        client = net.new_process("client:0")
        seen = {}

        async def observe():
            await loop.delay(2.0)
            seen["first"] = await S.coordination.get_leader(client, coords)
            net.kill("worker:1", S.sim.KillType.KillProcess)
            await loop.delay(8.0)
            seen["second"] = await S.coordination.get_leader(client, coords)

        loop.run_future(loop.spawn(observe()), max_time=120.0)
        assert seen["first"] == "worker:1"
        assert seen["second"] == "worker:2"
        return seen, state, loop.now()
    on_both(run)


# ---------------------------------------------------------------------------
# test_management.py (configure, exclude, include)
# ---------------------------------------------------------------------------

def management_knobs():
    set_knobs(DD_INTERVAL_SECONDS=1.0, DD_STORAGE_FAILURE_SECONDS=4.0)


def test_configure_replication_live_change():
    management_knobs()

    async def scenario(S, c, db):
        await db.refresh()

        async def seed(tr):
            for i in range(40):
                tr.set(b"c%02d" % i, b"v%d" % i)
        await db.transact(seed, max_retries=500)

        await S.management.configure(db, n_replicas=2)
        conf = await S.management.get_configuration(db)
        assert conf["n_replicas"] == 2
        for _ in range(120):
            await c.loop.delay(0.5)
            cc = c.current_cc()
            if cc and all(len(t_) == 2 for t_ in cc.dbinfo.teams()):
                break
        assert all(len(t_) == 2 for t_ in c.current_cc().dbinfo.teams())

        await S.management.configure(db, n_replicas=1)
        for _ in range(120):
            await c.loop.delay(0.5)
            cc = c.current_cc()
            if cc and all(len(t_) == 1 for t_ in cc.dbinfo.teams()):
                break
        assert all(len(t_) == 1 for t_ in c.current_cc().dbinfo.teams())

        async def readall(tr):
            return await tr.get_range(b"c", b"d")
        rows = await db.transact(readall, max_retries=500)
        assert len(rows) == 40
        return conf

    def make(S):
        return S.cluster.RecoverableCluster(
            seed=61, n_workers=4, n_proxies=1, n_tlogs=2, n_storage=2,
            n_replicas=1, n_storage_workers=5)
    both(scenario, make, 300_000.0)


def test_configure_proxies_triggers_recovery():
    management_knobs()

    async def scenario(S, c, db):
        await db.refresh()
        epoch0 = c.current_cc().dbinfo.epoch
        await S.management.configure(db, n_proxies=2)
        for _ in range(120):
            await c.loop.delay(0.5)
            cc = c.current_cc()
            if cc and cc.dbinfo.epoch > epoch0 \
                    and len(cc.dbinfo.proxies) == 2:
                break
        info = c.current_cc().dbinfo
        assert len(info.proxies) == 2, info.proxies
        assert info.epoch > epoch0

        async def w(tr):
            tr.set(b"after-configure", b"1")
        await db.transact(w, max_retries=500)
        return info.epoch

    def make(S):
        return S.cluster.RecoverableCluster(
            seed=62, n_workers=5, n_proxies=1, n_tlogs=2, n_storage=1,
            n_replicas=1)
    both(scenario, make, 300_000.0)


def test_exclude_drains_server_and_include_restores():
    management_knobs()

    async def scenario(S, c, db):
        await db.refresh()

        async def seed(tr):
            for i in range(40):
                tr.set(b"e%02d" % i, b"v%d" % i)
        await db.transact(seed, max_retries=500)

        victim = c.current_cc().dbinfo.storages[0][0]
        await S.management.exclude_servers(db, [victim])
        assert victim in await S.management.excluded_servers(db)

        for _ in range(160):
            await c.loop.delay(0.5)
            cc = c.current_cc()
            if cc is None:
                continue
            info = cc.dbinfo
            victim_tags = {t for a, t in info.storages if a == victim}
            if not any(t in team for t in victim_tags
                       for team in info.teams()):
                break
        info = c.current_cc().dbinfo
        victim_tags = {t for a, t in info.storages if a == victim}
        for team in info.teams():
            assert not (victim_tags & set(team)), info.teams()
            assert len(team) == 2

        async def readall(tr):
            return await tr.get_range(b"e", b"f")
        rows = await db.transact(readall, max_retries=500)
        assert len(rows) == 40

        await S.management.include_servers(db, [victim])
        excluded = await S.management.excluded_servers(db)
        assert victim not in excluded
        return victim, excluded

    def make(S):
        return S.cluster.RecoverableCluster(
            seed=63, n_workers=4, n_proxies=1, n_tlogs=2, n_storage=2,
            n_replicas=2, n_storage_workers=5)
    both(scenario, make, 300_000.0)


# ---------------------------------------------------------------------------
# test_replication_policy.py
# ---------------------------------------------------------------------------

def L(S, z, dc="dc0", m=None):
    return S.replication.LocalityData(process_id=f"{z}-{m or z}", zone_id=z,
                                      machine_id=m or z, dc_id=dc)


def test_policy_validate():
    def run(S):
        R = S.replication
        triple = R.PolicyAcross(3, "zoneid")
        out = [triple.validate([L(S, "z1"), L(S, "z2"), L(S, "z3")]),
               triple.validate([L(S, "z1"), L(S, "z1"), L(S, "z2")]),
               triple.validate([L(S, "z1"), L(S, "z1"), L(S, "z2"),
                                L(S, "z3")])]
        two_dc = R.PolicyAcross(2, "dcid", R.PolicyAcross(2, "zoneid"))
        out += [two_dc.validate([L(S, "z1", "dcA"), L(S, "z2", "dcA"),
                                 L(S, "z3", "dcB"), L(S, "z4", "dcB")]),
                two_dc.validate([L(S, "z1", "dcA"), L(S, "z2", "dcA"),
                                 L(S, "z3", "dcB"), L(S, "z3", "dcB")])]
        both_ = R.PolicyAnd((R.PolicyAcross(2, "zoneid"),
                             R.PolicyAcross(2, "dcid")))
        out += [both_.validate([L(S, "z1", "dcA"), L(S, "z2", "dcB")]),
                both_.validate([L(S, "z1", "dcA"), L(S, "z2", "dcA")])]
        assert out == [True, False, True, True, False, True, False]
        return out
    on_both(run)


def test_select_replicas_prefers_distinct_zones():
    def run(S):
        R = S.replication
        cands = [("a", L(S, "z1")), ("b", L(S, "z1")), ("c", L(S, "z2")),
                 ("d", L(S, "z3"))]
        picks = R.select_replicas(R.PolicyAcross(3, "zoneid"), cands)
        assert picks is not None
        zones = {dict(cands)[a].zone_id for a in picks}
        assert len(zones) == 3
        none = R.select_replicas(R.PolicyAcross(3, "zoneid"),
                                 [("a", L(S, "z1")), ("b", L(S, "z1")),
                                  ("c", L(S, "z2"))])
        assert none is None
        return picks
    on_both(run)


def test_select_replicas_with_already():
    def run(S):
        R = S.replication
        cands = [("c", L(S, "z1")), ("d", L(S, "z2")), ("e", L(S, "z3"))]
        picks = R.select_replicas(R.PolicyAcross(2, "zoneid"), cands,
                                  already=[("a", L(S, "z1"))])
        assert picks is not None and len(picks) == 1
        assert dict(cands)[picks[0]].zone_id != "z1"
        return picks
    on_both(run)


def test_nested_policy_selection():
    def run(S):
        R = S.replication
        cands = [("a", L(S, "z1", "dcA")), ("b", L(S, "z2", "dcA")),
                 ("c", L(S, "z1b", "dcA")),
                 ("d", L(S, "z3", "dcB")), ("e", L(S, "z4", "dcB"))]
        pol = R.PolicyAcross(2, "dcid", R.PolicyAcross(2, "zoneid"))
        picks = R.select_replicas(pol, cands)
        assert picks is not None
        assert pol.validate([dict(cands)[a] for a in picks]), picks
        return picks, R.policy_for_replication(2), R.policy_for_replication(3)
    port, jax = (run(S) for S in STACKS)
    assert port[0] == jax[0]
    assert repr(port[1:]) == repr(jax[1:]).replace(
        "foundationdb_tpu.", "foundationdb_tpu_torch.")


def test_cluster_places_teams_across_zones():
    set_knobs(DD_INTERVAL_SECONDS=1.0, DD_STORAGE_FAILURE_SECONDS=4.0)

    def make(S):
        c = S.cluster.RecoverableCluster(
            seed=92, n_workers=4, n_proxies=1, n_tlogs=2, n_storage=2,
            n_replicas=2, n_storage_workers=6)
        for i, p in enumerate(c.storage_worker_procs):
            p.machine_id = f"machine{i // 2}"
        return c

    async def scenario(S, c, db):
        def zone_of(cc, addr):
            return cc.registry.locality_of(addr).zone_id

        await db.refresh()
        cc = c.current_cc()
        for _ in range(30):
            await c.loop.delay(1.0)
            cc = c.current_cc()
            if cc and len(getattr(cc.registry, "localities", {})) >= 6:
                break
        info = cc.dbinfo
        addr_of = {t_: a for a, t_ in info.storages}
        for team in info.teams():
            zones = {zone_of(cc, addr_of[t_]) for t_ in team}
            assert len(zones) == 2, (team, zones)

        victim = addr_of[info.teams()[0][0]]
        c.net.kill(victim, S.sim.KillType.KillProcess)
        for _ in range(120):
            await c.loop.delay(0.5)
            cc = c.current_cc()
            if cc is None:
                continue
            info = cc.dbinfo
            vt = {t_ for a, t_ in info.storages if a == victim}
            if not any(t_ in team for t_ in vt for team in info.teams()):
                break
        info = c.current_cc().dbinfo
        addr_of = {t_: a for a, t_ in info.storages}
        cc = c.current_cc()
        zones = []
        for team in info.teams():
            z = sorted({zone_of(cc, addr_of[t_]) for t_ in team})
            assert len(z) == 2, (team, z)
            zones.append(z)
        return victim, zones
    both(scenario, make, 240_000.0)


# ---------------------------------------------------------------------------
# test_fitness.py
# ---------------------------------------------------------------------------

def fitness_knobs():
    set_knobs(CC_PREEMPT_INTERVAL_SECONDS=2.0)


def test_preemption_migrates_roles_to_better_worker():
    fitness_knobs()

    def make(S):
        c = S.cluster.RecoverableCluster(
            seed=81, n_workers=3, n_proxies=1, n_resolvers=1, n_tlogs=2,
            n_storage=1, n_replicas=1)
        for p in c.worker_procs:
            p.worker.process_class = "transaction"
        return c

    async def scenario(S, c, db):
        await db.refresh()
        info0 = c.current_cc().dbinfo
        assert info0.master in [p.address for p in c.worker_procs]
        c.add_worker("newbie:0", ["stateless"], process_class="stateless")
        for _ in range(60):
            await c.loop.delay(1.0)
            cc = c.current_cc()
            if cc and cc.dbinfo.epoch > info0.epoch \
                    and cc.dbinfo.master == "newbie:0":
                break
        info = c.current_cc().dbinfo
        assert info.master == "newbie:0", info.master
        assert "newbie:0" in info.proxies, info.proxies

        async def w(tr):
            tr.set(b"after-preempt", b"1")
        await db.transact(w, max_retries=500)
        assert info.epoch <= info0.epoch + 3, info.epoch
        return info.epoch
    both(scenario, make, 300_000.0)


def test_recruitment_prefers_best_class():
    fitness_knobs()

    def make(S):
        c = S.cluster.RecoverableCluster(
            seed=82, n_workers=2, n_proxies=1, n_resolvers=1, n_tlogs=1,
            n_storage=1, n_replicas=1)
        c.worker_procs[0].worker.process_class = "transaction"
        c.worker_procs[1].worker.process_class = "stateless"
        return c

    async def scenario(S, c, db):
        await db.refresh()
        for _ in range(60):
            await c.loop.delay(1.0)
            cc = c.current_cc()
            if (cc and cc.dbinfo.master == c.worker_procs[1].address
                    and cc.dbinfo.log_epochs[-1].addrs
                    == [c.worker_procs[0].address]):
                break
        info = c.current_cc().dbinfo
        assert info.master == c.worker_procs[1].address, info.master
        tlogs = info.log_epochs[-1].addrs
        assert tlogs == [c.worker_procs[0].address], tlogs
        return info.master, list(tlogs)
    both(scenario, make, 300_000.0)


# ---------------------------------------------------------------------------
# test_datadistribution.py
# ---------------------------------------------------------------------------

def test_oversized_shard_splits_and_moves_under_load():
    set_knobs(DD_SHARD_SPLIT_BYTES=4_000, DD_INTERVAL_SECONDS=1.0)

    def make(S):
        return S.cluster.RecoverableCluster(
            seed=91, n_workers=4, n_proxies=2, n_tlogs=2, n_storage=2,
            n_replicas=1)

    async def scenario(S, c, db):
        state = {"writing": True, "extra": 0}

        async def background_writer():
            i = 0
            while state["writing"]:
                async def w(tr, i=i):
                    tr.set(b"\x30hot/%04d" % i, b"x" * 40)
                await db.transact(w, max_retries=500)
                state["extra"] += 1
                i += 1
                await c.loop.delay(0.05)

        await db.refresh()
        info0 = c.current_cc().dbinfo
        assert len(info0.shard_boundaries) == 2
        writer = c.loop.spawn(background_writer(), name="bgWriter")
        for batch in range(10):
            async def fill(tr, batch=batch):
                for j in range(20):
                    tr.set(b"\x10k%02d-%02d" % (batch, j), b"y" * 180)
            await db.transact(fill, max_retries=500)
        for _ in range(120):
            info = c.current_cc().dbinfo
            if len(info.shard_boundaries) > 2:
                break
            await c.loop.delay(0.5)
        info = c.current_cc().dbinfo
        assert len(info.shard_boundaries) > 2, "no split happened"
        teams = info.teams()
        assert len(set(map(tuple, teams))) >= 2
        assert any(tuple(teams[j]) != tuple(teams[j + 1])
                   for j in range(len(teams) - 1)), teams
        state["writing"] = False
        await writer

        async def read_all(tr):
            return await tr.get_range(b"", b"\xff")
        rows = await db.transact(read_all, max_retries=500)
        keys = {k for k, _v in rows}
        for batch in range(10):
            for j in range(20):
                assert b"\x10k%02d-%02d" % (batch, j) in keys
        hot = [k for k in keys if k.startswith(b"\x30hot/")]
        assert len(hot) == state["extra"]
        return state["extra"], [list(t) for t in teams]
    both(scenario, make, 120_000.0)


def test_split_survives_recovery():
    set_knobs(DD_SHARD_SPLIT_BYTES=4_000, DD_INTERVAL_SECONDS=1.0)

    def make(S):
        return S.cluster.RecoverableCluster(
            seed=92, n_workers=4, n_proxies=1, n_tlogs=2, n_storage=2,
            n_replicas=1)

    async def scenario(S, c, db):
        await db.refresh()

        async def fill(tr):
            for j in range(60):
                tr.set(b"\x10s%03d" % j, b"z" * 150)
        await db.transact(fill, max_retries=300)
        for _ in range(120):
            info = c.current_cc().dbinfo
            if len(info.shard_boundaries) > 2:
                break
            await c.loop.delay(0.5)
        info = c.current_cc().dbinfo
        assert len(info.shard_boundaries) > 2, "no split happened"
        n_before = len(info.shard_boundaries)
        epoch0 = info.epoch
        c.net.kill(info.master)
        for _ in range(200):
            cc = c.current_cc()
            if cc is not None and cc.dbinfo.epoch > epoch0:
                break
            await c.loop.delay(0.5)
        cc = c.current_cc()
        assert cc is not None and cc.dbinfo.epoch > epoch0
        assert len(cc.dbinfo.shard_boundaries) == n_before

        async def read_all(tr):
            return await tr.get_range(b"\x10", b"\x11")
        rows = await db.transact(read_all, max_retries=500)
        assert len(rows) == 60
        return n_before, cc.dbinfo.epoch
    both(scenario, make, 120_000.0)


def test_small_adjacent_shards_merge_back():
    set_knobs(DD_SHARD_SPLIT_BYTES=4_000, DD_SHARD_MERGE_BYTES=2_000,
              DD_INTERVAL_SECONDS=1.0)

    def make(S):
        return S.cluster.RecoverableCluster(
            seed=93, n_workers=4, n_proxies=1, n_tlogs=2, n_storage=1,
            n_replicas=1)

    async def scenario(S, c, db):
        await db.refresh()

        async def fill(tr):
            for j in range(60):
                tr.set(b"m%03d" % j, b"z" * 150)
        await db.transact(fill, max_retries=300)
        for _ in range(120):
            if len(c.current_cc().dbinfo.shard_boundaries) > 1:
                break
            await c.loop.delay(0.5)
        n_split = len(c.current_cc().dbinfo.shard_boundaries)
        assert n_split > 1, "no split happened"

        async def clear(tr):
            tr.clear_range(b"m", b"n")
        await db.transact(clear, max_retries=300)

        async def keep(tr):
            tr.set(b"keeper", b"1")
        await db.transact(keep, max_retries=300)
        for _ in range(240):
            if len(c.current_cc().dbinfo.shard_boundaries) < n_split:
                break
            await c.loop.delay(0.5)
        n_merged = len(c.current_cc().dbinfo.shard_boundaries)
        assert n_merged < n_split, "no merge happened"

        async def read(tr):
            return await tr.get(b"keeper")
        assert await db.transact(read, max_retries=300) == b"1"
        return n_split, n_merged
    both(scenario, make, 240_000.0)


def test_merge_after_move_coalesces_storage_ranges():
    set_knobs(DD_SHARD_SPLIT_BYTES=4_000, DD_SHARD_MERGE_BYTES=2_000,
              DD_INTERVAL_SECONDS=1.0)

    def make(S):
        return S.cluster.RecoverableCluster(
            seed=94, n_workers=4, n_proxies=1, n_tlogs=2, n_storage=2,
            n_replicas=1)

    async def scenario(S, c, db):
        await db.refresh()

        async def fill(tr):
            for j in range(40):
                tr.set(b"\x10f%03d" % j, b"z" * 150)

        async def fill2(tr):
            for j in range(40, 80):
                tr.set(b"\x10f%03d" % j, b"z" * 150)
        await db.transact(fill, max_retries=300)
        await db.transact(fill2, max_retries=300)
        for _ in range(200):
            info = c.current_cc().dbinfo
            teams = [tuple(t) for t in info.teams()]
            moved = any(teams[j] == teams[j + 1] for j in
                        range(len(teams) - 1)) and len(set(teams)) > 1 \
                and len(teams) >= 4
            if moved:
                break
            await c.loop.delay(0.5)
        assert len(c.current_cc().dbinfo.shard_boundaries) >= 3, "no splits"

        async def clear(tr):
            tr.clear_range(b"\x10", b"\x11")
        await db.transact(clear, max_retries=300)

        async def keep(tr):
            for kb in (b"\x20a", b"\x55b", b"\x81c", b"\xc0d"):
                tr.set(kb, b"v")
        await db.transact(keep, max_retries=300)
        n_now = len(c.current_cc().dbinfo.shard_boundaries)
        for _ in range(240):
            if len(c.current_cc().dbinfo.shard_boundaries) < n_now:
                break
            await c.loop.delay(0.5)
        assert len(c.current_cc().dbinfo.shard_boundaries) < n_now, \
            "no merge happened"
        await c.loop.delay(5.0)

        async def span(tr):
            return await tr.get_range(b"\x11", b"\xff")
        rows = await db.transact(span, max_retries=100)
        assert {k for k, _v in rows} >= {b"\x20a", b"\x55b", b"\x81c",
                                         b"\xc0d"}, rows
        return [tuple(kv) for kv in rows]
    both(scenario, make, 240_000.0)


# ---------------------------------------------------------------------------
# test_tworegion.py (the cases that need no testing/ harness; its device
# backend failover is in test_torch_recovery.py)
# ---------------------------------------------------------------------------

def two_region(seed):
    def make(S):
        return S.cluster.RecoverableCluster.two_region(seed=seed)
    return make


def test_satellite_log_set_in_commit_quorum():
    async def scenario(S, c, db):
        await db.refresh()
        await db.transact(setup_ring)
        await check_ring(db, max_retries=500)
        ep = c.current_cc().dbinfo.log_epochs[-1]
        assert ep.n_primary == 1 and len(ep.addrs) == 2, ep
        prim, sat = ep.addrs[0], ep.addrs[1]
        assert c.net.processes[prim].dc_id == "dc0"
        assert c.net.processes[sat].dc_id == "sat0"
        host = c.net.processes[sat].worker.roles["tloghost"]
        t_sat = host.generations[ep.uids[1]]
        assert t_sat.version.get() > 0
        assert any(t_sat.messages.values()) or t_sat.popped
        return prim, sat, t_sat.version.get()
    both(scenario, two_region(41), 60_000.0, make_db=two_region_client)


def test_remote_region_replicates_async_via_log_routers():
    async def scenario(S, c, db):
        await db.refresh()
        await db.transact(setup_ring)
        remote = [p for p in c.storage_worker_procs if p.dc_id == "dc1"]
        assert remote
        ss = None
        for _ in range(100):
            for p in remote:
                for k, role in getattr(p.worker, "roles", {}).items():
                    if k.startswith("storage:"):
                        ss = role
            if ss is not None:
                break
            await c.loop.delay(0.2)
        assert ss is not None, "no remote storage recruited"
        ep = ss.log_epochs[-1]
        assert len(ep.addrs) == 1 \
            and c.net.processes[ep.addrs[0]].dc_id == "dc1", ep
        assert ep.uids and "lr" in ep.uids[0]
        for _ in range(200):
            v = ss.version.get()
            if v > 0 and all(ss.data.get(b"cycle/%02d" % i, v) is not None
                             for i in range(5)):
                break
            await c.loop.delay(0.2)
        v = ss.version.get()
        ring = {i: int(ss.data.get(b"cycle/%02d" % i, v)) for i in range(5)}
        assert set(ring.values()) == set(range(5)), ring
        return v, ring
    both(scenario, two_region(42), 60_000.0, make_db=two_region_client)


def test_region_failover_loses_no_acked_commit():
    from test_torch_recovery import region_failover_scenario
    port = both(region_failover_scenario(8), two_region(43), 120_000.0,
                make_db=two_region_client)
    cc = port.cluster.current_cc()
    ep = cc.dbinfo.log_epochs[-1]
    np_ = ep.n_primary or len(ep.addrs)
    assert all(port.cluster.net.processes[a].dc_id == "dc1"
               for a in ep.addrs[:np_]), ep

