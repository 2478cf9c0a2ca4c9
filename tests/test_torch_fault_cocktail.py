"""tests/test_fault_cocktail.py, tests/test_redundancy.py,
tests/test_replication.py and tests/test_restarting.py on both packages,
seed for seed.

Each reference test runs `run_spec` with its workloads and faults, or its
own scenario on a RecoverableCluster (a replica killed for good, a storage
worker lost and healed by data distribution, a divergence injected into
one replica, a whole cluster restarted from its files on the memory, ssd
and redwood engines); here the same run goes through the port and through
the JAX package, and the two records must be equal exactly (the result,
every attempt and DBInfo with its virtual time, each workload's counters
and faults, the final contents; see test_torch_sim_tiers.py). The
reference's own assertions then hold on the port's run. The cocktails
under the device and sharded backends run the port's plain PyTorch
engines against the JAX engines.
"""

import pytest

from foundationdb_tpu.utils import types as j_types
from foundationdb_tpu_torch.utils import types as t_types
from test_torch_sim_tiers import (  # noqa: F401 — the autouse fixture
    PORT, _knobs, assert_same_records, both, record, set_knobs)

# the reference fixtures' backend, and test_fault_cocktail.py's engine shape
ORACLE = dict(CONFLICT_BACKEND="oracle")
ENGINE_SHAPE = dict(CONFLICT_BATCH_TXNS=16, CONFLICT_BATCH_READS_PER_TXN=2,
                    CONFLICT_BATCH_WRITES_PER_TXN=2,
                    CONFLICT_STATE_CAPACITY=2048)
TYPES = {"port": t_types, "jax": j_types}


def spec(seed, build, **kw):
    """A go function: run_spec(seed, workloads=build(S), **kw) on the
    stack S, returning the SpecResult and the workloads."""
    def go(S):
        workloads = build(S) if build is not None else None
        return S.wl.run_spec(seed, workloads=workloads, **kw), workloads
    return go


def run_both(seed, build, **kw):
    port = both(spec(seed, build, **kw))
    result, workloads = port.result
    return result, workloads, port


# ---------------------------------------------------------------------------
# tests/test_fault_cocktail.py (Cycle + clogging + attrition, buggified)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [101, 202, 303])
def test_cycle_with_clogging_and_attrition(seed):
    set_knobs(**ORACLE)
    r, _w, _p = run_both(seed, None, duration=45.0)
    assert r.rotations > 0


def test_swizzled_cycle():
    set_knobs(**ORACLE)
    r, _w, _p = run_both(7, lambda S: [S.wl.CycleWorkload(),
                                       S.wl.SwizzleCloggingWorkload()],
                         duration=40.0)
    assert r.rotations > 0


def test_spec_runs_are_deterministic():
    """Same seed => identical outcome, on the port twice and on JAX."""
    set_knobs(**ORACLE)
    _r, _w, first = run_both(55, None, duration=30.0)
    PORT.knobs.reset()
    PORT.knobs.overrides(CONFLICT_DEVICE="cpu", **ORACLE)
    assert_same_records(record(PORT, spec(55, None, duration=30.0)), first)


def test_cycle_cocktail_with_sharded_backend():
    """The recruited cluster on the sharded engine (two shards) through
    clogging and attrition; recoveries re-instantiate the engine."""
    set_knobs(CONFLICT_BACKEND="sharded", CONFLICT_NUM_SHARDS=2,
              **ENGINE_SHAPE)
    r, _w, port = run_both(17, None, duration=30.0, buggify=False)
    assert r.rotations > 0 and len(port.epochs) >= 1


def test_cycle_cocktail_with_device_backend():
    """The recruited cluster serving live commits through the device
    engine, with the pipelined resolver drain, through clogging and
    attrition."""
    set_knobs(CONFLICT_BACKEND="device", **ENGINE_SHAPE)
    r, _w, _p = run_both(23, None, duration=30.0, buggify=False)
    assert r.rotations > 0


# ---------------------------------------------------------------------------
# tests/test_redundancy.py
# ---------------------------------------------------------------------------

def test_storage_loss_heals_and_stays_consistent():
    """A storage worker killed for good mid-run: DD re-replicates its
    shards onto a replacement, and every replica holds the same rows."""
    set_knobs(DD_STORAGE_FAILURE_SECONDS=4.0, DD_INTERVAL_SECONDS=1.0,
              **ORACLE)

    def go(S):
        c = S.cluster.RecoverableCluster(
            seed=71, n_workers=4, n_proxies=2, n_tlogs=2, n_storage=2,
            n_replicas=2, n_storage_workers=5)
        db = c.database()

        async def t():
            await db.refresh()

            async def seed(tr):
                for i in range(60):
                    tr.set(b"%02x-key" % i, b"val%d" % i)
            await db.transact(seed, max_retries=500)
            victim = c.storage_worker_procs[0].address
            c.net.kill(victim, S.sim.KillType.KillProcess)
            for rnd in range(60):
                async def w(tr, rnd=rnd):
                    tr.set(b"live/%03d" % rnd, b"x")
                await db.transact(w, max_retries=500)
                await c.loop.delay(0.3)
                info = c.current_cc()
                if info is None:
                    continue
                dead = {t for a, t in info.dbinfo.storages if a == victim}
                teams = info.dbinfo.teams()
                if dead and not any(t in team for t in dead
                                    for team in teams):
                    break
            info = c.current_cc().dbinfo
            dead = {t for a, t in info.storages if a == victim}
            for team in info.teams():
                assert not (dead & set(team)), info.teams()
                assert len(team) == 2, team

            async def readall(tr):
                return await tr.get_range(b"", b"\xff")
            rows = await db.transact(readall, max_retries=500)
            keys = {k for k, _v in rows}
            assert all(b"%02x-key" % i in keys for i in range(60))
            w = S.wl.ConsistencyCheckWorkload()
            w.init(c, S.cluster.DeterministicRandom(1), stop_at=0)
            await w.check(db)
            return len(rows)

        return c.run(c.loop.spawn(t()), max_time=240_000.0)

    port = both(go)
    assert port.result >= 60


def test_cycle_with_storage_attrition_heals():
    set_knobs(DD_STORAGE_FAILURE_SECONDS=4.0, DD_INTERVAL_SECONDS=1.0,
              **ORACLE)

    def go(S):
        return S.wl.run_spec(
            909, workloads=[S.wl.CycleWorkload(), S.wl.AttritionWorkload(),
                            S.wl.ConsistencyCheckWorkload()],
            duration=45.0, buggify=False, n_replicas=2, n_storage_workers=5)

    port = both(go)
    assert port.result.rotations > 0


# ---------------------------------------------------------------------------
# tests/test_replication.py
# ---------------------------------------------------------------------------

def test_reads_survive_replica_kill():
    set_knobs(**ORACLE)

    def go(S):
        c = S.cluster.RecoverableCluster(
            seed=41, n_workers=4, n_proxies=1, n_tlogs=2, n_storage=2,
            n_replicas=2, n_storage_workers=4)
        db = c.database()

        async def t():
            await db.refresh()

            async def setup(tr):
                for i in range(12):
                    tr.set(bytes([20 * i]) + b"/r", b"v%02d" % i)
            await db.transact(setup)
            info = c.current_cc().dbinfo
            addr_of_tag = {t: a for a, t in info.storages}
            c.net.kill(addr_of_tag[info.shard_tags[0][0]])

            async def read_all(tr):
                rows = await tr.get_range(b"", b"\xff")
                return [(k, v) for k, v in rows if k.endswith(b"/r")]
            rows = await db.transact(read_all, max_retries=300)
            assert len(rows) == 12, len(rows)

            async def more(tr):
                tr.set(b"\x01after", b"yes")
            await db.transact(more, max_retries=300)

            async def readback(tr):
                return await tr.get(b"\x01after")
            return await db.transact(readback, max_retries=300)

        return c.run(c.loop.spawn(t()), max_time=30_000.0)

    assert both(go).result == b"yes"


def test_replica_consistency_after_fault_cocktail():
    set_knobs(**ORACLE)

    def go(S):
        return S.wl.run_spec(
            88, workloads=[S.wl.CycleWorkload(),
                           S.wl.RandomCloggingWorkload(),
                           S.wl.AttritionWorkload(interval=10.0),
                           S.wl.ConsistencyCheckWorkload()],
            duration=40.0, n_replicas=2, n_storage=2)

    assert both(go).result.rotations > 0


def test_consistency_check_detects_divergence():
    """The checker fails, on both packages alike, when one replica holds a
    rogue write."""
    set_knobs(**ORACLE)

    def go(S):
        c = S.cluster.RecoverableCluster(
            seed=43, n_workers=4, n_proxies=1, n_tlogs=1, n_storage=1,
            n_replicas=2, n_storage_workers=2)
        db = c.database()
        types = TYPES[S.name]

        async def t():
            await db.refresh()

            async def setup(tr):
                tr.set(b"k", b"v")
            await db.transact(setup)
            info = c.current_cc().dbinfo
            addr_of_tag = {t: a for a, t in info.storages}
            tag0 = info.shard_tags[0][0]
            ss = c.net.processes[addr_of_tag[tag0]].worker.roles[
                f"storage:{tag0}"]
            ss.data.apply(ss.version.get(), types.Mutation(
                types.MutationType.SET_VALUE, b"rogue", b"divergent"))
            w = S.wl.ConsistencyCheckWorkload()
            w.init(c, c.rng.fork(), 0)
            try:
                await w.check(db)
            except AssertionError as e:
                return str(e)
            return None

        return c.run(c.loop.spawn(t()), max_time=30_000.0)

    port = both(go)
    assert port.result is not None and "diverges" in port.result


# ---------------------------------------------------------------------------
# tests/test_restarting.py
# ---------------------------------------------------------------------------

async def _await_recovered(S, c, db, max_polls: int = 600):
    for _ in range(max_polls):
        if c.current_cc() is not None:
            try:
                async def probe(tr):
                    await tr.get(b"\x00restart-probe")
                await db.transact(probe, max_retries=50)
                return
            except S.errors.FDBError:
                pass
        await c.loop.delay(0.5)
    raise AssertionError("cluster never re-recovered after restart")


def restart_spec(seed, tmp_path, n_replicas=1, n_storage_workers=None,
                 half=12.0):
    """A go function: half the Cycle -> the whole cluster restarted from
    its files -> the second half -> quiesce -> the checks. Each package
    keeps its sqlite files in its own directory."""
    def go(S):
        data_dir = tmp_path / S.name
        data_dir.mkdir(exist_ok=True)
        S.knobs.set("SSD_DATA_DIR", str(data_dir))
        rng = S.cluster.DeterministicRandom(seed)
        c = S.cluster.RecoverableCluster(
            seed=rng.randint(0, 1 << 30), n_workers=5, n_proxies=2,
            n_tlogs=2, n_storage=2, n_replicas=n_replicas,
            n_storage_workers=n_storage_workers)
        db = c.database()
        cyc = S.wl.CycleWorkload()
        cons = S.wl.ConsistencyCheckWorkload()

        async def scenario():
            await db.refresh(max_wait=120.0)
            cyc.init(c, rng.fork(), c.loop.now() + half)
            cons.init(c, rng.fork(), c.loop.now() + half)
            await cyc.setup(db)
            await cyc.start(db)
            first_half = cyc.rotations
            assert first_half > 0, "no progress before the restart"
            await S.wl.quiet_database(c, db)
            c.restart_from_disk()
            await _await_recovered(S, c, db)
            cyc.stop_at = c.loop.now() + half
            await cyc.start(db)
            assert cyc.rotations > first_half, "no progress after restart"
            c.net.heal()
            c.net.reboot_dead([p.address for p in c.cluster_procs()])
            await S.wl.quiet_database(c, db)
            await cyc.check(db)
            await cons.check(db)
            return first_half, cyc.rotations

        return c.run(c.loop.spawn(scenario()), max_time=600_000.0)
    return go


def restart_both(engine, seed, tmp_path, **kw):
    set_knobs(STORAGE_ENGINE=engine, **ORACLE)
    go = restart_spec(seed, tmp_path, **kw)
    return both(go)


def test_restart_from_disk_memory_engine(tmp_path):
    first, total = restart_both("memory", 701, tmp_path).result
    assert 0 < first < total


def test_restart_from_disk_ssd_engine(tmp_path):
    first, total = restart_both("ssd", 702, tmp_path).result
    assert 0 < first < total


def test_restart_from_disk_redwood_engine(tmp_path):
    # the first half flushes runs and compacts them before the plug is
    # pulled: the restart recovers run files and replays the WAL
    set_knobs(REDWOOD_MEMTABLE_BYTES=4_096, REDWOOD_BLOCK_BYTES=512,
              REDWOOD_COMPACTION_FAN_IN=2)
    first, total = restart_both("redwood", 704, tmp_path).result
    assert 0 < first < total


@pytest.mark.slow
def test_restart_from_disk_double_replication(tmp_path):
    first, total = restart_both("memory", 703, tmp_path, n_replicas=2,
                                n_storage_workers=4, half=15.0).result
    assert 0 < first < total
