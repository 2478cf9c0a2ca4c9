"""The port's DR agent against the JAX package's.

tests/test_dr.py's three tests run on both packages: two SimClusters on one
loop and network from the same seed, a DRAgent replicating the first into
the second under live writes (and, in the third, under clogs and kills on
both clusters), then a switchover. Each run records every attempt's
outcome with its virtual time (test_torch_recovery.py's Recorder), the
snapshot and fence versions, both clusters' contents at the end (the
destination's system rows included: the applied-version watermark and the
primary marker) and the virtual end time. The records must be equal,
exactly, and the reference test's own checks then hold on the port's run.
"""

from types import SimpleNamespace

import pytest

import test_torch_recovery as rec
from foundationdb_tpu.backup import agent as j_agent
from foundationdb_tpu.backup import dr as j_dr
from foundationdb_tpu.core import eventloop as j_eventloop
from foundationdb_tpu.utils import rng as j_rng
from foundationdb_tpu.utils import types as j_types
from foundationdb_tpu_torch.backup import agent as t_agent
from foundationdb_tpu_torch.backup import dr as t_dr
from foundationdb_tpu_torch.core import eventloop as t_eventloop
from foundationdb_tpu_torch.utils import rng as t_rng
from foundationdb_tpu_torch.utils import types as t_types

# test_torch_coordination.py adds names to rec.PORT and rec.JAX when it
# is imported: extend copies of whatever they hold
PORT = SimpleNamespace(**{**vars(rec.PORT), **dict(
    dr=t_dr, agent=t_agent, eventloop=t_eventloop, rng=t_rng, types=t_types)})
JAX = SimpleNamespace(**{**vars(rec.JAX), **dict(
    dr=j_dr, agent=j_agent, eventloop=j_eventloop, rng=j_rng, types=j_types)})

_knobs = rec._knobs  # the autouse fixture: both banks on the oracle


def two_clusters(S, seed=5):
    loop = S.eventloop.EventLoop()
    rng = S.rng.DeterministicRandom(seed)
    net = S.sim.SimNetwork(loop, rng.fork())
    a = S.cluster.SimCluster(seed=seed, n_proxies=2, n_storage=2, loop=loop,
                             net=net, name_prefix="a-")
    b = S.cluster.SimCluster(seed=seed + 1, n_storage=2, loop=loop, net=net,
                             name_prefix="b-")
    return loop, a, b


async def read_user_rows(db):
    async def rd(tr):
        return await tr.get_range(b"", b"\xff", limit=100_000)
    return await db.transact(rd, max_retries=500)


async def read_everything(db):
    async def rd(tr):
        return await tr.get_range(b"", b"\xff\xff", limit=100_000)
    return await db.transact(rd, max_retries=500)


def record(S, go):
    with pytest.MonkeyPatch.context() as mp:
        r = rec.Recorder(S, mp)
        result = go(S, r)
    return SimpleNamespace(attempts=r.attempts, result=result)


def both(go):
    port = record(PORT, go)
    jax = record(JAX, go)
    assert port.attempts == jax.attempts
    assert port.result == jax.result
    assert port.attempts
    return port


def replicate_scenario(S, r):
    MutationType = S.types.MutationType
    loop, a, b = two_clusters(S)
    r.loop = loop
    src = a.database("clientA:0")
    dst = b.database("clientB:0")
    agent = S.dr.DRAgent(src, dst, chunk_rows=50)

    async def t():
        async def seed(tr):
            for i in range(120):
                tr.set(b"pre/%04d" % i, b"v%04d" % i)
        await src.transact(seed)

        await agent.start()
        v0 = await agent.initial_snapshot()
        tail = loop.spawn(agent.run(), name="drTail")

        async def live(tr):
            for i in range(40):
                tr.set(b"live/%04d" % i, b"L%04d" % i)
            tr.clear_range(b"pre/0000", b"pre/0010")
            tr.atomic_op(MutationType.ADD_VALUE, b"ctr",
                         (7).to_bytes(8, "little"))
        for _ in range(5):
            await src.transact(live, max_retries=200)
            await loop.delay(0.3)

        converged = False
        for _ in range(100):
            if await read_user_rows(src) == await read_user_rows(dst):
                converged = True
                break
            await loop.delay(0.5)

        async def more(tr):
            tr.set(b"final", b"state")
            tr.atomic_op(MutationType.ADD_VALUE, b"ctr",
                         (1).to_bytes(8, "little"))
        await src.transact(more, max_retries=200)
        end_version = await agent.switchover()
        await tail

        async def primary(tr):
            return await tr.get(S.dr.DR_PRIMARY)
        return dict(v0=v0, converged=converged, end_version=end_version,
                    rows_src=await read_user_rows(src),
                    rows_dst=await read_user_rows(dst),
                    dst_all=await read_everything(dst),
                    src_primary=await src.transact(primary),
                    dst_primary=await dst.transact(primary),
                    applied=await agent.applied_version())

    out = loop.run_future(loop.spawn(t()), max_time=600_000.0)
    out["end"] = loop.now()
    return out


def test_dr_replicates_and_switches_over():
    out = both(replicate_scenario).result
    assert out["v0"] > 0 and out["converged"]
    assert out["end_version"] > out["v0"]
    rows_src, rows_dst = out["rows_src"], out["rows_dst"]
    assert rows_src == rows_dst, \
        (f"switchover not byte-identical: {len(rows_src)} vs "
         f"{len(rows_dst)} rows")
    assert (b"final", b"state") in rows_dst
    assert int.from_bytes(dict(rows_dst)[b"ctr"], "little") == 36
    assert out["dst_primary"] == b"primary"
    assert out["src_primary"] == b"remote"


def idempotent_scenario(S, r):
    MutationType = S.types.MutationType
    loop, a, b = two_clusters(S, seed=9)
    r.loop = loop
    src = a.database("clientA:0")
    dst = b.database("clientB:0")
    agent = S.dr.DRAgent(src, dst)

    async def t():
        await agent.start()
        await agent.initial_snapshot()

        async def add(tr):
            tr.atomic_op(MutationType.ADD_VALUE, b"n",
                         (5).to_bytes(8, "little"))
        await src.transact(add, max_retries=200)

        rows = []

        async def snap(tr):
            nonlocal rows
            rows = await tr.get_range(S.agent.BLOG_PREFIX, S.agent.BLOG_END)
        await src.transact(snap)
        moved = [await agent.drain_once()]

        async def replant(tr):
            for k, v in rows:
                tr.set(k, v)
        await src.transact(replant, max_retries=200)
        moved.append(await agent.drain_once())

        async def rd(tr):
            return await tr.get(b"n")
        return dict(rows=rows, moved=moved,
                    n=await dst.transact(rd, max_retries=200),
                    dst_all=await read_everything(dst))

    out = loop.run_future(loop.spawn(t()), max_time=600_000.0)
    out["end"] = loop.now()
    return out


def test_dr_drain_is_idempotent_across_duplicate_application():
    out = both(idempotent_scenario).result
    assert out["rows"]
    assert out["moved"][0] > 0 and out["moved"][1] == len(out["rows"])
    assert int.from_bytes(out["n"], "little") == 5, \
        f"duplicate application doubled the atomic op: {out['n']}"


def fault_scenario(S, r):
    KillType = S.sim.KillType
    FDBError = S.errors.FDBError
    MutationType = S.types.MutationType
    loop, a, b = two_clusters(S, seed=7)
    r.loop = loop
    src = a.database("clientA:0")
    dst = b.database("clientB:0")
    agent = S.dr.DRAgent(src, dst, chunk_rows=30)
    rng = S.rng.DeterministicRandom(7001)

    async def t():
        async def seed(tr):
            for i in range(80):
                tr.set(b"pre/%04d" % i, b"v%04d" % i)
        await src.transact(seed)

        await agent.start()
        v0 = await agent.initial_snapshot()
        tail = loop.spawn(agent.run(), name="drTail")

        victims = ([p.address for p in a.storage_procs]
                   + [p.address for p in b.storage_procs])
        everyone = (victims
                    + [p.address for p in a.tlog_procs]
                    + [p.address for p in b.tlog_procs]
                    + [p.address for p in a.proxy_procs]
                    + [p.address for p in b.proxy_procs])

        for n in range(12):
            async def w(tr, n=n):
                tr.set(b"live/%04d" % n, b"L%04d" % n)
                tr.clear_range(b"pre/%04d" % (n * 3),
                               b"pre/%04d" % (n * 3 + 1))
                tr.atomic_op(MutationType.ADD_VALUE, b"ctr",
                             (3).to_bytes(8, "little"))
            try:
                await src.transact(w, max_retries=1000)
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise
            x = everyone[rng.randint(0, len(everyone) - 1)]
            y = everyone[rng.randint(0, len(everyone) - 1)]
            if x != y:
                a.net.clog_pair(x, y, 1.5 * rng.random())
            if rng.coinflip(0.4):
                v = victims[rng.randint(0, len(victims) - 1)]
                a.net.kill(v, KillType.RebootProcess)
            await loop.delay(0.5 + 0.5 * rng.random())

        a.net.heal()
        a.net.reboot_dead()
        await loop.delay(2.0)
        for _ in range(200):
            if await read_user_rows(dst) == await read_user_rows(src):
                break
            await loop.delay(0.5)
        end_version = await agent.switchover()
        await tail

        async def primary(tr):
            return await tr.get(S.dr.DR_PRIMARY)
        return dict(v0=v0, end_version=end_version,
                    rows_src=await read_user_rows(src),
                    rows_dst=await read_user_rows(dst),
                    dst_primary=await dst.transact(primary))

    out = loop.run_future(loop.spawn(t()), max_time=600_000.0)
    out["end"] = loop.now()
    return out


def test_dr_switchover_under_fault_cocktail():
    out = both(fault_scenario).result
    assert out["v0"] > 0 and out["end_version"] > out["v0"]
    rows_src, rows_dst = out["rows_src"], out["rows_dst"]
    assert rows_src == rows_dst, \
        (f"switchover not byte-identical under faults: "
         f"{len(rows_src)} vs {len(rows_dst)} rows")
    ctr = int.from_bytes(dict(rows_dst)[b"ctr"], "little")
    assert ctr >= 36 and ctr % 3 == 0, ctr
    assert out["dst_primary"] == b"primary"
