"""The port's RecoverableCluster against the JAX RecoverableCluster.

Both packages boot the same cluster the real way (coordinators, workers, an
elected cluster controller that recruits the transaction subsystem and
recruits it anew after a failure) from one seed, and run one scenario
through the public client API. Each run records:

- every attempt's outcome: each commit's version or error name, and each
  error raised by an attempt's reads, with the virtual time it happened;
- every DBInfo the cluster controllers publish: its epoch, recovery state,
  the recruited roles' addresses, the log generations, the storage servers
  and the shard layout, with the virtual time and the publishing
  controller;
- the final key-value contents, read through a transaction;
- the virtual end time.

The two records must be equal, exactly: they are integers, strings, bytes
and virtual times from the same arithmetic. The simulator is deterministic
only if every actor awaits the same futures in the same order, so equal
records also show that the port's roles are the JAX package's.

The scenarios are tests/test_recovery.py's six (seeds 3 and 11-15) under the
oracle, and two under the device backend: a resolver's worker killed
mid-Cycle, and test_tworegion.py's region failover. Under "device" the JAX
side runs its JAX engine (CONFLICT_CPU_FALLBACK="jax"), pinned to one
compiled program as in test_torch_cluster.py, and the port's engine runs
its plain PyTorch versions (CONFLICT_DEVICE="cpu").
"""

import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import pytest

from foundationdb_tpu.client import database as j_database
from foundationdb_tpu.client import management as j_management
from foundationdb_tpu.client import transaction as j_transaction
from foundationdb_tpu.core import future as j_future
from foundationdb_tpu.core import sim as j_sim
from foundationdb_tpu.ops import conflict as jconf
from foundationdb_tpu.server import cluster as j_cluster
from foundationdb_tpu.server import clustercontroller as j_cc
from foundationdb_tpu.utils import errors as j_errors
from foundationdb_tpu.utils.knobs import KNOBS as JKNOBS
from foundationdb_tpu_torch.client import database as t_database
from foundationdb_tpu_torch.client import management as t_management
from foundationdb_tpu_torch.client import transaction as t_transaction
from foundationdb_tpu_torch.core import future as t_future
from foundationdb_tpu_torch.core import sim as t_sim
from foundationdb_tpu_torch.server import cluster as t_cluster
from foundationdb_tpu_torch.server import clustercontroller as t_cc
from foundationdb_tpu_torch.utils import errors as t_errors
from foundationdb_tpu_torch.utils import trace as t_trace
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS

PORT = SimpleNamespace(name="port", cluster=t_cluster, cc=t_cc,
                       database=t_database, transaction=t_transaction,
                       management=t_management, future=t_future, sim=t_sim,
                       errors=t_errors, knobs=TKNOBS)
JAX = SimpleNamespace(name="jax", cluster=j_cluster, cc=j_cc,
                      database=j_database, transaction=j_transaction,
                      management=j_management, future=j_future, sim=j_sim,
                      errors=j_errors, knobs=JKNOBS)
STACKS = (PORT, JAX)

# the device scenarios' shape (test_torch_cluster.py's)
SHAPE_KNOBS = dict(CONFLICT_STATE_CAPACITY=1024, CONFLICT_BATCH_TXNS=64,
                   CONFLICT_BATCH_READS_PER_TXN=4,
                   CONFLICT_BATCH_WRITES_PER_TXN=4)


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    """Both banks reset around each test, the oracle backend by default
    (the reference tests' fixture). The JAX engine keeps one program: its
    bucket is pinned to the full shape (decisions do not depend on the
    bucket). The port's trace events are dropped."""
    TKNOBS.reset()
    TKNOBS.overrides(CONFLICT_BACKEND="oracle", CONFLICT_DEVICE="cpu")
    JKNOBS.overrides(CONFLICT_BACKEND="oracle", CONFLICT_CPU_FALLBACK="jax")

    def plan_chunk(self, nr, nw):
        return self.shapes, jconf._compiled_step(
            self.shapes, JKNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
            *self._intra)
    monkeypatch.setattr(jconf.DeviceConflictSet, "plan_chunk", plan_chunk)
    t_trace.set_sink(lambda _fields: None)
    yield
    t_trace.set_sink(None)
    TKNOBS.reset()


def set_knobs(**kw):
    """The same knob values on both banks."""
    TKNOBS.overrides(**kw)
    JKNOBS.overrides(**kw)


class Recorder:
    """Records a run's attempts and published DBInfos (see the module
    docstring). The hooks only wrap: they add no await and no timer, so
    the trajectory is the one the unhooked code takes."""

    def __init__(self, S, monkeypatch):
        self.loop = None
        self.attempts: list = []
        self.dbinfos: list = []
        rec = self
        FDBError = S.errors.FDBError
        commit = S.transaction.Transaction.commit
        transact = S.database.Database.transact

        async def recorded_commit(tr):
            try:
                await commit(tr)
            except FDBError as e:
                rec.attempts.append(("commit", e.name, rec.now()))
                raise
            rec.attempts.append(("commit", tr.committed_version, rec.now()))

        async def recorded_transact(db, fn, max_retries=100):
            async def body(tr):
                try:
                    return await fn(tr)
                except FDBError as e:
                    rec.attempts.append(("body", e.name, rec.now()))
                    raise
            return await transact(db, body, max_retries)

        # a property on the class shadows the instance's own attribute,
        # which it reads and writes: once the hooks are gone, the instance
        # attribute is the DBInfo again
        def get_info(cc):
            return cc.__dict__["dbinfo"]

        def set_info(cc, info):
            cc.__dict__["dbinfo"] = info
            rec.dbinfos.append(rec.snapshot(cc, info))

        monkeypatch.setattr(S.transaction.Transaction, "commit",
                            recorded_commit)
        monkeypatch.setattr(S.database.Database, "transact",
                            recorded_transact)
        monkeypatch.setattr(S.cc.ClusterController, "dbinfo",
                            property(get_info, set_info), raising=False)

    def now(self):
        return self.loop.now()

    def snapshot(self, cc, info):
        return (self.now(), cc.process.address, info.epoch, info.version,
                info.recovery_state, info.master, list(info.proxies),
                list(info.grv_proxies), list(info.resolvers),
                info.ratekeeper,
                [(ep.epoch, ep.begin, ep.end, list(ep.addrs),
                  list(ep.uids or []), ep.n_primary)
                 for ep in info.log_epochs],
                [tuple(s) for s in info.storages],
                list(info.shard_boundaries),
                [list(t) for t in info.shard_tags or []])

    def epochs(self):
        """Each epoch's recruited roles, from the first DBInfo published
        with it in accepting_commits."""
        out = {}
        for snap in self.dbinfos:
            if snap[4] == "accepting_commits":
                out.setdefault(snap[2], snap[5:11])
        return out


def default_db(S, c):
    return c.database()


def run_scenario(S, scenario, make_cluster, max_time, make_db=default_db):
    """Boot `make_cluster(S)`, run `scenario(S, c, db)` (a coroutine
    function) on `make_db(S, c)` to its end, read the contents; return the
    record. The recorder's hooks last for this run only."""
    with pytest.MonkeyPatch.context() as mp:
        rec = Recorder(S, mp)
        c = make_cluster(S)
        rec.loop = c.loop
        db = make_db(S, c)

        async def main():
            result = await scenario(S, c, db)

            async def read_all(tr):
                return await tr.get_range(b"", b"\xff")
            rows = await db.transact(read_all, max_retries=500)
            return result, [tuple(kv) for kv in rows]

        result, rows = c.run(c.loop.spawn(main()), max_time=max_time)
    return SimpleNamespace(attempts=rec.attempts, dbinfos=rec.dbinfos,
                           epochs=rec.epochs(), contents=rows,
                           end=c.loop.now(), result=result, cluster=c)


def assert_same_run(port, jax):
    assert port.attempts == jax.attempts
    assert port.epochs == jax.epochs
    assert port.dbinfos == jax.dbinfos
    assert port.contents == jax.contents
    assert port.end == jax.end
    assert port.result == jax.result
    assert port.attempts and port.epochs  # there was something to compare


def both(scenario, make_cluster, max_time, **kw):
    """The scenario on the port, then on the JAX package (each with its
    own hooks), held equal. Returns the port's run."""
    port = run_scenario(PORT, scenario, make_cluster, max_time, **kw)
    jax = run_scenario(JAX, scenario, make_cluster, max_time, **kw)
    assert_same_run(port, jax)
    return port


# ---------------------------------------------------------------------------
# tests/test_recovery.py's scenarios, on both packages
# ---------------------------------------------------------------------------

N = 5


def key(i):
    return b"cycle/%02d" % i


async def setup_ring(tr):
    for i in range(N):
        tr.set(key(i), b"%02d" % ((i + 1) % N))


def make_rotate(c):
    async def rotate(tr):
        r = c.rng.randint(0, N - 1)
        a = key(r)
        b_idx = int(await tr.get(a))
        b = key(b_idx)
        c_idx = int(await tr.get(b))
        ck = key(c_idx)
        d_idx = int(await tr.get(ck))
        tr.set(a, b"%02d" % c_idx)
        tr.set(b, b"%02d" % d_idx)
        tr.set(ck, b"%02d" % b_idx)
    return rotate


async def check_ring(db, max_retries=100):
    async def read_ring(tr):
        seen = set()
        i = 0
        for _ in range(N):
            seen.add(i)
            i = int(await tr.get(key(i)))
        return i, seen
    i, seen = await db.transact(read_ring, max_retries=max_retries)
    assert i == 0 and len(seen) == N, f"ring broken: {seen}"


def recoverable(seed, **kw):
    def make(S):
        return S.cluster.RecoverableCluster(seed=seed, **kw)
    return make


async def boot_scenario(S, c, db):
    await db.refresh()
    await db.transact(setup_ring)
    await check_ring(db)
    cc = c.current_cc()
    assert cc is not None
    assert cc.dbinfo.epoch == 1
    assert len(cc.dbinfo.proxies) == 2
    return cc.dbinfo.epoch


def kill_scenario(get_victim, n_rotations=16):
    """test_recovery.py's _run_workload_with_kill: rotations through
    db.transact, the victim killed after three of them, the ring checked
    and a new epoch awaited."""
    async def scenario(S, c, db):
        rotate = make_rotate(c)
        state = {"done": 0}

        async def rotations():
            for _ in range(n_rotations):
                await db.transact(rotate, max_retries=500)
                state["done"] += 1

        async def killer():
            while state["done"] < 3:
                await c.loop.delay(0.1)
            victim = get_victim(c)
            assert victim is not None
            c.net.kill(victim)

        await db.refresh()
        epoch0 = c.current_cc().dbinfo.epoch
        await db.transact(setup_ring)
        await S.future.all_of([c.loop.spawn(rotations(), name="rotations"),
                               c.loop.spawn(killer(), name="killer")])
        await check_ring(db)
        for _ in range(200):
            cc = c.current_cc()
            if cc is not None and cc.dbinfo.epoch > epoch0:
                break
            await c.loop.delay(0.5)
        cc = c.current_cc()
        assert cc is not None and cc.dbinfo.epoch > epoch0, \
            "no recovery happened"
        assert state["done"] == n_rotations
        return cc.dbinfo.epoch
    return scenario


def cc_addr(c):
    cc = c.current_cc()
    return cc.process.address if cc else None


async def storage_reboot_scenario(S, c, db):
    await db.refresh()
    await db.transact(setup_ring)
    await check_ring(db)
    storages = c.current_cc().dbinfo.storages
    c.net.kill(storages[0][0], S.sim.KillType.RebootProcess)
    await check_ring(db)
    return c.current_cc().dbinfo.epoch


RECOVERY_SCENARIOS = {
    "boot": (3, boot_scenario, 10_000.0),
    "kill_master": (11, kill_scenario(lambda c: c.current_cc().dbinfo.master),
                    60_000.0),
    "kill_tlog": (12, kill_scenario(
        lambda c: c.current_cc().dbinfo.log_epochs[-1].addrs[0]), 60_000.0),
    "kill_proxy": (13, kill_scenario(
        lambda c: c.current_cc().dbinfo.proxies[0]), 60_000.0),
    "kill_cluster_controller": (14, kill_scenario(cc_addr), 60_000.0),
    "storage_reboot": (15, storage_reboot_scenario, 30_000.0),
}


@pytest.mark.parametrize("name", list(RECOVERY_SCENARIOS))
def test_recovery_scenario_matches_jax(name):
    seed, scenario, max_time = RECOVERY_SCENARIOS[name]
    port = both(scenario, recoverable(seed), max_time)
    epochs = sorted(port.epochs)
    assert epochs[0] == 1
    if name.startswith("kill_"):
        assert port.result > 1 and len(epochs) >= 2


# ---------------------------------------------------------------------------
# the device backend: the port's plain versions against the JAX engine
# ---------------------------------------------------------------------------

def resolver_worker(c):
    """The worker that hosts the current generation's first resolver."""
    return c.current_cc().dbinfo.resolvers[0]


def test_resolver_worker_killed_mid_cycle_on_the_device_backend():
    """Two resolvers on the device engine; the worker that hosts the first
    is killed mid-Cycle. The recovery recruits fresh engines (an empty
    conflict state at the recovery version) and the ring holds."""
    set_knobs(CONFLICT_BACKEND="device", **SHAPE_KNOBS)
    engines = {S.name: set() for S in STACKS}

    def make(S):
        return S.cluster.RecoverableCluster(seed=21, n_resolvers=2)

    async def scenario(S, c, db):
        epoch = await kill_scenario(resolver_worker, n_rotations=12)(S, c, db)
        for p in c.worker_procs:
            r = getattr(p, "worker", None) and p.worker.roles.get("resolver")
            if r is not None:
                engines[S.name].add(type(r.conflict_set).__name__)
        return epoch

    port = both(scenario, make, 60_000.0)
    assert port.result >= 2
    assert engines["port"] == engines["jax"] == {"DeviceConflictSet"}
    first = port.epochs[1]
    # the first generation's resolver[0] host died: the next generation's
    # resolvers are on other workers
    assert first[3][0] not in port.epochs[max(port.epochs)][3]


def two_region_client(S, c):
    proc = c.net.new_process("client:0", dc_id="client")
    return S.database.Database(proc, coordinators=c.coordinators,
                               rng=c.rng.fork())


def region_failover_scenario(rotations, acked_retries=2000):
    async def scenario(S, c, db):
        await db.refresh()
        await db.transact(setup_ring)
        rotate = make_rotate(c)
        for i in range(rotations):
            async def w(tr, i=i):
                await rotate(tr)
                tr.set(b"acked", b"%04d" % (i + 1))
            await db.transact(w, max_retries=500)
        c.kill_dc("dc0")

        async def read_acked(tr):
            return await tr.get(b"acked")
        acked = await db.transact(read_acked, max_retries=acked_retries)
        assert acked == b"%04d" % rotations, acked
        await check_ring(db, max_retries=500)
        cc = c.current_cc()
        assert c.net.processes[cc.dbinfo.master].dc_id == "dc1"
        return acked
    return scenario


def test_region_failover_with_device_backend_matches_jax():
    """test_tworegion.py's test_region_failover_with_device_backend on both
    packages: the device engines serve commits while the whole primary
    region dies; the recovery re-creates them in the surviving region with
    no acknowledged commit lost."""
    set_knobs(CONFLICT_BACKEND="device", CONFLICT_BATCH_TXNS=16,
              CONFLICT_BATCH_READS_PER_TXN=2,
              CONFLICT_BATCH_WRITES_PER_TXN=2, CONFLICT_STATE_CAPACITY=2048)

    def make(S):
        return S.cluster.RecoverableCluster.two_region(seed=47)

    port = both(region_failover_scenario(4), make, 120_000.0,
                make_db=two_region_client)
    assert port.result == b"0004"


# ---------------------------------------------------------------------------
# the refusals are gone; status; no JAX; chip_smoke's phase 10
# ---------------------------------------------------------------------------

def test_master_with_coordinators_holds_its_cstate_lease():
    """A master given coordinators builds and runs the reference's lease:
    with no coordinator reachable it deposes itself within a lease period
    (MASTER_CSTATE_LEASE_SECONDS), on both packages alike."""
    def run(S):
        loop = S.cluster.EventLoop()
        net = S.sim.SimNetwork(loop, S.cluster.DeterministicRandom(1))
        proc = net.new_process("master:0")
        master = S.cluster.Master(proc, coordinators=["coord:0", "coord:1",
                                                      "coord:2"])
        assert master._lease_task is not None

        async def wait():
            while not master.deposed:
                await loop.delay(0.1)
            return loop.now()
        return loop.run_future(loop.spawn(wait()), max_time=60.0)
    port, jax = (run(S) for S in STACKS)
    assert port == jax
    assert 0 < port <= 2 * TKNOBS.MASTER_CSTATE_LEASE_SECONDS


def resolver_device_keys(name):
    """The resolver's metric keys that differ by design: the port reports
    its kernel launches (and, beside the dispatches, the chunks that did
    not converge, the chunks its encoder wrote by the C pass and by numpy,
    and whether the role poisoned); the JAX package its compile cache."""
    return (name.startswith("KernelLaunches.")
            or name in ("UnconvergedChunks", "EncodedChunksC",
                        "EncodedChunksPy", "Poisoned", "CompileCacheHits",
                        "CompileCacheMisses"))


def test_refresh_and_status_answer_as_in_jax(monkeypatch):
    """Database.refresh finds the recovered generation through the
    coordinators, and get_status returns the cluster controller's status:
    equal to the JAX package's, but for the resolver keys above."""
    from foundationdb_tpu.ops import conflict as j_conflict
    from foundationdb_tpu.utils import jaxenv
    from foundationdb_tpu_torch.ops import conflict as t_conflict
    from foundationdb_tpu_torch.utils import cudaenv

    # process-wide gauges: what earlier tests counted must not differ
    for collection in (j_conflict.kernel_metrics, jaxenv.transfer_metrics,
                       t_conflict.kernel_metrics, cudaenv.transfer_metrics):
        for counter in collection.counters:
            monkeypatch.setattr(counter, "value", 0)

    async def scenario(S, c, db):
        await db.refresh()
        assert db.proxies == c.current_cc().dbinfo.proxies
        await db.transact(setup_ring)
        await check_ring(db)
        status = await db.get_status()
        for role in status["cluster"]["roles"]:
            if role["role"] == "resolver":
                role["counters"] = {k: v for k, v in role["counters"].items()
                                    if not resolver_device_keys(k)}
        return status

    port = both(scenario, recoverable(7, n_resolvers=2), 10_000.0)
    status = port.result["cluster"]
    assert status["recovery_state"] == {"name": "accepting_commits",
                                        "epoch": 1}
    roles = {r["role"] for r in status["roles"]}
    assert {"master", "proxy", "resolver", "log", "storage"} <= roles
    assert all("counters" in r for r in status["roles"])
    assert status["workload"]["transactions_committed"] >= 2


def test_recovery_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import foundationdb_tpu_torch.server.cluster\n"
            "import foundationdb_tpu_torch.server.clustercontroller\n"
            "import foundationdb_tpu_torch.server.worker\n"
            "import foundationdb_tpu_torch.server.coordination\n"
            "import foundationdb_tpu_torch.server.logrouter\n"
            "import foundationdb_tpu_torch.server.replication\n"
            "import foundationdb_tpu_torch.client.management\n"
            "from foundationdb_tpu_torch.utils import wire\n"
            "wire.dumps(1)\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'foundationdb_tpu')]\n"
            "assert not bad, bad\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                   check=True, timeout=120)


def test_coordination_wire_frames_match_the_jax_codec():
    """Wire ids 37-42 and 45 are the JAX package's: a frame the port writes
    decodes in the JAX codec and is written back byte for byte."""
    from foundationdb_tpu.utils import wire as j_wire
    from foundationdb_tpu_torch.server import coordination as coord
    from foundationdb_tpu_torch.server.interfaces import token_name
    from foundationdb_tpu_torch.utils import wire as t_wire

    objs = [coord.GenReadRequest(key="cstate", gen=3),
            coord.GenReadReply(value={"epoch": 2}, vgen=1, rgen=3),
            coord.GenWriteRequest(key="cstate", value={"epoch": 4}, gen=5),
            coord.GenWriteReply(ok=True, rgen=5, vgen=5),
            coord.CandidacyRequest(address="worker:1", priority=2,
                                   lease_seconds=3.0),
            coord.LeaderReply(leader="worker:1", priority=2),
            t_cc.ClusterConfig(n_proxies=2, n_resolvers=2, n_tlogs=2,
                               n_storage=2, region_dcs=("dc0", "dc1"))]
    ids = []
    for obj in objs:
        frame = t_wire.dumps(obj)
        back = j_wire.loads(frame)
        assert type(back).__name__ == type(obj).__name__
        assert j_wire._py_dumps(back) == frame
        assert t_wire.loads(frame) == obj
        ids.append(t_wire._BY_TYPE[type(obj)])
    assert ids == [37, 38, 39, 40, 41, 42, 45]
    assert token_name(coord.CoordToken.GENERATION_PEEK) == "GENERATION_PEEK"


def test_chip_smoke_phase10_checks_pass_on_the_cpu():
    """chip_smoke.py's phase 10 (the RecoverableCluster through two kills,
    every recruited resolver's batches replayed into a fresh oracle from
    its recovery version, the Cycle ring through a transaction and on
    every storage replica) at a small size on the port's plain versions:
    its checks must hold wherever the engine runs."""
    import torch

    import chip_smoke
    out = chip_smoke.recovery_phase(
        torch.device("cpu"), 1, n_nodes=60, n_rotators=8, n_txns=6,
        kills=((12, "resolver"), (30, "cluster_controller")),
        knobs=SHAPE_KNOBS)
    assert out["final_epoch"] >= 3 and len(out["recoveries"]) == 2
    assert [r["kill"] for r in out["recoveries"]] == ["resolver",
                                                      "cluster_controller"]
    assert out["ring_holds"] and out["storage_equals_client"]
    assert out["committed"] == 48 and out["mismatched_batches"] == 0
    assert out["unconverged_chunks"] == 0
    versions = {r["recovery_version"] for r in out["resolvers"]}
    assert len(versions) >= 3  # three generations of resolvers
    assert sum(r["chunks"] for r in out["resolvers"]) == out["chunks"] > 0
    assert out["outcomes"]["committed"] == 48
