"""The port's SimCluster against the JAX SimCluster.

Both clusters boot with one seed and one topology (2 proxies, 2 resolvers,
2 tlogs, 2 storage servers) and serve one workload through the public
client API: 24 client actors x 4 attempts, each attempt 4 reads and 4
writes over 64 keys spread across both resolvers' and both storage
servers' key ranges, and one commit with no retry loop. Every attempt's
outcome (committed version or error name, and the virtual time it ended),
the final key-value contents and the virtual end time must be equal:
exact, since they are integers and bytes. The simulator is deterministic
only if every actor awaits the same futures in the same order, so equal
trajectories also show that the port's roles are the JAX package's.

Under CONFLICT_BACKEND=oracle both sides run their host reference; under
"device" the JAX side runs its JAX engine (CONFLICT_CPU_FALLBACK="jax";
"host" would silently run the oracle), pinned to one compiled program as
in test_torch_resolver.py, and the port's engine runs its plain PyTorch
versions (CONFLICT_DEVICE="cpu").
"""

import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from foundationdb_tpu.core import future as j_future
from foundationdb_tpu.ops import conflict as jconf
from foundationdb_tpu.server import cluster as j_cluster
from foundationdb_tpu.utils import errors as j_errors
from foundationdb_tpu.utils.knobs import KNOBS as JKNOBS
from foundationdb_tpu_torch.client.database import Database
from foundationdb_tpu_torch.core import future as t_future
from foundationdb_tpu_torch.server import cluster as t_cluster
from foundationdb_tpu_torch.server.master import Master
from foundationdb_tpu_torch.utils import errors as t_errors
from foundationdb_tpu_torch.utils import trace as t_trace
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS

SHAPE_KNOBS = dict(CONFLICT_STATE_CAPACITY=1024, CONFLICT_BATCH_TXNS=64,
                   CONFLICT_BATCH_READS_PER_TXN=4,
                   CONFLICT_BATCH_WRITES_PER_TXN=4)
TOPOLOGY = dict(n_proxies=2, n_resolvers=2, n_tlogs=2, n_storage=2)

PORT = SimpleNamespace(cluster=t_cluster, errors=t_errors, future=t_future)
JAX = SimpleNamespace(cluster=j_cluster, errors=j_errors, future=j_future)


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    """Port knobs reset around each test; both banks get the test shape.
    The JAX engine keeps one program: its bucket is pinned to the full
    shape (decisions do not depend on the bucket)."""
    TKNOBS.reset()
    TKNOBS.overrides(CONFLICT_DEVICE="cpu", **SHAPE_KNOBS)
    JKNOBS.overrides(CONFLICT_CPU_FALLBACK="jax", **SHAPE_KNOBS)

    def plan_chunk(self, nr, nw):
        return self.shapes, jconf._compiled_step(
            self.shapes, JKNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
            *self._intra)
    monkeypatch.setattr(jconf.DeviceConflictSet, "plan_chunk", plan_chunk)
    # the port's trace events would go to stderr; the JAX side's do too
    t_trace.set_sink(lambda _fields: None)
    yield
    t_trace.set_sink(None)
    TKNOBS.reset()


def set_backend(backend):
    TKNOBS.set("CONFLICT_BACKEND", backend)
    JKNOBS.set("CONFLICT_BACKEND", backend)


def workload(seed, n_clients=24, n_attempts=4, n_keys=64):
    """[(client, [(reads, writes, value)] per attempt)] from a numpy seed;
    keys spread over the whole byte range, so both resolvers and both
    storage shards serve them."""
    rng = np.random.default_rng(seed)
    keys = [bytes([i * 256 // n_keys]) + b"/k%02d" % i for i in range(n_keys)]
    plan = []
    for c in range(n_clients):
        attempts = []
        for a in range(n_attempts):
            reads = [keys[i] for i in rng.integers(0, n_keys, 4)]
            writes = [keys[i] for i in rng.integers(0, n_keys, 4)]
            attempts.append((reads, writes, b"c%d.a%d" % (c, a)))
        plan.append(attempts)
    return plan


def run_cluster(stack, seed, plan):
    """Boot `stack`'s SimCluster, run every client's attempts concurrently,
    return (outcomes, contents, end time, the resolvers' engine types)."""
    c = stack.cluster.SimCluster(seed=seed, **TOPOLOGY)
    db = c.database()
    outcomes = {}

    async def client(ci, attempts):
        for ai, (reads, writes, value) in enumerate(attempts):
            tr = db.create_transaction()
            try:
                for k in reads:
                    await tr.get(k)
                for k in writes:
                    tr.set(k, value)
                await tr.commit()
                out = tr.committed_version
            except stack.errors.FDBError as e:
                out = e.name
            outcomes[(ci, ai)] = (out, c.loop.now())

    async def main():
        await stack.future.all_of([
            c.loop.spawn(client(ci, a), name=f"client{ci}")
            for ci, a in enumerate(plan)])
        tr = db.create_transaction()
        return await tr.get_range(b"", b"\xff")

    contents = c.run(c.loop.spawn(main()), max_time=10_000.0)
    engines = {type(r.conflict_set).__name__ for r in c.resolvers}
    return outcomes, [tuple(kv) for kv in contents], c.loop.now(), engines


@pytest.mark.parametrize("backend", ["oracle", "device"])
@pytest.mark.parametrize("seed", [3, 4])
def test_port_cluster_matches_jax_cluster(backend, seed):
    set_backend(backend)
    plan = workload(seed)
    port = run_cluster(PORT, seed, plan)
    jax = run_cluster(JAX, seed, plan)
    assert port[0] == jax[0]
    assert port[1] == jax[1]
    assert port[2] == jax[2]
    engine = {"oracle": "OracleConflictSet", "device": "DeviceConflictSet"}
    assert port[3] == jax[3] == {engine[backend]}
    outcomes = [o for o, _t in port[0].values()]
    assert len(outcomes) == 24 * 4
    committed = [o for o in outcomes if isinstance(o, int)]
    assert committed and "not_committed" in outcomes  # both outcomes occur
    assert port[1]  # the committed writes are there to compare


def native_off(monkeypatch):
    """The port as on a box without a C compiler: every module takes its
    Python path (the wire codec's C hook cleared too)."""
    from foundationdb_tpu_torch import native
    from foundationdb_tpu_torch.utils import wire
    wire._ensure_registry()
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(wire, "_native", None)


@pytest.mark.parametrize("backend", ["oracle", "device"])
@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("extension", ["on", "off"])
def test_port_cluster_matches_jax_cluster_with_and_without_the_extension(
        monkeypatch, extension, backend, seed):
    """The trajectory comparison with the port's C extension serving (the
    storage servers' VStore, the wire codec, the resolvers' C encoder) and
    with every module on its Python path: both equal the JAX SimCluster,
    which takes its own extension's paths."""
    from foundationdb_tpu_torch.ops import conflict as t_conflict
    from foundationdb_tpu_torch.server.versioned_map import (
        NativeVersionedMap, VersionedMap)
    if extension == "off":
        native_off(monkeypatch)
    set_backend(backend)
    plan = workload(seed, n_clients=12, n_attempts=3)
    before = t_conflict.kernel_metrics.as_dict()
    port = run_cluster(PORT, seed, plan)
    after = t_conflict.kernel_metrics.as_dict()
    jax = run_cluster(JAX, seed, plan)
    assert port == jax
    encoded = {k: after[k] - before[k]
               for k in ("EncodedChunksC", "EncodedChunksPy")}
    if backend == "device":
        assert encoded[{"on": "EncodedChunksPy",
                        "off": "EncodedChunksC"}[extension]] == 0
        assert sum(encoded.values()) > 0
    store = {"on": NativeVersionedMap, "off": VersionedMap}[extension]
    c = t_cluster.SimCluster(seed=1)
    assert {type(ss.data) for ss in c.storages} == {store}


def test_port_cluster_same_seed_same_trace():
    """The counterpart of test_e2e.py's determinism test: one seed gives
    one trajectory, another seed another."""
    set_backend("oracle")
    plan = workload(5, n_clients=8, n_attempts=3)
    first = run_cluster(PORT, 7, plan)
    assert run_cluster(PORT, 7, plan) == first
    assert run_cluster(PORT, 8, plan)[0] != first[0]


def test_port_cluster_imports_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import foundationdb_tpu_torch.server.cluster\n"
            "import foundationdb_tpu_torch.client.database\n"
            "import foundationdb_tpu_torch.server.proxy\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'foundationdb_tpu')]\n"
            "assert not bad, bad\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                   check=True, timeout=120)


def test_default_device_raises_platform_error_without_a_card(monkeypatch):
    """CONFLICT_DEVICE defaults to cuda: a box without a card refuses to
    boot the cluster's resolvers; nothing falls back to the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    TKNOBS.reset()
    assert TKNOBS.CONFLICT_BACKEND == "device"
    with pytest.raises(t_errors.FDBError) as ei:
        t_cluster.SimCluster(seed=1)
    assert ei.value.name == "platform_error"


def test_parts_not_ported_raise_invalid_option():
    set_backend("oracle")
    # redwood came with the sim harness: its storage servers open it
    TKNOBS.set("STORAGE_ENGINE", "redwood")
    c = t_cluster.SimCluster(seed=1)
    assert {type(ss.store).__name__ for ss in c.storages} == {
        "RedwoodKeyValueStore"}
    # backup came with its agents: the harness's backup workload runs a
    # backup (test_torch_sim_tiers.py runs it whole); fdbbackup's main came
    # with the network transport (test_torch_net_tools.py), and its native
    # planes with the port's C extension (test_torch_native_transport.py)
    from foundationdb_tpu_torch.testing.fuzz_workloads import (
        BackupUnderAttritionWorkload)
    from foundationdb_tpu_torch.tools import fdbbackup
    from foundationdb_tpu_torch.utils.rng import DeterministicRandom
    w = BackupUnderAttritionWorkload(n_keys=8, chunks=2)
    w.init(c, DeterministicRandom(3), stop_at=30.0)
    db = c.database()
    c.run(c.loop.spawn(w.setup(db)))
    c.run(c.loop.spawn(w.start(db)), max_time=600.0)
    assert w.writes > 0 and w.end_version > 0
    assert w.container.list_files("kvrange-") and \
        w.container.read_file("meta") == {"end_version": w.end_version}
    assert callable(fdbbackup.main)
    TKNOBS.set("STORAGE_ENGINE", "memory")
    c = t_cluster.SimCluster(seed=1)
    proc = c.net.new_process("extra:0")
    # the coordinators came with recovery: a master holds its cstate lease
    # and a database finds its cluster through them (test_torch_recovery.py)
    master = Master(proc, coordinators=["coord:0"])
    assert master._lease_task is not None
    master.shutdown()
    assert Database(proc, coordinators=["coord:0"]).coordinators == [
        "coord:0"]


def test_chip_smoke_phase9_checks_pass_on_the_cpu():
    """chip_smoke.py's phase 9 (the SimCluster through the client API, each
    resolver's batches replayed into the oracle, every acknowledged write
    read back, the Cycle ring) at a small size on the port's plain
    versions: its checks must hold wherever the engine runs."""
    import torch

    import chip_smoke
    out = chip_smoke.cluster_phase(
        torch.device("cpu"), 1,
        ycsb=dict(n_clients=8, n_attempts=3, n_keys=300, knobs=SHAPE_KNOBS),
        cycle=dict(n_nodes=60, n_rotators=8, n_txns=3, knobs=SHAPE_KNOBS))
    a, b = out["9a"], out["9b"]
    assert a["attempts"] == 24 and a["committed"] + a["conflicted"] == 24
    assert a["read_back_mismatches"] == {"client": 0, "storage": 0}
    assert a["mismatched_batches"] == b["mismatched_batches"] == 0
    assert b["ring_holds"] and b["storage_equals_client"]
    assert b["committed"] == 24 and len(b["buckets"]) == 2


def test_wire_frames_match_the_jax_codec():
    """The port's codec registers its structs under the JAX package's type
    ids: a frame the port writes decodes in the JAX codec to the same
    struct, which the JAX codec writes back byte for byte."""
    from foundationdb_tpu.utils import wire as j_wire
    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
    from foundationdb_tpu_torch.server import interfaces as I
    from foundationdb_tpu_torch.server.hotspot import HotRange, ThrottleEntry
    from foundationdb_tpu_torch.server.ratekeeper import (QueueStatsReply,
                                                          RateInfoReply)
    from foundationdb_tpu_torch.utils import wire as t_wire
    from foundationdb_tpu_torch.utils.types import Mutation, MutationType

    m = Mutation(MutationType.SET_VALUE, b"k", b"v")
    objs = [
        m, TxnConflictInfo(7, [(b"a", b"b")], [(b"c", b"d")]),
        I.CommitTransactionRequest(read_snapshot=5, mutations=[m],
                                   read_conflict_ranges=[(b"a", b"b")],
                                   write_conflict_ranges=[(b"k", b"k\0")]),
        I.ResolveTransactionBatchRequest(
            prev_version=1, version=2, last_receive_version=1,
            transactions=[TxnConflictInfo(1, [], [(b"x", b"y")])],
            state_txn_indices=[0], state_txn_mutations=[[m]]),
        I.ResolveTransactionBatchReply(committed=[2, 0],
                                       state_mutations=[(1, [(True, [m])])]),
        I.TLogCommitRequest(prev_version=1, version=2, messages={0: [m]}),
        I.GetValuesReply(results=[(0, b"v"), (0, None),
                                  (1, "wrong_shard_server")]),
        I.KeySelector(b"k", True, 1),
        QueueStatsReply(queue_bytes=10, lag_versions=20),
        RateInfoReply(tps=1.5,
                      throttles=[ThrottleEntry(b"a", b"b", 2.0, 0.25)]),
        HotRange(b"a", b"b", 3.0)]
    for obj in objs:
        frame = t_wire.dumps(obj)
        back = j_wire.loads(frame)
        assert type(back).__name__ == type(obj).__name__
        assert j_wire._py_dumps(back) == frame
        assert t_wire.loads(frame) == obj
