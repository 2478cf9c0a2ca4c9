"""The port's legacy intra-batch evaluator against the JAX package.

`conflict_step(intra_mode="legacy")` tests every (write, read) pair of a
batch and iterates its lower/upper bounds until they meet. The port's plain
step in that mode goes against the jitted JAX step in the same mode on the
CPU, in the pooled layout (K=1024, T=64, 4 reads and 4 writes a txn) and in
the strided layout (T=32, two slots of each a txn): state, statuses and
every `info` field must be EQUAL after each step. It must also equal the
port's scan step, and the port's `DeviceConflictSet` under
CONFLICT_INTRA_MODE=legacy must decide as the scan engine and the oracle do
(tests/test_conflict.py:513-528).
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import conflict as jconf
from foundationdb_tpu.ops.batch import TxnConflictInfo as JTxn
from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops import kernels
from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
from foundationdb_tpu_torch.ops.conflict import DeviceConflictSet
from foundationdb_tpu_torch.ops.conflict_oracle import OracleConflictSet
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS
from foundationdb_tpu_torch.utils.rng import DeterministicRandom

CPU = torch.device("cpu")
POOLED = jconf.ConflictShapes(capacity=1024, txns=64, reads=256, writes=256)
STRIDED = jconf.ConflictShapes(capacity=1024, txns=32, reads=64, writes=64,
                               strided=True)
WINDOW = 5_000_000
STEP = 500_000
INFO = ("overflow", "boundaries", "committed", "converged", "eligible")


@pytest.fixture(autouse=True)
def _reset_port_knobs():
    TKNOBS.reset()
    yield
    TKNOBS.reset()


def to_np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def rand_range(rng, space):
    a = space[rng.integers(len(space))]
    kind = rng.integers(10)
    if kind < 6:
        return (a, a + b"\x00")
    b = space[rng.integers(len(space))]
    if kind == 6:
        return (max(a, b), min(a, b))  # inverted (or empty)
    return (min(a, b), max(a, b) + b"\x00")


def rand_batch(rng, space, version, shapes):
    per = shapes.reads // shapes.txns if shapes.strided else 4
    return [TxnConflictInfo(
        max(0, version - int(rng.integers(0, 6 * STEP))),
        [rand_range(rng, space) for _ in range(rng.integers(0, per + 1))],
        [rand_range(rng, space) for _ in range(rng.integers(0, per + 1))])
        for _ in range(rng.integers(1, shapes.txns + 1))]


def encode(txns, version, shapes):
    enc = jconf.BatchEncoder(shapes)
    jtxns = [JTxn(t.read_snapshot, t.read_ranges, t.write_ranges)
             for t in txns]
    return {k: np.array(v) for k, v in enc.encode_batch(jtxns, version).items()}


@pytest.mark.parametrize("shapes", [POOLED, STRIDED],
                         ids=["pooled", "strided"])
def test_legacy_step_equals_jax_and_the_scan_step(shapes):
    rng = np.random.default_rng(21)
    # a narrow key space: long chains of earlier-txn conflicts in a batch
    space = sorted({rng.integers(97, 101, rng.integers(1, 4))
                    .astype(np.uint8).tobytes() for _ in range(40)})
    step = jconf._compiled_step(shapes, WINDOW, "legacy", 0)
    jstate = jconf.init_state(shapes)
    legacy = ref.state_from_numpy(to_np(jstate), CPU)
    scan = ref.state_from_numpy(to_np(jstate), CPU)
    version, conflicts = STEP, 0
    for i in range(8):
        version += int(rng.integers(STEP // 4, 2 * STEP))
        batch = encode(rand_batch(rng, space, version, shapes), version,
                       shapes)
        jstate, jst, jinfo = step(jstate, batch)
        tbatch = ref.batch_from_numpy(batch, CPU)
        legacy, lst, linfo = ref.conflict_step(
            legacy, tbatch, max_write_life=WINDOW, intra_mode="legacy",
            strided=shapes.strided)
        scan, sst, sinfo = ref.conflict_step(
            scan, tbatch, max_write_life=WINDOW, strided=shapes.strided)
        where = f"step {i}"
        np.testing.assert_array_equal(lst.numpy(), np.asarray(jst),
                                      err_msg=f"statuses {where}")
        for k in INFO:
            np.testing.assert_array_equal(linfo[k].numpy(),
                                          np.asarray(jinfo[k]),
                                          err_msg=f"info[{k}] {where}")
            assert torch.equal(linfo[k], sinfo[k]), f"scan info[{k}] {where}"
        assert torch.equal(lst, sst), where
        want = to_np(jstate)
        for name, st in (("legacy", legacy), ("scan", scan)):
            got = ref.state_to_numpy(st)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{name} {k} {where}")
        conflicts += int((lst == 0).sum())
    assert conflicts > 0


def test_legacy_wrapper_runs_its_plain_version_on_cpu():
    kernels.reset_launches()
    rng = np.random.default_rng(3)
    T, NW, NR = 16, 40, 30
    args = (torch.from_numpy(rng.random(T) < 0.7),
            torch.from_numpy(rng.random(T) < 0.8),
            torch.from_numpy(rng.integers(0, T + 1, NW).astype(np.int32)),
            torch.from_numpy(rng.integers(0, T + 1, NR).astype(np.int32)),
            torch.from_numpy(rng.random(NW) < 0.9),
            torch.from_numpy(rng.random(NR) < 0.9),
            *[torch.from_numpy(rng.integers(0, 50, n).astype(np.int32))
              for n in (NW, NW, NR, NR)])
    assert torch.equal(kernels.legacy_sweep(*args), ref.legacy_sweep(*args))
    assert kernels.LAUNCHES["legacy_blocked"] == 0


def _fuzz_key(rng):
    return bytes(rng.randint(97, 99) for _ in range(rng.randint(1, 5)))


def _fuzz_range(rng):
    a = _fuzz_key(rng)
    kind = rng.randint(0, 9)
    if kind < 4:
        return (a, a + b"\x00")
    if kind < 7:
        return (a, a + b"\xff")
    b = _fuzz_key(rng)
    return (a, a + b"\x00") if a == b else (min(a, b), max(a, b))


def _fuzz_txn(rng, version):
    snap = max(0, version - rng.randint(0, 900))
    if rng.randint(0, 5) == 0:
        return TxnConflictInfo(snap, [], [_fuzz_range(rng)
                                          for _ in range(rng.randint(1, 3))])
    reads = [_fuzz_range(rng) for _ in range(rng.randint(0, 3))]
    writes = [_fuzz_range(rng) for _ in range(rng.randint(0, 3))]
    if rng.randint(0, 19) == 0 and reads:
        reads[0] = (reads[0][0], reads[0][0])
    return TxnConflictInfo(snap, reads, writes)


def test_legacy_engine_matches_scan_and_the_oracle():
    TKNOBS.set("MAX_WRITE_TRANSACTION_LIFE_VERSIONS", 600)
    small = dict(device="cpu", capacity=1024, txns=64, reads_per_txn=4,
                 writes_per_txn=4)
    TKNOBS.set("CONFLICT_INTRA_MODE", "legacy")
    legacy = DeviceConflictSet(**small)
    TKNOBS.set("CONFLICT_INTRA_MODE", "scan")
    scan = DeviceConflictSet(**small)
    oracle = OracleConflictSet()
    rng = DeterministicRandom(55)
    version = 0
    for _batch in range(20):
        version += rng.randint(1, 250)
        txns = [_fuzz_txn(rng, version) for _ in range(rng.randint(1, 24))]
        a = legacy.detect(txns, version)
        b = scan.detect(txns, version)
        assert a == b == oracle.detect(txns, version), (a, b)


def test_unknown_intra_mode_is_refused():
    TKNOBS.set("CONFLICT_INTRA_MODE", "dense")
    with pytest.raises(FDBError) as ei:
        DeviceConflictSet(device="cpu", capacity=1024, txns=8)
    assert ei.value.name == "invalid_option"
