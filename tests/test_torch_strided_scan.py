"""The port's strided layout and `conflict_scan` against the JAX package.

The strided layout gives every txn NR/T read and NW/T write slots, unused
ones padded with empty ranges (bench.py's layout). Here K=1024, T=32 and
reads = writes = 64, so every txn has two slots of each and most batches
leave some padded. Batches come from the JAX strided encoder; the same
numpy batch feeds the jitted JAX `conflict_step` / `conflict_scan` on the
CPU and the port's plain step on the CPU. After every step the state, the
statuses and every `info` field must be EQUAL. Two JAX programs are
compiled here: the strided step and the strided scan.

The port's `DeviceConflictSet(strided=True)` is also held to the oracle on
the cases of tests/test_conflict.py (randomized parity with chunking, and
the rejection of a txn past its stride).
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import conflict as jconf
from foundationdb_tpu.ops.batch import TxnConflictInfo as JTxn
from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
from foundationdb_tpu_torch.ops.conflict import (ConflictShapes,
                                                 DeviceConflictSet)
from foundationdb_tpu_torch.ops.conflict_oracle import OracleConflictSet
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS
from foundationdb_tpu_torch.utils.rng import DeterministicRandom

CPU = torch.device("cpu")
SHAPES = jconf.ConflictShapes(capacity=1024, txns=32, reads=64, writes=64,
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


def assert_state_equal(jstate, tstate, where):
    want = to_np(jstate)
    got = ref.state_to_numpy(tstate)
    for k in ("bkeys", "bval", "nb", "oldest", "table", "poisoned"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} {where}")


def rand_range(rng, space):
    a = space[rng.integers(len(space))]
    kind = rng.integers(10)
    if kind < 5:
        return (a, a + b"\x00")  # point
    if kind == 5:
        return (a, a)  # empty but real: still counts as a read
    b = space[rng.integers(len(space))]
    if kind == 6:
        return (max(a, b), min(a, b))  # inverted (or empty)
    return (min(a, b), max(a, b) + b"\x00")


def rand_batch(rng, space, version, dense=False):
    """Up to T txns with 0-2 reads and 0-2 writes each (the stride is 2);
    `dense` makes every txn two blind point writes of fresh keys."""
    txns = []
    for _ in range(SHAPES.txns if dense else rng.integers(1, SHAPES.txns + 1)):
        snap = max(0, version - int(rng.integers(0, 8 * STEP)))
        if dense:
            keys = [b"d%09d" % rng.integers(10 ** 9) for _ in range(2)]
            txns.append(TxnConflictInfo(snap, [], [(k, k + b"\x00")
                                                   for k in keys]))
            continue
        txns.append(TxnConflictInfo(
            snap, [rand_range(rng, space) for _ in range(rng.integers(0, 3))],
            [rand_range(rng, space) for _ in range(rng.integers(0, 3))]))
    return txns


def encode(txns, version):
    """One strided numpy batch from the JAX encoder (copied out of its ring
    slot)."""
    enc = jconf.BatchEncoder(SHAPES)
    jtxns = [JTxn(t.read_snapshot, t.read_ranges, t.write_ranges)
             for t in txns]
    return {k: np.array(v) for k, v in enc.encode_batch(jtxns, version).items()}


def make_space(rng, n):
    return sorted({rng.integers(97, 123, rng.integers(1, 6)).astype(np.uint8)
                   .tobytes() for _ in range(n)})


@pytest.mark.parametrize("seed", [1, 2])
def test_strided_step_equals_jax(seed):
    rng = np.random.default_rng(seed)
    space = make_space(rng, 120)
    step = jconf._compiled_step(SHAPES, WINDOW)
    jstate = jconf.init_state(SHAPES)
    tstate = ref.state_from_numpy(to_np(jstate), CPU)
    version = STEP
    saw = {"poison": False, "conflict": False, "padded": False}
    for i in range(12):
        dense = i >= 3  # fresh boundaries every step: K=1024 overflows
        version += STEP // 20 if dense else int(rng.integers(STEP // 4,
                                                              3 * STEP))
        batch = encode(rand_batch(rng, space, version, dense), version)
        tstate = ref.state_from_numpy(to_np(jstate), CPU)
        jstate, jst, jinfo = step(jstate, batch)
        tstate, tst, tinfo = ref.conflict_step(
            tstate, ref.batch_from_numpy(batch, CPU), max_write_life=WINDOW,
            strided=True)
        where = f"seed {seed} step {i}"
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst),
                                      err_msg=f"statuses {where}")
        for k in INFO:
            np.testing.assert_array_equal(tinfo[k].numpy(),
                                          np.asarray(jinfo[k]),
                                          err_msg=f"info[{k}] {where}")
        assert_state_equal(jstate, tstate, where)
        saw["poison"] |= bool(tinfo["overflow"])
        saw["conflict"] |= bool((tst == 0).any())
        saw["padded"] |= bool((batch["rb"][-1] == 0xFFFFFFFF).any())
    assert all(saw.values()), saw


def test_strided_owners_mark_padding_by_the_length_limb():
    txns = [TxnConflictInfo(0, [(b"a", b"a")], [(b"b", b"c"), (b"d", b"e")]),
            TxnConflictInfo(0, [], [])]
    batch = ref.batch_from_numpy(encode(txns, 10), CPU)
    rt = ref.strided_owners(batch["rb"], SHAPES.txns)
    wt = ref.strided_owners(batch["wb"], SHAPES.txns)
    # txn 0's empty read is real; its second read slot and txn 1's are not
    assert rt[:4].tolist() == [0, 32, 32, 32]
    assert wt[:4].tolist() == [0, 0, 32, 32]


def test_port_strided_encoder_equals_jax():
    rng = np.random.default_rng(5)
    space = make_space(rng, 60)
    txns = rand_batch(rng, space, 3 * STEP)
    want = ref.batch_from_numpy(encode(txns, 3 * STEP), CPU)
    cs = DeviceConflictSet(device="cpu", capacity=1024, txns=32,
                           reads_per_txn=2, writes_per_txn=2, strided=True)
    got = cs.encoder.encode_batch(txns, 3 * STEP)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_conflict_scan_equals_jax():
    rng = np.random.default_rng(9)
    space = make_space(rng, 80)
    jstate = jconf.init_state(SHAPES)
    tstate = ref.state_from_numpy(to_np(jstate), CPU)
    batches, version = [], STEP
    for _ in range(4):
        version += int(rng.integers(STEP // 4, 2 * STEP))
        batches.append(encode(rand_batch(rng, space, version), version))
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    scan = jconf._compiled_scan(SHAPES, WINDOW)
    jfinal, jstat, jcomm, jovf = scan(jstate, stacked)
    port_batches = [ref.batch_from_numpy(b, CPU) for b in batches]
    tstacked = {k: torch.stack([b[k] for b in port_batches])
                for k in port_batches[0]}
    tfinal, tstat, tcomm, tovf = ref.conflict_scan(
        tstate, tstacked, max_write_life=WINDOW, strided=True)
    assert tstat.dtype == torch.int8 and tuple(tstat.shape) == (4, 32)
    np.testing.assert_array_equal(tstat.numpy(), np.asarray(jstat))
    np.testing.assert_array_equal(tcomm.numpy(), np.asarray(jcomm))
    np.testing.assert_array_equal(tovf.numpy(), np.asarray(jovf))
    assert_state_equal(jfinal, tfinal, "after the scan")
    assert int(tcomm.sum()) > 0


# ---------------------------------------------------------------------------
# the strided engine against the oracle (tests/test_conflict.py:194-227)
# ---------------------------------------------------------------------------

def _random_range(rng, space):
    a = space[rng.randint(0, len(space) - 1)]
    b = space[rng.randint(0, len(space) - 1)]
    return (a, a + b"\x00") if a == b else (min(a, b), max(a, b))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_strided_engine_matches_the_oracle(seed):
    """Decisions identical to the oracle, with txns of zero ranges, empty
    (b == e) read ranges (which still count for too-old), and batches
    chunked across several sub-batches."""
    TKNOBS.set("MAX_WRITE_TRANSACTION_LIFE_VERSIONS", 500)
    rng = DeterministicRandom(seed)
    dev = DeviceConflictSet(device="cpu", capacity=1024, txns=8,
                            reads_per_txn=3, writes_per_txn=3, strided=True)
    oracle = OracleConflictSet()
    space = [bytes([97 + i, 97 + j]) for i in range(6) for j in range(6)]
    version = 0
    for _batch in range(25):
        version += rng.randint(1, 300)
        txns = []
        for _ in range(rng.randint(1, 20)):  # > txns shape -> chunking
            snap = max(0, version - rng.randint(0, 800))
            reads = [_random_range(rng, space)
                     for _ in range(rng.randint(0, 3))]
            writes = [_random_range(rng, space)
                      for _ in range(rng.randint(0, 3))]
            if rng.randint(0, 9) == 0 and reads:
                reads[0] = (reads[0][0], reads[0][0])  # empty real range
            txns.append(TxnConflictInfo(snap, reads, writes))
        got = dev.detect(txns, version)
        assert got == oracle.detect(txns, version), f"@v{version}"


def test_strided_engine_rejects_a_txn_past_its_stride():
    dev = DeviceConflictSet(device="cpu", capacity=1024, txns=4,
                            reads_per_txn=2, writes_per_txn=2, strided=True)
    big = TxnConflictInfo(0, [(bytes([97 + i]), bytes([98 + i]))
                              for i in range(3)], [])
    with pytest.raises(FDBError) as ei:
        dev.detect([big], 100)
    assert ei.value.name == "transaction_too_large"


def test_strided_shapes_need_divisible_slots():
    ConflictShapes(capacity=1024, txns=8, reads=12, writes=16)
    with pytest.raises(ValueError):
        ConflictShapes(capacity=1024, txns=8, reads=12, writes=16,
                       strided=True)
