"""The port's conflict engine against the JAX engine and the oracle.

`DeviceConflictSet(device="cpu")` of foundationdb_tpu_torch runs the plain
PyTorch step (the kernels' plain versions, because its tensors lie on the
CPU). Each case feeds the same batches to it, to the JAX `DeviceConflictSet`
(jitted on the CPU) and to the port's `OracleConflictSet`: every decision
must be equal. The JAX engine is held to ONE compiled program (K=1024, T=64,
4/4, the default window) by pinning its shape bucket, so the file pays one
cold compile; cases that need another window or shape compare the port with
the oracle only.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import conflict as jconf
from foundationdb_tpu.ops.batch import TxnConflictInfo as JTxn
from foundationdb_tpu_torch.ops.batch import (COMMITTED, CONFLICT, TOO_OLD,
                                              TxnConflictInfo)
from foundationdb_tpu_torch.ops.conflict import DeviceConflictSet
from foundationdb_tpu_torch.ops.conflict_oracle import OracleConflictSet
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS

SMALL = dict(capacity=1024, txns=64, reads_per_txn=4, writes_per_txn=4)
S = 10_000  # version scale: the default 5e6 window is 500 scaled versions


@pytest.fixture(autouse=True)
def _reset_port_knobs():
    TKNOBS.reset()
    yield
    TKNOBS.reset()


@pytest.fixture
def jax_engine(monkeypatch):
    """Factory of JAX engines pinned to the full shape bucket."""
    def plan_chunk(self, nr, nw):
        return self.shapes, jconf._compiled_step(
            self.shapes, 5_000_000, *self._intra)
    monkeypatch.setattr(jconf.DeviceConflictSet, "plan_chunk", plan_chunk)
    return lambda: jconf.DeviceConflictSet(**SMALL)


def rand_bytes(rng, lo, hi, n):
    """n random bytes in [lo, hi)."""
    return rng.integers(lo, hi, n).astype(np.uint8).tobytes()


def port(**kw):
    return DeviceConflictSet(device="cpu", **{**SMALL, **kw})


def txn(snap, reads=(), writes=()):
    return TxnConflictInfo(read_snapshot=snap, read_ranges=list(reads),
                           write_ranges=list(writes))


def check(engines, txns, version):
    """Every engine decides the batch the same way; returns the decisions."""
    got = []
    for e in engines:
        if isinstance(e, jconf.DeviceConflictSet):
            got.append(e.detect([JTxn(t.read_snapshot, t.read_ranges,
                                      t.write_ranges) for t in txns], version))
        else:
            got.append(e.detect(txns, version))
    assert all(g == got[0] for g in got), f"decisions differ @v{version}: {got}"
    return got[0]


def p(k):
    return (k, k + b"\x00")


# ---------------------------------------------------------------------------
# targeted semantics: (batches, versions, expected statuses or None)
# ---------------------------------------------------------------------------

def _long_chain():
    batch = [txn(0, writes=[p(b"k0")])]
    batch += [txn(0, reads=[p(b"k%d" % (i - 1))], writes=[p(b"k%d" % i)])
              for i in range(1, 20)]
    return [(batch, 100, [COMMITTED if i % 2 == 0 else CONFLICT
                          for i in range(20)])]


TARGETED = {
    "blind_writes_always_commit": [
        ([txn(0, writes=[(b"a", b"b")])], 100, [COMMITTED]),
        ([txn(0, writes=[(b"a", b"b")])], 200, [COMMITTED])],
    "read_write_conflict_and_snapshot_isolation": [
        ([txn(0, writes=[p(b"k")])], 100, None),
        ([txn(50, reads=[p(b"k")])], 200, [CONFLICT]),
        ([txn(150, reads=[p(b"k")])], 300, [COMMITTED])],
    "adjacent_ranges_do_not_conflict": [
        ([txn(0, writes=[(b"a", b"b")])], 100, None),
        ([txn(50, reads=[(b"b", b"c")])], 200, [COMMITTED]),
        ([txn(50, reads=[(b"a\xff\xff", b"b")])], 300, [CONFLICT])],
    "intra_batch_earlier_txn_wins": [
        ([txn(0, writes=[p(b"x")]),
          txn(0, reads=[p(b"x")], writes=[p(b"y")]),
          txn(0, reads=[p(b"y")])], 100, [COMMITTED, CONFLICT, COMMITTED])],
    "intra_batch_long_chain": _long_chain(),
    "own_writes_do_not_conflict": [
        ([txn(0, reads=[(b"a", b"b")], writes=[(b"a", b"b")])], 100,
         [COMMITTED])],
    "empty_batch_and_empty_txn": [
        ([], 100, []), ([txn(0)], 200, [COMMITTED])],
    "range_write_vs_point_read": [
        ([txn(0, writes=[(b"a", b"q")])], 100, None),
        ([txn(10, reads=[p(b"m")])], 200, [CONFLICT]),
        ([txn(10, reads=[p(b"q")])], 300, [COMMITTED])],
    "inverted_write_does_not_cancel_other_writes": [
        ([txn(0, writes=[(b"c", b"a")]), txn(0, writes=[(b"b", b"d")])], 100,
         None),
        ([txn(50, reads=[p(b"b")])], 200, [CONFLICT])],
    "empty_and_inverted_ranges_are_inert_intra_batch": [
        ([txn(0, writes=[(b"a", b"z")]), txn(0, reads=[(b"m", b"m")]),
          txn(0, reads=[(b"q", b"c")]), txn(0, writes=[(b"zx", b"c")]),
          txn(0, reads=[p(b"zx")])], 100, [COMMITTED] * 5)],
    "chunking_preserves_batch_order": [
        # 130 txns -> three chunks of the 64-txn shape
        ([txn(0, writes=[p(b"c0")])]
         + [txn(0, reads=[p(b"c%d" % (i - 1))], writes=[p(b"c%d" % i)])
            for i in range(1, 130)], 100,
         [COMMITTED if i % 2 == 0 else CONFLICT for i in range(130)])],
}


@pytest.mark.parametrize("case", sorted(TARGETED))
def test_targeted_semantics_match_jax_and_oracle(case, jax_engine):
    engines = (port(), jax_engine(), OracleConflictSet())
    for batch, version, want in TARGETED[case]:
        got = check(engines, batch, version)
        if want is not None:
            assert got == want, f"{case} @v{version}: {got}"


def test_long_key_collapse_is_conservative_like_jax(jax_engine):
    """Keys sharing a 24-byte prefix collapse on the device: a stale read of
    the other key conflicts (never a miss), in both engines alike."""
    engines = (port(), jax_engine())
    long_a, long_b = b"p" * 28 + b"AAAA", b"p" * 28 + b"BBBB"
    check(engines, [txn(0, writes=[p(long_a)])], 100)
    assert check(engines, [txn(50, reads=[p(long_b)])], 200) == [CONFLICT]
    assert check(engines, [txn(150, reads=[p(long_b)])], 300) == [COMMITTED]


def test_rebase_preserves_conflicts_and_rejects_saturated_snapshots(
        jax_engine):
    engines = (port(), jax_engine())
    check(engines, [txn(0, writes=[p(b"a")])], 10)
    s = check(engines, [txn(5, reads=[p(b"a")], writes=[p(b"b")])],
              (1 << 30) + 77)
    assert s == [CONFLICT]
    engines = (port(), jax_engine())
    check(engines, [txn(0, writes=[p(b"a")])], 10)
    s = check(engines, [txn(5, reads=[p(b"a")], writes=[p(b"b")])], 1 << 31)
    assert s == [TOO_OLD]


# ---------------------------------------------------------------------------
# the MVCC window (a knob): port against the oracle
# ---------------------------------------------------------------------------

def test_too_old_and_window_gc():
    TKNOBS.set("MAX_WRITE_TRANSACTION_LIFE_VERSIONS", 1000)
    engines = (port(), OracleConflictSet())
    check(engines, [txn(0, writes=[(b"a", b"b")])], 5000)
    assert check(engines, [txn(100, reads=[p(b"z")])], 6000) == [TOO_OLD]
    assert check(engines, [txn(100, writes=[p(b"z")])], 6100) == [COMMITTED]
    engines = (port(), OracleConflictSet())
    check(engines, [txn(0, writes=[(b"a", b"b")])], 100)
    check(engines, [txn(50, writes=[(b"m", b"n")])], 1050)
    assert check(engines, [txn(60, reads=[(b"m", b"n")])], 1100) == [CONFLICT]


def test_chunked_batch_uses_pre_batch_window_floor():
    TKNOBS.set("MAX_WRITE_TRANSACTION_LIFE_VERSIONS", 1000)
    engines = (port(txns=2, reads_per_txn=2, writes_per_txn=2),
               OracleConflictSet())
    batch = [txn(4900, writes=[(b"a", b"b")]), txn(4900, writes=[(b"c", b"d")]),
             txn(100, reads=[p(b"zz")])]  # 3rd txn -> 2nd chunk
    assert check(engines, batch, 5000) == [COMMITTED] * 3
    assert check(engines, [txn(100, reads=[p(b"zz")])], 5100) == [TOO_OLD]


def test_state_survives_many_batches_with_gc():
    TKNOBS.set("MAX_WRITE_TRANSACTION_LIFE_VERSIONS", 1000)
    rng = np.random.default_rng(99)
    dev = port(capacity=512)
    engines = (dev, OracleConflictSet())
    space = [b"k%02d" % i for i in range(30)]
    version = 0
    for _ in range(40):
        version += int(rng.integers(50, 200))
        check(engines, [txn(max(0, version - int(rng.integers(0, 1500))),
                            [rand_range(rng, space)], [rand_range(rng, space)])
                        for _ in range(rng.integers(1, 10))], version)
    assert int(dev._state["nb"]) <= 2 * len(space) + 2


def test_narrow_engine_and_its_long_key_collapse():
    rng = np.random.default_rng(21)
    engines = (port(key_bytes=16), OracleConflictSet())
    space = [b"." * 12 + bytes([97 + i, 97 + j])
             for i in range(5) for j in range(5)]
    version = 0
    for _ in range(15):
        version += int(rng.integers(1, 300)) * S
        check(engines, rand_batch(rng, space, version, 30, 3), version)
    dev = port(key_bytes=16)
    long_a, long_b = b"p" * 20 + b"AAAA", b"p" * 20 + b"BBBB"
    assert dev.detect([txn(0, writes=[p(long_a)])], 100) == [COMMITTED]
    assert dev.detect([txn(50, reads=[p(long_b)])], 200) == [CONFLICT]


def test_full_capacity_merge_above_all_boundaries():
    cs = port(capacity=4, txns=4, reads_per_txn=1, writes_per_txn=1)
    version = 1000

    def k(i):
        return int(i).to_bytes(4, "big")
    for lo, hi in ((10, 20), (20, 30)):
        version += 1
        assert cs.detect([txn(version - 2, writes=[(k(lo), k(hi))])],
                         version) == [COMMITTED]
    version += 6_000_000
    assert cs.detect([txn(version - 1, writes=[(k(100), k(200))])],
                     version) == [COMMITTED]
    assert cs.detect([txn(version - 1, reads=[(k(200), k(300))]),
                      txn(version - 1, reads=[(k(150), k(160))])],
                     version + 1) == [COMMITTED, CONFLICT]


def test_overflow_poisons_and_raises_never_truncates():
    tiny = port(capacity=64, txns=32, reads_per_txn=1, writes_per_txn=1)
    v = 0
    with pytest.raises(FDBError) as ei:
        for i in range(20):
            v += 10
            tiny.detect([txn(0, writes=[(b"%04d" % (i * 31 + j),
                                         b"%04da" % (i * 31 + j))])
                         for j in range(31)], v)
    assert ei.value.name == "internal_error"
    assert bool(tiny._state["poisoned"]) and int(tiny._state["nb"]) == 1


def test_oversized_transaction_is_rejected():
    dev = port(txns=4, reads_per_txn=1, writes_per_txn=1)
    big = txn(0, reads=[p(bytes([97 + i])) for i in range(5)])
    with pytest.raises(FDBError) as ei:
        dev.detect([big], 100)
    assert ei.value.name == "transaction_too_large"


def test_capped_rounds_fall_back_to_the_exact_host_pass():
    """One sandwich round cannot converge a deep chain: the host pass must
    still give the oracle's statuses (fresh sets per batch, since an
    unconverged merge is conservative). The UnconvergedChunks counter
    counts each chunk that the host pass decided."""
    from foundationdb_tpu_torch.ops.conflict import kernel_metrics
    TKNOBS.set("CONFLICT_INTRA_ROUNDS", 1)
    rng = np.random.default_rng(77)
    for trial in range(4):
        engines = (port(), OracleConflictSet())
        batch = (_long_chain()[0][0] if trial == 0 else
                 [fuzz_txn(rng, 100) for _ in range(rng.integers(8, 30))])
        before = kernel_metrics.as_dict()["UnconvergedChunks"]
        check(engines, batch, 100)
        if trial == 0:
            assert kernel_metrics.as_dict()["UnconvergedChunks"] == before + 1


# ---------------------------------------------------------------------------
# randomized parity, three ways
# ---------------------------------------------------------------------------

def rand_range(rng, space):
    a, b = space[rng.integers(len(space))], space[rng.integers(len(space))]
    if a == b:
        return p(a)
    return (min(a, b), max(a, b))


def rand_batch(rng, space, version, max_txns, max_ranges):
    return [txn(max(0, version - int(rng.integers(0, 800)) * S),
                [rand_range(rng, space)
                 for _ in range(rng.integers(0, max_ranges + 1))],
                [rand_range(rng, space)
                 for _ in range(rng.integers(0, max_ranges + 1))])
            for _ in range(rng.integers(1, max_txns + 1))]


def fuzz_key(rng):
    return rand_bytes(rng, 97, 100, rng.integers(1, 6))


def fuzz_range(rng):
    a = fuzz_key(rng)
    kind = rng.integers(10)
    if kind < 4:
        return p(a)
    if kind < 7:
        return (a, a + b"\xff")  # getRange(prefix)
    b = fuzz_key(rng)
    return p(a) if a == b else (min(a, b), max(a, b))


def fuzz_txn(rng, version):
    snap = max(0, version - int(rng.integers(0, 900)) * S)
    if rng.integers(6) == 0:  # snapshot reads: a blind write
        return txn(snap, [], [fuzz_range(rng) for _ in range(rng.integers(1, 4))])
    reads = [fuzz_range(rng) for _ in range(rng.integers(0, 4))]
    writes = [fuzz_range(rng) for _ in range(rng.integers(0, 4))]
    if rng.integers(20) == 0 and reads:
        reads[0] = (reads[0][0], reads[0][0])  # empty range: inert but real
    return txn(snap, reads, writes)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_randomized_parity(seed, jax_engine):
    rng = np.random.default_rng(seed)
    engines = (port(), jax_engine(), OracleConflictSet())
    space = [bytes([97 + i, 97 + j]) for i in range(6) for j in range(6)]
    version = 0
    for _ in range(20):
        version += int(rng.integers(1, 300)) * S
        check(engines, rand_batch(rng, space, version, 30, 2), version)


@pytest.mark.parametrize("seed", [11, 12])
def test_randomized_parity_long_keys_and_prefixes(seed, jax_engine):
    rng = np.random.default_rng(seed)
    engines = (port(), jax_engine(), OracleConflictSet())
    space = [b"/".join(rand_bytes(rng, 0, 256, rng.integers(1, 6))
                       for _ in range(rng.integers(1, 5)))[:24]
             for _ in range(40)]
    version = 0
    for _ in range(12):
        version += int(rng.integers(1, 200)) * S
        check(engines, rand_batch(rng, space, version, 20, 4), version)


@pytest.mark.parametrize("seed", [31, 32])
def test_deep_parity_fuzz(seed, jax_engine):
    rng = np.random.default_rng(seed)
    engines = (port(), jax_engine(), OracleConflictSet())
    version = 0
    for _ in range(60):
        version += int(rng.integers(1, 250)) * S
        check(engines, [fuzz_txn(rng, version)
                        for _ in range(rng.integers(1, 24))], version)


# ---------------------------------------------------------------------------
# device choice, wrappers, import isolation
# ---------------------------------------------------------------------------

def test_knob_assignment_is_a_set_that_reset_undoes():
    # an assignment used to become an instance attribute that shadowed the
    # bank and outlived reset(), so it leaked into later tests of a worker
    TKNOBS.CONFLICT_INTRA_MODE = "legacy"
    assert TKNOBS.CONFLICT_INTRA_MODE == "legacy"
    TKNOBS.reset()
    assert TKNOBS.CONFLICT_INTRA_MODE == "scan"
    TKNOBS.set("CONFLICT_INTRA_MODE", "dense")
    with pytest.raises(FDBError) as ei:
        DeviceConflictSet(device="cpu", capacity=1024, txns=8)
    assert ei.value.name == "invalid_option"
    with pytest.raises(KeyError):
        TKNOBS.NO_SUCH_KNOB = 1


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert TKNOBS.CONFLICT_DEVICE == "cuda"
    with pytest.raises(FDBError) as ei:
        DeviceConflictSet(**SMALL)
    assert ei.value.name == "platform_error"
    with pytest.raises(FDBError):
        DeviceConflictSet(device="meta", **SMALL)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib, foundationdb_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'foundationdb_tpu'\n"
        "       or m.startswith('foundationdb_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('foundationdb_tpu_torch.')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20

