"""The port's kernel wrappers and host encoder, with no JAX in the process.

On the CPU (here) each wrapper runs its plain version and counts no launch.
The tests marked `cuda` hold every Hopper kernel to its plain version on a
card, on the phase inputs of real steps, and the CUDA engine to the oracle;
they skip where there is no card. This file imports nothing of JAX, so it
runs on the GPU machine as it is (see README, "PyTorch/CUDA port").
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops import kernels
from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
from foundationdb_tpu_torch.ops.conflict import DeviceConflictSet
from foundationdb_tpu_torch.ops.conflict_oracle import OracleConflictSet
from foundationdb_tpu_torch.utils import keys as keylib
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS

SMALL = dict(capacity=1024, txns=64, reads_per_txn=4, writes_per_txn=4)


@pytest.fixture(autouse=True)
def _reset_port_knobs():
    KNOBS.reset()
    yield
    KNOBS.reset()


def point(k):
    return (k, k + b"\x00")


def fuzz_range(rng):
    a = rng.integers(97, 100, rng.integers(1, 6)).astype(np.uint8).tobytes()
    kind = rng.integers(10)
    if kind < 5:
        return point(a)
    if kind < 7:
        return (a, a + b"\xff")
    b = rng.integers(97, 100, rng.integers(1, 6)).astype(np.uint8).tobytes()
    return point(a) if a == b else (min(a, b), max(a, b))


def fuzz_batch(rng, version, n):
    return [TxnConflictInfo(max(0, version - int(rng.integers(0, 2000))),
                            [fuzz_range(rng) for _ in range(rng.integers(0, 4))],
                            [fuzz_range(rng) for _ in range(rng.integers(0, 4))])
            for _ in range(n)]


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

def test_wrappers_run_plain_versions_on_cpu_and_count_no_launch():
    kernels.reset_launches()
    rng = np.random.default_rng(4)
    vals = torch.from_numpy(rng.integers(-(1 << 30), 1 << 20, 300)
                            .astype(np.int32))
    assert torch.equal(kernels.build_table(vals), ref.build_table(vals))
    cs = DeviceConflictSet(device="cpu", **SMALL)
    cs.detect(fuzz_batch(rng, 1000, 40), 1000)
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_wrappers_refuse_other_devices():
    with pytest.raises(FDBError) as ei:
        kernels.build_table(torch.zeros(8, dtype=torch.int32, device="meta"))
    assert ei.value.name == "invalid_option"


@pytest.mark.parametrize("round_up", [False, True])
def test_bulk_encoder_equals_the_per_key_encoder(round_up):
    rng = np.random.default_rng(6)
    keys = [b"", b"\x00", b"a" * 24, b"a" * 25, b"\xff" * 40]
    keys += [rng.integers(0, 256, rng.integers(0, 40)).astype(np.uint8)
             .tobytes() for _ in range(200)]
    for key_bytes in (4, 16, 24):
        want = np.stack([keylib.encode_key(k, round_up=round_up,
                                           key_bytes=key_bytes)
                         for k in keys], axis=1)
        got = keylib.encode_keys_bulk(keys, key_bytes, round_up=round_up)
        np.testing.assert_array_equal(got, want)
        back = keylib.from_signed_limbs(keylib.to_signed_limbs(got))
        np.testing.assert_array_equal(back, want)


def test_signed_limbs_keep_the_key_order():
    rng = np.random.default_rng(7)
    keys = sorted({rng.integers(0, 256, rng.integers(0, 30)).astype(np.uint8)
                   .tobytes() for _ in range(300)})
    limbs = keylib.to_signed_limbs(keylib.encode_keys_bulk(keys))
    cols = [tuple(limbs[:, i]) for i in range(len(keys))]
    assert cols == sorted(cols)


def test_encoder_buckets_and_packed_batch():
    cs = DeviceConflictSet(device="cpu", **SMALL)
    enc = cs.encoder
    shapes = {(enc.bucket_shapes(nr, nw).reads, enc.bucket_shapes(nr, nw).writes)
              for nr in (0, 16, 17, 256) for nw in (0, 16, 17, 256)}
    assert shapes == {(16, 16), (16, 256), (256, 16), (256, 256)}
    txns = [TxnConflictInfo(5, [point(b"a")], [point(b"b"), (b"c", b"d")]),
            TxnConflictInfo(7, [], [])]
    batch = enc.encode_batch(txns, 100, skip=[False, False],
                             shapes=enc.bucket_shapes(1, 2),
                             advance_floor=False)
    assert batch["rb"].shape == (7, 16) and batch["wb"].shape == (7, 16)
    assert batch["rtxn"][:2].tolist() == [0, 64]
    assert batch["wtxn"][:3].tolist() == [0, 0, 64]
    assert batch["snapshot"][:2].tolist() == [5, 7]
    assert batch["txn_valid"][:3].tolist() == [True, True, False]
    assert int(batch["commit_version"]) == 100
    assert not bool(batch["advance_floor"])
    assert batch["rb"][:, 0].tolist() == keylib.to_signed_limbs(
        keylib.encode_key(b"a")).tolist()
    assert int(batch["we"][6, 1]) == keylib.to_signed_limbs(
        np.array([1], np.uint32))[0]  # the length limb of b"d"


# ---------------------------------------------------------------------------
# on the card: every kernel equals its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    return torch.device("cuda")


def _to(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device, copy=True)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to(v, device) for v in obj)
    return obj


def _captured_phases(batches):
    """Run `batches` through a CPU engine with the plain phases, recording
    every phase call's arguments (copied: batch tensors are views of a
    reused encode slot)."""
    calls = {name: [] for name in kernels.KERNELS}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name].append(_to((a, kw), torch.device("cpu")))
            return fn(*a, **kw)
        return wrapped
    spied = type(ref.PLAIN)(
        build_table=spy("sparse_table", ref.build_table),
        history_check=spy("history_check", ref.history_check),
        intra_sweep=spy("intra_sweep", ref.intra_sweep),
        merge_compact=spy("merge_compact", ref.merge_compact))
    cs = DeviceConflictSet(device="cpu", **SMALL)
    for txns, version in batches:
        batch = cs.encoder.encode_batch(txns, version)
        cs._state, _s, _i = ref.conflict_step(
            cs._state, batch, max_write_life=5_000_000, phases=spied)
    return calls


@pytest.mark.cuda
def test_kernels_equal_plain_versions_on_the_card(cuda):
    rng = np.random.default_rng(8)
    batches, version = [], 0
    for _ in range(6):
        version += int(rng.integers(1, 300)) * 10
        batches.append((fuzz_batch(rng, version, 64), version))
    calls = _captured_phases(batches)
    kernels.reset_launches()
    pairs = {"sparse_table": (kernels.build_table, ref.build_table),
             "history_check": (kernels.history_check, ref.history_check),
             "intra_sweep": (kernels.intra_sweep, ref.intra_sweep),
             "merge_compact": (kernels.merge_compact, ref.merge_compact)}
    for name, (kern, plain) in pairs.items():
        for a, kw in calls[name]:
            want = plain(*a, **kw)
            got = kern(*_to(a, cuda), **_to(kw, cuda))
            torch.cuda.synchronize()
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            for w, g in zip(want, got):
                assert torch.equal(g.cpu(), w), name
        assert kernels.LAUNCHES[name] == len(calls[name]) > 0


@pytest.mark.cuda
def test_cuda_engine_matches_the_oracle(cuda):
    rng = np.random.default_rng(9)
    dev = DeviceConflictSet(device="cuda", **SMALL)
    oracle = OracleConflictSet()
    version = 0
    for _ in range(30):
        version += int(rng.integers(1, 300)) * 10
        txns = fuzz_batch(rng, version, int(rng.integers(1, 150)))
        assert dev.detect(txns, version) == oracle.detect(txns, version)
