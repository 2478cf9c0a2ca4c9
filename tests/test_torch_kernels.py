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
SORT_KERNELS = ("endpoint_sort", "state_merge", "endpoint_ranks")


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


def test_release_scratch_drops_the_cached_buffers():
    cpu = torch.device("cpu")
    buf = kernels._scratch("probe", 8, torch.int32, cpu)
    zero = kernels._zeroed_scratch("probe", 8, torch.int32, cpu)
    assert kernels._scratch("probe", 8, torch.int32, cpu) is buf
    kernels.release_scratch()
    assert kernels._scratch("probe", 8, torch.int32, cpu) is not buf
    assert kernels._zeroed_scratch("probe", 8, torch.int32, cpu) is not zero
    kernels.release_scratch()


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
    calls = {name: [] for name in (*kernels.KERNELS, "sort_and_rank")}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name].append(_to((a, kw), torch.device("cpu")))
            return fn(*a, **kw)
        return wrapped
    spied = type(ref.PLAIN)(
        sort_and_rank=spy("sort_and_rank", ref.sort_and_rank),
        build_table=spy("sparse_table", ref.build_table),
        history_check=spy("history_check", ref.history_check),
        intra_levels=spy("intra_levels", ref.intra_levels),
        intra_sandwich=spy("intra_sandwich", ref.intra_sandwich),
        merge_compact=spy("merge_compact", ref.merge_compact),
        legacy_fixpoint=spy("legacy_blocked", ref.legacy_fixpoint),
        step_masks=spy("step_masks", ref.step_masks),
        step_verdicts=spy("step_verdicts", ref.step_verdicts))
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
    pairs = {"sort_and_rank": (kernels.sort_and_rank, ref.sort_and_rank),
             "sparse_table": (kernels.build_table, ref.build_table),
             "history_check": (kernels.history_check, ref.history_check),
             "intra_levels": (kernels.intra_levels, ref.intra_levels),
             "intra_sandwich": (kernels.intra_sandwich, ref.intra_sandwich),
             "merge_compact": (kernels.merge_compact, ref.merge_compact),
             "step_masks": (kernels.step_masks, ref.step_masks),
             "step_verdicts": (kernels.step_verdicts, ref.step_verdicts)}
    for name, (kern, plain) in pairs.items():
        for a, kw in calls[name]:
            want = plain(*a, **kw)
            got = kern(*_to(a, cuda), **_to(kw, cuda))
            torch.cuda.synchronize()
            if isinstance(want, dict):
                want, got = tuple(want.values()), tuple(got.values())
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            for w, g in zip(want, got):
                assert torch.equal(g.cpu(), w), name
        for part in SORT_KERNELS if name == "sort_and_rank" else (name,):
            assert kernels.LAUNCHES[part] == len(calls[name]) > 0


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


def _bench_step_calls(T, mode, device):
    """The phase calls of the second of two strided kernel-bench steps at T
    txns (K=2^14) with the plain phases on `device`."""
    from foundationdb_tpu_torch import bench
    batches = bench.stage(bench._encode_batches(2, seed=3,
                                                version0=bench.WINDOW, T=T),
                          device)
    state = ref.init_state(1 << 14, bench.LIMBS, device)
    calls = {}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.setdefault(name, []).append(_to((a, kw), device))
            return fn(*a, **kw)
        return wrapped
    spied = type(ref.PLAIN)(
        sort_and_rank=spy("sort_and_rank", ref.sort_and_rank),
        build_table=spy("sparse_table", ref.build_table),
        history_check=spy("history_check", ref.history_check),
        intra_levels=spy("intra_levels", ref.intra_levels),
        intra_sandwich=spy("intra_sandwich", ref.intra_sandwich),
        merge_compact=spy("merge_compact", ref.merge_compact),
        legacy_fixpoint=spy("legacy_blocked", ref.legacy_fixpoint),
        step_masks=spy("step_masks", ref.step_masks),
        step_verdicts=spy("step_verdicts", ref.step_verdicts))
    for i in range(2):
        calls.clear()
        state, _s, _i = ref.conflict_step(
            state, {k: v[i] for k, v in batches.items()},
            max_write_life=bench.WINDOW, intra_mode=mode, strided=True,
            phases=spied)
    return calls


def _sandwich_equal(a, kw):
    """The kernel's (lower, upper, converged) and evaluation count against
    the plain sandwich's on one call; returns the count."""
    dev = a[0].device
    want_n = torch.zeros((), dtype=torch.int32, device=dev)
    got_n = torch.zeros((), dtype=torch.int32, device=dev)
    want = ref.intra_sandwich(*a, **kw, evals=want_n)
    got = kernels.intra_sandwich(*a, **kw, evals=got_n)
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(g, w)
    assert int(got_n) == int(want_n) >= 1
    return int(got_n)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1024, 16384])
def test_sweep_kernel_takes_any_level_width(cuda, T):
    # M = 3T: 3,072 and 49,152 elements a level; the sandwich kernel keeps
    # every level element of its CTA's share on chip, for any M
    calls = _bench_step_calls(T, "scan", cuda)["intra_sandwich"]
    assert calls[0][0][1]["src"].shape[1] == 3 * T
    for a, kw in calls:
        for rounds in (0, 1, a[7]):
            _sandwich_equal(a[:7] + (rounds,), kw)


def _equal_to_plain(kern, plain, calls):
    for a, kw in calls:
        want = plain(*a, **kw)
        got = kern(*a, **kw)
        torch.cuda.synchronize()
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want)
        for w, g in zip(want, got):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_table_kernel_at_edge_widths(cuda):
    # one launch up to K=1,024, two above; the same edges as chip_smoke.py
    import chip_smoke
    calls = chip_smoke.table_edge_calls(cuda)
    kernels.reset_launches()
    _equal_to_plain(kernels.build_table, ref.build_table, calls)
    assert kernels.LAUNCHES["sparse_table"] == len(calls)


@pytest.mark.cuda
def test_history_kernel_on_edge_inputs(cuda):
    # shuffled reads, T=1 and 33, txns without reads, snapshots below the
    # floor, all reads padding, a bench step at T=32,768 (chip_smoke.py's
    # edges); the bit-set scratch is left zero: each call again gives the
    # same answer
    import chip_smoke
    calls = chip_smoke.history_edge_calls(cuda)
    _equal_to_plain(kernels.history_check, ref.history_check, calls + calls)
    # the verdicts do not depend on the order of the reads
    a, kw = calls[-1]
    got = kernels.history_check(*chip_smoke.shuffled_reads((a, kw), 7)[0])
    for w, g in zip(ref.history_check(*a, **kw), got):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1024, 16384])
def test_table_and_history_kernels_on_a_bench_step(cuda, T):
    calls = _bench_step_calls(T, "scan", cuda)
    _equal_to_plain(kernels.build_table, ref.build_table,
                    calls["sparse_table"])
    _equal_to_plain(kernels.history_check, ref.history_check,
                    calls["history_check"])


def _chain_sandwich_args(T, device):
    """A dependency chain through all T txns: txn t reads the key txn t - 1
    writes, so the verdicts alternate and the sandwich needs about T / 2
    rounds to pinch."""
    ar = torch.arange(T, dtype=torch.int32)
    wtxn, rtxn = ar.clone(), ar.clone()
    wbr, wer = ar + 1, ar + 2
    rbr, rer = ar.clone(), ar + 1
    ok = torch.ones(T, dtype=torch.bool)
    geo = ref.intra_levels(T, wtxn, rtxn, rbr, rer, wbr, wer)
    args = (ok, geo, wtxn, ok, ok, rtxn, rbr)
    return _to(args, device)


@pytest.mark.cuda
def test_sandwich_kernel_leaves_a_deep_chain_unconverged(cuda):
    # 128 txns deep: 64 rounds pinch it, the default 32 do not
    a = _chain_sandwich_args(128, cuda)
    for rounds in (0, 1, 2, 32):
        kernels.reset_launches()
        n = _sandwich_equal(a + (rounds,), {})
        assert kernels.LAUNCHES["intra_sandwich"] == 1
        assert n == 1 + 2 * rounds
        assert not bool(kernels.intra_sandwich(*a, rounds)[2])
    assert _sandwich_equal(a + (70,), {}) == 1 + 2 * 64
    assert bool(kernels.intra_sandwich(*a, 70)[2])


@pytest.mark.cuda
def test_sandwich_kernel_raises_when_the_launch_is_refused(cuda):
    # a launch the library refuses (no txns: T = 0) raises and counts no
    # launch; 2^20 txns, whose bit sets overflow an SM's shared memory,
    # are no longer refused (test_sandwich_kernel_at_2_20_txns)
    one = torch.zeros(1, dtype=torch.int32)
    geo = ref.intra_levels(1, one, one, one, one + 1, one, one + 1)
    ok = torch.ones(1, dtype=torch.bool)
    g = torch.ones(0, dtype=torch.bool)
    a = _to((g, geo, one, ok, ok, one, one), cuda)
    kernels.reset_launches()
    with pytest.raises(FDBError) as ei:
        kernels.intra_sandwich(*a, 4)
    assert ei.value.name == "internal_error"
    assert kernels.LAUNCHES["intra_sandwich"] == 0
    # the card is still usable: a small sandwich launches as before
    _sandwich_equal(_chain_sandwich_args(64, cuda) + (4,), {})


@pytest.mark.cuda
def test_sandwich_kernel_at_2_20_txns(cuda):
    # one read and one write a txn (chip_smoke.py's call): 3 T / 8 = 384 KB
    # of bit sets, so K3 keeps them in global memory; the geometry is K9's,
    # held to the plain geometry field for field
    import chip_smoke
    (levels, _kw), (sandwich, _kw) = chip_smoke.big_step_calls(cuda)
    kernels.reset_launches()
    geo = kernels.intra_levels(*levels)
    want = ref.intra_levels(*levels)
    torch.cuda.synchronize()
    for k in want:
        assert torch.equal(geo[k], want[k]), k
    a = (sandwich[0], geo) + sandwich[2:7]
    for rounds in (sandwich[7], 1):
        _sandwich_equal(a + (rounds,), {})
    assert kernels.LAUNCHES["intra_levels"] == 1
    assert kernels.LAUNCHES["intra_sandwich"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1024, 16384])
def test_level_kernel_on_a_bench_step(cuda, T):
    # K9 field for field against the plain geometry on a bench step's call;
    # the strided layout's owners are in order, so each call takes the span
    # path
    calls = _bench_step_calls(T, "scan", cuda)["intra_levels"]
    kernels.reset_launches()
    kernels.level_paths(reset=True)
    for a, kw in calls:
        want = ref.intra_levels(*a, **kw)
        got = kernels.intra_levels(*a, **kw)
        torch.cuda.synchronize()
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k]), k
    assert kernels.LAUNCHES["intra_levels"] == len(calls) > 0
    assert kernels.level_paths()["span"] == len(calls)


@pytest.mark.cuda
def test_level_kernel_on_edge_inputs(cuda):
    # T = 1, T off a power of two, all padding, shuffled owners, heavy ties
    # (chip_smoke.py's edges); the barrier word is left as it was found:
    # each call again gives the same answer
    import chip_smoke
    calls = chip_smoke.level_edge_calls(cuda)
    for a, kw in calls + calls:
        want = ref.intra_levels(*a, **kw)
        got = kernels.intra_levels(*a, **kw)
        torch.cuda.synchronize()
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_level_kernel_span_path_equals_the_general_path(cuda):
    # K9 at the span path's edges (chip_smoke.py's): nondecreasing owners
    # against the same owners shuffled, a span past its shared memory, and
    # every call again with the span size forced to 0 (the general path),
    # 1 and n_levels: every run equal to the plain geometry
    # the kernel's own count of its paths and grid barriers: owners out of
    # order or s = 0 take the general path, and each path makes the grid
    # barriers that kernels.level_plan works out
    import chip_smoke
    calls = chip_smoke.level_span_edge_calls(cuda)
    kernels.reset_launches()
    n = 0
    for a, kw in calls:
        want = ref.intra_levels(*a)
        T, wtxn_c, rtxn = a[:3]
        n_levels = want["src"].shape[0]
        in_order = all(bool((o[1:] >= o[:-1]).all()) for o in (wtxn_c, rtxn))
        for s in (kw.get("span_log2"), 0, 1, n_levels):
            kernels.level_paths(reset=True)
            got = kernels.intra_levels(*a, span_log2=s)
            n += 1
            torch.cuda.synchronize()
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert torch.equal(got[k], want[k]), (k, a[0], s)
            paths = kernels.level_paths()
            plan = kernels.level_plan(T, wtxn_c.numel(), rtxn.numel(), s)
            assert paths["span"] + paths["general"] == 1
            if not in_order or plan["span_log2"] == 0:
                assert paths["general"] == 1, (T, s)
            assert paths["barriers"] == plan[
                "grid_barriers" if paths["span"] else "general_barriers"]
    assert kernels.LAUNCHES["intra_levels"] == n


@pytest.mark.cuda
def test_level_kernel_refuses_a_span_past_the_levels(cuda):
    import chip_smoke
    (a, _kw) = chip_smoke.level_span_edge_calls(cuda)[0]
    kernels.reset_launches()
    with pytest.raises(FDBError):
        kernels.intra_levels(*a, span_log2=40)
    assert kernels.LAUNCHES["intra_levels"] == 0


@pytest.mark.cuda
def test_endpoint_sort_kernel_at_its_run_edges(cuda):
    # K6 at L = 2, 5, 7, 17 with M about its run length and past three
    # runs, ties of every kind and all-equal keys, and at its sample
    # path's bucket edges (a bucket at its cap and one below, L = 5, 17
    # and 32; sorted, reverse-sorted and all-equal keys at the main path's
    # M); twice, since its barrier word must be left as it was found
    import chip_smoke
    calls = chip_smoke.endpoint_sort_edge_calls(cuda) + \
        chip_smoke.endpoint_sort_bucket_calls(cuda)
    kernels.reset_launches()
    _equal_to_plain(chip_smoke.forced_sort, chip_smoke.plain_sort,
                    calls + calls)
    assert kernels.LAUNCHES["endpoint_sort"] == 2 * len(calls)
    paths = {kernels.sort_plan(2 * a[0].shape[1] + 2 * a[2].shape[1],
                               a[0].shape[0], samples=kw.get("samples"))[
                                   "path"] for a, kw in calls}
    assert paths == {"tile", "sample", "rounds"}


@pytest.mark.cuda
def test_endpoint_sort_sample_path_equals_the_rounds_path(cuda):
    # the main path's shapes by every design: the plan's path, the tile
    # sort with the merge rounds (samples=0), the sample sort (the samples
    # sort_samples takes, and fewer a tile: a larger cap) and the sample
    # path's kernel turned to the merge rounds (tie_limit=-1)
    import chip_smoke
    calls = [c for c in chip_smoke.endpoint_sort_bucket_calls(cuda)
             if c[0][0].shape[1] >= 4096]
    for a, _kw in calls:
        want = ref.endpoint_sort(*a)
        M, L = 2 * a[0].shape[1] + 2 * a[2].shape[1], a[0].shape[0]
        for samples, tie_limit in (
                (None, None), (0, None),
                (kernels.sort_samples(M, L), 2 ** 31 - 1),
                (kernels.SORT_MIN_SAMPLES, 2 ** 31 - 1),
                (kernels.sort_samples(M, L), -1)):
            if samples and kernels.sort_plan(M, L, samples=samples)[
                    "smem_bytes"] > kernels.SORT_SMEM_MAX:
                continue
            got = chip_smoke.forced_sort(*a, samples=samples,
                                         tie_limit=tie_limit)
            torch.cuda.synchronize()
            for w, g in zip(want, got):
                assert torch.equal(g, w), (M, L, samples, tie_limit)


@pytest.mark.cuda
def test_step_verdicts_at_edge_widths(cuda):
    # K13, one cluster, at T = 1 .. 2^20 (T mod 16 and the cluster's loop),
    # from 16-byte aligned pointers and from pointers one byte past, with
    # and without the scan's rows
    import chip_smoke
    calls = chip_smoke.verdict_edge_calls(cuda)
    kernels.reset_launches()
    for a, _kw in calls:
        for scan in (False, True):
            wrap = chip_smoke.with_scan_rows if scan else (lambda v: v)
            got = wrap(kernels.step_verdicts)(*a)
            want = wrap(ref.step_verdicts)(*a)
            torch.cuda.synchronize()
            for w, g in zip(want, got):
                assert torch.equal(g, w), (a[0].shape[0], scan)
    assert kernels.LAUNCHES["step_verdicts"] == 2 * len(calls)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [17, 16384, 1 << 20])
def test_step_verdicts_replayed_in_a_graph(cuda, T):
    # captured once, replayed three times on new inputs: no state is left
    # from one replay to the next (no scratch, no ticket)
    flags = [torch.zeros(T, dtype=torch.bool, device=cuda)
             for _ in range(4)]
    scalars = [torch.zeros((), dtype=torch.bool, device=cuda)
               for _ in range(2)]
    rows = (torch.zeros((3, T), dtype=torch.int8, device=cuda),
            torch.zeros(3, dtype=torch.int32, device=cuda),
            torch.zeros(3, dtype=torch.bool, device=cuda))
    kernels.step_verdicts(*flags, *scalars, scan_out=rows, index=1)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernels.step_verdicts(*flags, *scalars, scan_out=rows, index=1)
    gen = torch.Generator().manual_seed(T)
    for rep in range(3):
        for f, p in zip(flags, (0.7, 0.2, 0.9, 0.4)):
            f.copy_(torch.rand(T, generator=gen) < p)
        scalars[0].fill_(rep == 1)
        scalars[1].fill_(rep != 2)
        graph.replay()
        torch.cuda.synchronize()
        plain_rows = tuple(t.clone() for t in rows)
        want = ref.step_verdicts(*flags, *scalars, scan_out=plain_rows,
                                 index=1)
        for w, g in zip(want + plain_rows, out + rows):
            assert torch.equal(g, w), rep


@pytest.mark.cuda
@pytest.mark.parametrize("delta", [1 << 29, 1 << 30])
def test_rebase_kernel_at_2_20_slots(cuda, delta):
    # the shift saturates at NEG; the table is of the shifted values
    K = 1 << 20
    g_ = torch.Generator().manual_seed(delta % 97)
    bval = torch.randint(ref.NEG, 1 << 30, (K,), generator=g_,
                         dtype=torch.int32)
    bval[::7] = ref.NEG
    bval = bval.to(cuda)
    for oldest in (ref.NEG, 0, (1 << 30) - 1):
        old = torch.tensor(oldest, dtype=torch.int32, device=cuda)
        kernels.reset_launches()
        got = kernels.rebase_table(bval, old, delta)
        want = ref.rebase_table(bval, old, delta)
        torch.cuda.synchronize()
        for w, g in zip(want, got):
            assert g.dtype == w.dtype and torch.equal(g, w)
        assert kernels.LAUNCHES["rebase_table"] == 1
        assert kernels.LAUNCHES["sparse_table"] == 0
    assert int((got[0] == ref.NEG).sum()) > K // 7


@pytest.mark.cuda
def test_sort_and_rank_kernels_equal_the_plain_phase(cuda):
    # K6-K8 against the plain phase on chip_smoke.py's edge calls (L=3,
    # T=1 and 1,000, a poisoned state, an all-padding batch, endpoints all
    # equal to state keys, long keys that collapse) and on a bench step
    # at T=16,384; each part against its plain part, K7 also on
    # state_merge_edge_calls (tile edges, tiles of state or endpoints
    # alone, all-equal keys, L = 2, 5, 7, M = 0 and 1,024, K=2^20 and the
    # 32k shape) and K8 on endpoint_ranks_edge_calls (more tiles than the
    # card holds CTAs at once); each call twice, since K8's barrier word
    # must be left as it found it
    import chip_smoke
    calls = chip_smoke.sort_rank_edge_calls(cuda)
    calls += _bench_step_calls(16384, "scan", cuda)["sort_and_rank"]
    kernels.reset_launches()
    _equal_to_plain(kernels.sort_and_rank, ref.sort_and_rank, calls + calls)
    for part in SORT_KERNELS:
        assert kernels.LAUNCHES[part] == 2 * len(calls)
    merges = chip_smoke.state_merge_edge_calls(cuda)
    ranks = chip_smoke.endpoint_ranks_edge_calls(cuda)
    for a, _kw in calls:
        ends = a[2:]
        _equal_to_plain(kernels.endpoint_sort, ref.endpoint_sort,
                        [(ends, {})])
        ekeys, eidx = ref.endpoint_sort(*ends)
        ranks.append(((ekeys, eidx), {}))
        merges.append(((*a[:2], ekeys, eidx, ends[0].shape[1]), {}))
    _equal_to_plain(kernels.endpoint_ranks, ref.endpoint_ranks, ranks + ranks)
    _equal_to_plain(kernels.state_merge, ref.state_merge, merges)


def _merge_calls(device, capacity, txns, batches):
    """The merge phase's inputs of each step of `batches` (lists of
    TxnConflictInfo) through the plain step on `device`."""
    calls = []

    def spy(*a, **kw):
        calls.append(_to((a, kw), device))
        return ref.merge_compact(*a, **kw)
    phases = type(ref.PLAIN)(**dict(vars(ref.PLAIN), merge_compact=spy))
    cs = DeviceConflictSet(device=device, capacity=capacity, txns=txns,
                           reads_per_txn=4, writes_per_txn=4)
    version = 0
    for txns_ in batches:
        version += 1000
        batch = cs.encoder.encode_batch(txns_, version)
        cs._state, _s, _i = ref.conflict_step(
            cs._state, batch, max_write_life=5_000_000, phases=phases)
    return calls


def _merge_equal(calls):
    for a, kw in calls:
        want = ref.merge_compact(*a, **kw)
        got = kernels.merge_compact(*a, **kw)
        torch.cuda.synchronize()
        for w, g in zip(want, got):
            assert torch.equal(g, w)
        # delta is left zeroed: the same call again gives the same answer
        again = kernels.merge_compact(*a, **kw)
        for w, g in zip(want, again):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_merge_kernel_key_group_spans_tiles(cuda):
    # 1,024 txns writing one key: its begin and end groups hold 4,096
    # sorted elements each, across two 2,048-element tiles
    hot = [TxnConflictInfo(0, [], [point(b"hot")] * 4) for _ in range(1024)]
    mixed = [TxnConflictInfo(0, [point(b"hot")], [point(b"k%d" % i)])
             for i in range(1024)]
    calls = _merge_calls(cuda, 1 << 13, 1024, [hot, mixed, hot])
    N = calls[0][0][0].shape[1]
    assert N > 2 * kernels.MERGE_TILE
    _merge_equal(calls)


@pytest.mark.cuda
def test_merge_kernel_overflow_poisons(cuda):
    rng = np.random.default_rng(11)
    batches = [[TxnConflictInfo(0, [], [point(b"%08d" % k) for k in
                                        rng.integers(0, 10 ** 8, 4)])
                for _ in range(64)] for _ in range(6)]
    calls = _merge_calls(cuda, 1536, 64, batches)
    # N = K + 2 NR + 2 NW = 2,560 is not a multiple of the tile
    assert calls[0][0][0].shape[1] % kernels.MERGE_TILE != 0
    _merge_equal(calls)
    last = kernels.merge_compact(*calls[-1][0], **calls[-1][1])
    assert bool(last[4]) and int(last[5]) == 1


def _legacy_equal(a):
    """K5's fixpoint against the plain loop (`run_legacy` over
    `legacy_sweep`), commit, converged and the count of evaluations, and
    its one-evaluation launch on every evaluation's input; returns the
    count."""
    dev = a[0].device
    n = torch.zeros((), dtype=torch.int32, device=dev)
    commit, converged = kernels.legacy_fixpoint(*a, evals=n)
    seen = []

    def sweep(c):
        seen.append(c)
        return ref.legacy_sweep(c, *a)
    want = ref.run_legacy(sweep, a[0])
    torch.cuda.synchronize()
    assert torch.equal(commit, want) and bool(converged)
    assert int(n) == len(seen)
    for c in seen:
        assert torch.equal(kernels.legacy_sweep(c, *a), ref.legacy_sweep(c, *a))
    return int(n)


@pytest.mark.cuda
def test_legacy_kernel_equals_its_plain_version(cuda):
    calls = _bench_step_calls(2048, "legacy", cuda)["legacy_blocked"]
    assert len(calls) == 1
    kernels.reset_launches()
    for a, kw in calls:
        assert _legacy_equal(a) >= 3
        want = ref.legacy_fixpoint(*a, **kw)
        got = kernels.legacy_fixpoint(*a, **kw)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert kernels.LAUNCHES["legacy_blocked"] > 0


@pytest.mark.cuda
def test_legacy_fixpoint_kernel_on_chains_shuffles_and_the_bench(cuda):
    # chains of 64, 1,000 and 4,097 txns (an evaluation a txn), reads and
    # writes shuffled, T=1, no reads or writes, random pooled owners
    # (chip_smoke.py's edges), and the bench's T=16,384 strided steps
    import chip_smoke
    bench_calls = chip_smoke.legacy_ab_calls(cuda, 16384, 2)
    edges = chip_smoke.legacy_edge_calls(cuda, bench_calls[-1])
    counts = [_legacy_equal(a) for a, _kw in bench_calls + edges]
    assert max(counts) >= 4097 and min(counts) >= 3
    chain = chip_smoke.legacy_chain_args(cuda, 64)
    commit, _converged = kernels.legacy_fixpoint(*chain)
    assert commit.cpu().tolist() == [t % 2 == 0 for t in range(64)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,max_bodies", [(64, 1), (4097, 100)])
def test_legacy_fixpoint_kernel_stops_at_its_guard(cuda, T, max_bodies):
    """A chain stopped by a small guard: K5's last lower bound, converged
    False and its count of evaluations equal the guarded plain
    version's."""
    import chip_smoke
    a = chip_smoke.legacy_chain_args(cuda, T)
    n = torch.zeros((), dtype=torch.int32, device=cuda)
    commit, converged = kernels.legacy_fixpoint(*a, evals=n,
                                                max_bodies=max_bodies)
    m = torch.zeros((), dtype=torch.int32)
    want, want_conv = ref.legacy_fixpoint(*(x.cpu() for x in a), evals=m,
                                          max_bodies=max_bodies)
    assert torch.equal(commit.cpu(), want)
    assert not bool(converged) and not bool(want_conv)
    assert int(n) == int(m) == 1 + 2 * max_bodies


@pytest.mark.cuda
def test_legacy_engine_raises_at_the_guard_through_its_graphs(cuda,
                                                               monkeypatch):
    """The bucket graph captured with a guard of one body: a chain's chunk
    comes back unconverged and the engine raises internal_error (no host
    pass)."""
    KNOBS.set("CONFLICT_INTRA_MODE", "legacy")

    def guarded(*a, **kw):
        return kernels.legacy_fixpoint(*a, **kw, max_bodies=1)
    monkeypatch.setattr(kernels.PHASES, "legacy_fixpoint", guarded)
    cs = DeviceConflictSet(device=cuda, **SMALL)
    cs.warmup()
    assert all(g.graph is not None for g in cs._graphs.values())
    txns = [TxnConflictInfo(9, [point(b"c%04d" % t)],
                            [point(b"c%04d" % (t + 1))]) for t in range(40)]
    with pytest.raises(FDBError) as ei:
        cs.detect(txns, 10)
    assert ei.value.name == "internal_error"


@pytest.mark.cuda
def test_legacy_engine_runs_through_its_bucket_graphs(cuda):
    KNOBS.set("CONFLICT_INTRA_MODE", "legacy")
    rng = np.random.default_rng(21)
    cs = DeviceConflictSet(device=cuda, **SMALL)
    cs.warmup()
    assert all(g.graph is not None for g in cs._graphs.values())
    oracle = OracleConflictSet()
    kernels.reset_launches()
    version = 0
    for i in range(12):
        version += int(rng.integers(1, 300)) * 10
        txns = fuzz_batch(rng, version - 1, int(rng.integers(1, 150)))
        assert cs.detect(txns, version) == oracle.detect(txns, version), i
    assert kernels.LAUNCHES["legacy_blocked"] == kernels.LAUNCHES[
        "history_check"] >= 12
    assert kernels.LAUNCHES["intra_sandwich"] == 0


@pytest.mark.cuda
def test_probe_kernels_equal_their_plain_versions(cuda):
    from foundationdb_tpu_torch.ops import probes
    rng = np.random.default_rng(10)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    u = rng.integers(0, 1 << 32, (4096, 8), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    small = rng.integers(-3, 3, (8, 4096)).astype(np.int32)
    calls = {
        "probe_add": ((t(u),), {}),
        "probe_stream_rows": ((t(u),), {"layout": "rows", "unsigned": True}),
        "probe_stream_limbs": ((t(small),), {"layout": "limbs"}),
        "probe_join": ((t(u), t(u[:2048].reshape(8, 256, 8))),
                       {"unsigned": True}),
        "probe_lexjoin": ((t(small), t(rng.integers(-3, 3, (4, 8, 300))
                                       .astype(np.int32))), {"limbs": 5}),
        "probe_dynwrite": ((t(np.array([60], np.int32)),
                            t(u[:8, :4].copy())), {"rows": 64}),
    }
    kernels.reset_launches()
    for name, (a, kw) in calls.items():
        got = probes.WRAPPERS[name](*a, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, probes.PLAIN[name](*a, **kw)), name
        assert kernels.LAUNCHES[name] == 1, name


@pytest.mark.cuda
def test_history_kernel_ignores_inverted_reads(cuda):
    # inverted and empty reads over newer writes (what clipping makes of a
    # range outside a shard) are no hits; a proper read of them is
    import chip_smoke
    calls = chip_smoke.inverted_read_calls(cuda)
    _equal_to_plain(kernels.history_check, ref.history_check, calls)
    _too_old, g0 = kernels.history_check(*calls[-1][0])
    assert g0.cpu().tolist() == [t % 4 != 0 for t in range(64)]


@pytest.mark.cuda
def test_shard_clip_kernel_on_edge_inputs(cuda):
    # W = 1, 2, 4, 8; T=1; all padding; ends at the cuts and the sentinel;
    # the strided layout at T=16,384 (chip_smoke.py's edges)
    import chip_smoke
    calls = chip_smoke.clip_edge_calls(cuda)
    kernels.reset_launches()
    _equal_to_plain(kernels.clip_ranges, ref.clip_ranges, calls)
    assert kernels.LAUNCHES["shard_clip"] == len(calls)


@pytest.mark.cuda
def test_shard_combine_kernel_on_edge_inputs(cuda):
    # twice over: each launch leaves its counters zero for the next
    import chip_smoke
    calls = chip_smoke.combine_edge_calls(cuda)
    for a, kw in calls + calls:
        want_st, want, want_row = ref.shard_combine(*a, **kw)
        got_st, got, got_row = kernels.shard_combine(*a, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got_st, want_st)
        assert torch.equal(got_row, want_row)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_sharded_engine_on_the_card_equals_the_plain_phases(cuda):
    from foundationdb_tpu_torch.parallel.sharded_conflict import (
        ShardedDeviceConflictSet)
    rng = np.random.default_rng(13)
    W = 4
    eng = ShardedDeviceConflictSet(devices=[cuda] * W, **SMALL)
    plain = ShardedDeviceConflictSet(devices=[cuda] * W, phases=ref.PLAIN,
                                     **SMALL)
    assert eng.graphed and not plain.graphed
    eng.warmup()
    plain.warmup()
    kernels.reset_launches()
    version = 0
    for _ in range(12):
        version += int(rng.integers(1, 300)) * 10
        txns = fuzz_batch(rng, version, 64)
        assert eng.detect(txns, version) == plain.detect(txns, version)
    assert kernels.LAUNCHES["shard_clip"] == kernels.LAUNCHES[
        "shard_combine"] == 12
    assert kernels.LAUNCHES["history_check"] == W * 12
    got = ref.sharded_state_to_numpy(eng._state)
    for k, v in ref.sharded_state_to_numpy(plain._state).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _buffer_ptrs(state):
    return ([{k: v.data_ptr() for k, v in sh.items()}
             for sh in state["shards"]],
            state["lo"].data_ptr(), state["hi"].data_ptr())


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 4])
def test_sharded_graph_replays_equal_its_eager_chunk(cuda, W):
    """The engine's chunk graph against the same engine with the chunk
    eager, through a version jump (every shard rebases) and a re-cut:
    every batch, the state, the buffers unmoved, one K10 and one K11 a
    chunk."""
    from foundationdb_tpu_torch.parallel.sharded_conflict import (
        ShardedDeviceConflictSet)
    rng = np.random.default_rng(17 + W)
    graph = ShardedDeviceConflictSet(devices=[cuda] * W, **SMALL)
    eager = ShardedDeviceConflictSet(devices=[cuda] * W, **SMALL)
    assert graph.graphed and eager.graphed
    eager._program.graphed = False  # the same chunk, run eagerly
    graph.warmup()
    eager.warmup()
    ptrs = _buffer_ptrs(graph._state)
    kernels.reset_launches()
    recut = [b""] + [bytes([0x61 + i]) for i in range(W - 1)]
    version, chunks = 0, 0
    for i in range(14):
        version += int(rng.integers(1, 300)) * 10
        if i == 6:
            version += (1 << 29) + 3
        if i == 10:
            for eng in (graph, eager):
                eng.rebalance_cuts(recut, version)
        txns = fuzz_batch(rng, version - 1, 64)
        assert graph.detect(txns, version) == eager.detect(txns, version), i
        chunks += 1
    assert graph.base_version == eager.base_version > 0
    got = ref.sharded_state_to_numpy(graph._state)
    for k, v in ref.sharded_state_to_numpy(eager._state).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert _buffer_ptrs(graph._state) == ptrs
    assert graph._program.graph is not None and eager._program.graph is None
    assert kernels.LAUNCHES["shard_combine"] == 2 * chunks


# ---------------------------------------------------------------------------
# the step graphs and the glue kernels (K12, K13) on the card
# ---------------------------------------------------------------------------

def _bench_state_and_chunks(dev, T=256, K=4096, M=3):
    from foundationdb_tpu_torch import bench
    warm = bench.stage(bench._encode_batches(M, seed=1, version0=bench.WINDOW,
                                             T=T), dev)
    main = bench.stage(bench._encode_batches(
        2 * M, seed=2, version0=bench.WINDOW + M * bench.VERSION_STEP, T=T),
        dev)
    chunks = [{k: v[i:i + M] for k, v in main.items()} for i in (0, M)]
    return (ref.init_state(K, bench.LIMBS, dev, phases=kernels.PHASES), warm,
            chunks)


@pytest.mark.cuda
def test_scan_graph_equals_the_eager_kernels_and_plain_on_the_card(cuda):
    from foundationdb_tpu_torch import bench
    outs = {}
    for name, kw in (("graph", dict(graphed=True)),
                     ("eager", dict(graphed=False)),
                     ("plain", dict(graphed=False, phases=ref.PLAIN))):
        state, warm, chunks = _bench_state_and_chunks(cuda)
        ptrs = {k: v.data_ptr() for k, v in state.items()}
        outs[name] = bench.timed_scan(state, warm, chunks, **kw)
        assert {k: v.data_ptr() for k, v in state.items()} == ptrs
    for name in ("eager", "plain"):
        for a, b in zip(outs["graph"]["statuses"], outs[name]["statuses"]):
            assert torch.equal(a, b), name
        np.testing.assert_array_equal(outs["graph"]["committed"],
                                      outs[name]["committed"])
        for k, v in outs["graph"]["state"].items():
            assert torch.equal(v, outs[name]["state"][k]), (name, k)


@pytest.mark.cuda
def test_engine_bucket_graphs_match_the_oracle_on_the_card(cuda):
    rng = np.random.default_rng(3)
    cs = DeviceConflictSet(device=cuda, **SMALL)
    cs.warmup()
    assert len(cs._graphs) == 4
    assert all(g.graph is not None for g in cs._graphs.values())
    ptrs = {k: v.data_ptr() for k, v in cs._state.items()}
    oracle = OracleConflictSet()
    kernels.reset_launches()
    version = 0
    for i in range(12):
        version += int(rng.integers(1, 300)) * 10
        # read snapshots strictly below the commit version, as the protocol
        # gives them (ROADMAP C: a chunked batch's txn reading AT its commit
        # version misses an earlier chunk's write, in the JAX engine too)
        txns = fuzz_batch(rng, version - 1, int(rng.integers(1, 150)))
        assert cs.detect(txns, version) == oracle.detect(txns, version), i
    assert {k: v.data_ptr() for k, v in cs._state.items()} == ptrs
    assert kernels.LAUNCHES["step_verdicts"] >= 12
    for name in ("intra_sandwich", "intra_levels", "step_masks",
                 "step_verdicts"):
        assert kernels.LAUNCHES[name] == kernels.LAUNCHES["history_check"]


@pytest.mark.cuda
def test_glue_kernels_equal_plain_on_the_card(cuda):
    rng = np.random.default_rng(2)
    for strided in (False, True):
        per = 2 if strided else 4
        cs = DeviceConflictSet(device=cuda, capacity=1024, txns=64,
                               reads_per_txn=per, writes_per_txn=per,
                               strided=strided)
        txns = [TxnConflictInfo(0, [point(b"a%d" % i)] * int(i % 3),
                                [point(b"b%d" % i)] * int(i % 2))
                for i in range(60)]
        batch = cs.encoder.encode_batch(txns, 100)
        NR, NW = batch["rb"].shape[1], batch["wb"].shape[1]
        ranks = [torch.from_numpy(rng.integers(0, 6, n).astype(np.int32)).to(
            cuda) for n in (NR, NR, NW, NW)]
        args = (batch["rb"], batch["wb"], batch["rtxn"], batch["wtxn"],
                *ranks, 64, strided)
        got = kernels.step_masks(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, ref.step_masks(*args)):
            assert torch.equal(a, b), strided
    T = 1000
    flags = [torch.from_numpy(np.random.default_rng(s).random(T) < 0.6).to(
        cuda) for s in range(4)]
    one = torch.tensor(True, device=cuda)
    scan_k = (torch.zeros((2, T), dtype=torch.int8, device=cuda),
              torch.zeros(2, dtype=torch.int32, device=cuda),
              torch.zeros(2, dtype=torch.bool, device=cuda))
    scan_p = tuple(t.clone() for t in scan_k)
    got = kernels.step_verdicts(*flags, one, one, scan_out=scan_k, index=1)
    want = ref.step_verdicts(*flags, one, one, scan_out=scan_p, index=1)
    torch.cuda.synchronize()
    for a, b in zip(got + scan_k, want + scan_p):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_failed_capture_raises_and_leaves_the_engine_usable(cuda):
    """A step that reads the card on the host cannot be captured: the
    program raises FDBError (no eager fallback), and the kernels work on."""
    from foundationdb_tpu_torch.ops.step_graph import ScanGraph

    def syncing_masks(*a, **kw):
        bool(a[0].any())  # a host read: refused while the stream captures
        return kernels.step_masks(*a, **kw)
    phases = type(ref.PLAIN)(**dict(vars(kernels.PHASES),
                                    step_masks=syncing_masks))
    state, _warm, chunks = _bench_state_and_chunks(cuda)
    prog = ScanGraph(state, steps=3, txns=256, reads=256, writes=256,
                     max_write_life=5_000_000, strided=True, phases=phases)
    with pytest.raises(FDBError) as ei:
        prog.run(chunks[0])
    assert ei.value.name == "internal_error" and prog.graph is None
    test_scan_graph_equals_the_eager_kernels_and_plain_on_the_card(cuda)
