"""The scan evaluator's level geometry and the rebase: the port's plain
phases (the functions K9 and the rebase kernel replace) against the JAX
`_intra_scan_levels` and `rebase_state`.

`lax.sort` leaves the order of elements with equal (block, rank, class)
unspecified; the port's `intra_levels` fixes it to the element index (a
stable sort), which is what K9 reproduces field for field. So each JAX
level is first put into that order: its permutation is read back from its
outputs (`src` where `is_w`, NW + j at `qlo[j]`, NW + NR + j at `qhi[j]`),
each run of equal (block, rank, class) is sorted by element index, and the
six fields are rebuilt from it. After that the port's fields must be EQUAL
(integers: the tolerance is zero). Inputs are numpy arrays from a seed:
pooled (sorted owners), strided and shuffled owners, with padding, at
spread ranks and at a handful of ranks (ties everywhere).

The rebase's plain phase (`rebase_table`, through `rebase_state`) equals
the JAX `rebase_state` exactly, values that saturate at NEG included. On
the CPU both kernel wrappers run their plain versions and count no launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import conflict as jconf
from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops import kernels

FIELDS = ("src", "is_w", "werl", "bnd", "qlo", "qhi")


def make_inputs(rng, T, layout, ties):
    """(wtxn_c, rtxn, rbr, rer, wbr, wer) as int32 numpy arrays: 3 reads
    and 3 writes a txn (a tenth padding), owners pooled (sorted), strided
    (slot j of txn j // 3) or shuffled; ranks from 3 values (ties) or
    spread over the endpoints' range."""
    n = 3 * T
    if layout == "strided":
        wtxn = np.arange(n) // 3
        rtxn = np.arange(n) // 3
    else:
        wtxn = np.sort(rng.integers(0, T, n))
        rtxn = np.sort(rng.integers(0, T, n))
    wtxn = np.where(rng.random(n) < 0.1, T, wtxn)
    rtxn = np.where(rng.random(n) < 0.1, T, rtxn)
    if layout == "shuffled":
        wtxn, rtxn = rng.permutation(wtxn), rng.permutation(rtxn)
    wtxn_c = np.minimum(wtxn, T - 1)
    hi = 3 if ties else 4 * n
    rbr, rer, wbr, wer = (rng.integers(0, hi, n) for _ in range(4))
    return tuple(a.astype(np.int32) for a in (wtxn_c, rtxn, rbr, rer, wbr,
                                              wer))


def element_keys(T, l, wtxn_c, rtxn, rbr, rer, wbr):
    """(block, rank, class) of every element of level l, by element index."""
    rb = (rtxn.astype(np.int64) >> l) - 1
    block = np.concatenate([wtxn_c.astype(np.int64) >> l, rb, rb])
    rank = np.concatenate([wbr, rbr, rer]).astype(np.int64)
    cls = np.concatenate([np.zeros(wbr.size), np.ones(rbr.size),
                          -np.ones(rbr.size)]).astype(np.int64)
    return block, rank, cls


def permutation_of(level, NW, NR):
    """The element index at each position of a level's outputs."""
    src, is_w, _werl, _bnd, qlo, qhi = (np.asarray(level[k]) for k in FIELDS)
    si = np.full(src.size, -1, np.int64)
    si[is_w] = src[is_w]
    si[qlo] = NW + np.arange(NR)
    si[qhi] = NW + NR + np.arange(NR)
    assert (si >= 0).all()
    return si


def fields_of(si, keys, wer, NW, NR):
    """The six fields of a level in the order `si`."""
    block = keys[0]
    M = si.size
    inv = np.empty(M, np.int64)
    inv[si] = np.arange(M)
    is_w = si < NW
    src = np.minimum(si, NW - 1)
    b = block[si]
    return {"src": src, "is_w": is_w,
            "werl": np.where(is_w, wer[src], -1),
            "bnd": np.concatenate([[True], b[1:] != b[:-1]]),
            "qlo": inv[NW:NW + NR], "qhi": inv[NW + NR:]}


def canonical(si, keys):
    """`si` with each run of equal (block, rank, class) sorted by element
    index; the runs themselves must already be in key order."""
    k = np.stack([key[si] for key in keys], axis=1)
    assert all(tuple(a) <= tuple(b) for a, b in zip(k[:-1], k[1:]))
    out = si.copy()
    start = 0
    for p in range(1, si.size + 1):
        if p == si.size or (k[p] != k[start]).any():
            out[start:p] = np.sort(si[start:p])
            start = p
    return out


def jax_levels(T, args):
    return jconf._intra_scan_levels(T, *(jnp.asarray(a) for a in args))


def port_levels(T, args, fn=ref.intra_levels):
    return fn(T, *(torch.from_numpy(a) for a in args))


def assert_port_equals_jax(T, args):
    """The port's plain levels equal JAX's, put in the total order."""
    wtxn_c, rtxn, rbr, rer, wbr, wer = args
    NW, NR = wbr.size, rbr.size
    jax_out = jax_levels(T, args)
    port = port_levels(T, args)
    n_levels = max(1, (T - 1).bit_length())
    assert len(jax_out) == n_levels
    for k in FIELDS:
        assert port[k].shape[0] == n_levels
    for l, level in enumerate(jax_out):
        level = dict(zip(FIELDS, level))
        keys = element_keys(T, l, wtxn_c, rtxn, rbr, rer, wbr)
        si = permutation_of(level, NW, NR)
        # the JAX block boundaries do not depend on the tie order
        np.testing.assert_array_equal(
            fields_of(si, keys, wer, NW, NR)["bnd"], np.asarray(level["bnd"]))
        want = fields_of(canonical(si, keys), keys, wer, NW, NR)
        for k in FIELDS:
            np.testing.assert_array_equal(
                port[k][l].numpy().astype(np.int64),
                want[k].astype(np.int64), err_msg=f"level {l} {k}")


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("layout", ["pooled", "strided", "shuffled"])
@pytest.mark.parametrize("T", [1, 2, 5, 32, 100])
def test_plain_levels_equal_jax_in_the_total_order(T, layout, ties):
    rng = np.random.default_rng(1000 * T + 10 * len(layout) + ties)
    assert_port_equals_jax(T, make_inputs(rng, T, layout, ties))


# K9's span path: a span of 2^s txns (kernels.level_plan) owns the level
# blocks below s whose writes it holds, and reads the queries of half a
# span past it. 64 elements a txn (16 writes, 16 reads) give s = 4.
SPAN_PER_TXN = 16


def span_inputs(rng, T, case, ties):
    """(wtxn_c, rtxn, rbr, rer, wbr, wer) at the span path's edges:
    nondecreasing owners (pooled) unless `case` says otherwise."""
    n = SPAN_PER_TXN * T
    wtxn = np.sort(rng.integers(0, T, n))
    rtxn = np.sort(rng.integers(0, T, n))
    span = 1 << kernels.level_plan(T, n, n)["span_log2"]
    if case == "straddle":  # txns on both sides of each span edge load up
        edges = np.arange(span, T, span)
        heavy = np.concatenate([edges - 1, edges])
        wtxn = np.sort(np.concatenate([wtxn[:n // 2],
                                       rng.choice(heavy, n - n // 2)]))
        rtxn = np.sort(np.concatenate([rtxn[:n // 2],
                                       rng.choice(heavy, n - n // 2)]))
    elif case == "big_txn":  # one txn past a span's shared memory
        big = kernels.LEVEL_SPAN_CAP // 2 + 7
        wtxn = np.sort(np.concatenate([wtxn, np.full(big, T // 2)]))
        rtxn = np.sort(np.concatenate([rtxn, np.full(big, T // 2)]))
    elif case == "padding_tail":  # pooled padding: reads T, writes T - 1
        rtxn[-n // 5:] = T
        wtxn[-n // 7:] = T - 1
    elif case == "shuffled":
        wtxn, rtxn = rng.permutation(wtxn), rng.permutation(rtxn)
    elif case == "all_padding":
        wtxn, rtxn = np.full(n, T - 1), np.full(n, T)
    nw, nr = wtxn.size, rtxn.size
    hi = 3 if ties else 4 * (nw + nr)
    rbr, rer = (rng.integers(0, hi, nr) for _ in range(2))
    wbr, wer = (rng.integers(0, hi, nw) for _ in range(2))
    return tuple(a.astype(np.int32) for a in (wtxn, rtxn, rbr, rer, wbr,
                                              wer))


SPAN_CASES = {  # case -> (T, kind)
    "T_one_below_the_span": (15, "pooled"),
    "T_at_the_span": (16, "pooled"),
    "T_one_above_the_span": (17, "pooled"),
    "txns_straddling_span_edges": (64, "straddle"),
    "pooled_txn_past_a_span": (8, "big_txn"),
    "nondecreasing_with_padding": (48, "padding_tail"),
    "shuffled_owners": (48, "shuffled"),
    "all_padding": (33, "all_padding"),
    "T_1": (1, "pooled"),
}


def test_span_cases_hit_the_span_edges():
    n = SPAN_PER_TXN * 16
    assert kernels.level_plan(16, n, n)["span_log2"] == 4
    assert kernels.level_plan(64, 4 * n, 4 * n)["span_log2"] == 4
    assert kernels.level_plan(64, 4 * n, 4 * n)["grid_levels"] == 2


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", list(SPAN_CASES))
def test_plain_levels_equal_jax_at_the_span_edges(case, ties):
    T, kind = SPAN_CASES[case]
    rng = np.random.default_rng(len(case) * 7 + ties)
    assert_port_equals_jax(T, span_inputs(rng, T, kind, ties))


MAIN_SHAPES = {  # (T, NW, NR): cells A and B, the bench at 16k and 32k,
    "A": (1024, 4096, 4096),   # and K9's T = 2^20 call
    "bench_16k": (16384, 16384, 16384),
    "bench_32k": (32768, 32768, 32768),
    "T_2_20": (1 << 20, 1 << 20, 1 << 20),
}


@pytest.mark.parametrize("shape", list(MAIN_SHAPES))
def test_level_plan_cuts_the_grid_barriers(shape):
    T, NW, NR = MAIN_SHAPES[shape]
    plan = kernels.level_plan(T, NW, NR)
    s = plan["span_log2"]
    assert 1 <= s <= plan["n_levels"] == max(1, (T - 1).bit_length())
    # a span at the shape's average load fills at most a quarter of its
    # room, and at most 2^10 txns
    assert (NW + 3 * NR) * (1 << s) <= kernels.LEVEL_SPAN_CAP // 4 * T
    assert s <= kernels.LEVEL_SPAN_LOG2_MAX
    assert plan["smem_bytes"] <= 232_448
    assert plan["grid_levels"] == plan["n_levels"] - s
    assert plan["grid_barriers"] <= plan["general_barriers"] - 10
    assert plan["spans"] == (T >> s) + 1


def _source_defines(path):
    """The integer #defines of a kernel source, macros expanded (sizeof of
    the two types the sources use given in bytes)."""
    import re
    text = path.read_text().replace("\\\n", " ")
    raw = dict(re.findall(r"^#define (\w+) +(.+?)(?: *//.*)?$", text, re.M))
    out = {}
    for name, expr in raw.items():
        expr = (expr.replace("sizeof(unsigned long long)", "8")
                .replace("sizeof(int)", "4").replace("/", "//"))
        for other in sorted(out, key=len, reverse=True):
            expr = re.sub(rf"\b{other}\b", str(out[other]), expr)
        try:
            out[name] = int(eval(expr, {}))
        except (NameError, SyntaxError):
            pass
    return out


def test_level_plan_constants_are_the_kernels():
    # level_plan's span room and shared memory are the figures the K9
    # source launches with, and that memory fits an H100 CTA's 227 KB
    d = _source_defines(kernels.CSRC_DIR / "intra_levels.cu")
    assert d["LV_SPAN_CAP"] == kernels.LEVEL_SPAN_CAP
    assert d["LV_SPAN_LOG2_MAX"] == kernels.LEVEL_SPAN_LOG2_MAX
    assert d["LV_SMEM"] == kernels.LEVEL_SMEM_BYTES <= 232_448


@pytest.mark.parametrize("layout", ["pooled", "shuffled"])
def test_plain_levels_order_ties_by_element_index(layout):
    rng = np.random.default_rng(77)
    T = 64
    args = make_inputs(rng, T, layout, ties=True)
    wtxn_c, rtxn, rbr, rer, wbr, _wer = args
    NW, NR = wbr.size, rbr.size
    port = port_levels(T, args)
    runs = 0
    for l in range(port["src"].shape[0]):
        level = {k: port[k][l].numpy() for k in FIELDS}
        si = permutation_of(level, NW, NR)
        keys = element_keys(T, l, wtxn_c, rtxn, rbr, rer, wbr)
        k = np.stack([key[si] for key in keys], axis=1)
        same = (k[1:] == k[:-1]).all(axis=1)
        assert (si[1:][same] > si[:-1][same]).all()
        runs += int(same.sum())
    assert runs > 0  # the ties are there


def test_level_wrapper_runs_the_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    kernels.reset_launches()
    for T, layout in ((1, "pooled"), (33, "shuffled"), (100, "strided")):
        args = make_inputs(rng, T, layout, ties=False)
        want = port_levels(T, args)
        got = port_levels(T, args, kernels.intra_levels)
        for k in FIELDS:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k]), k
    assert kernels.LAUNCHES["intra_levels"] == 0
    assert kernels.PHASES.intra_levels is kernels.intra_levels
    assert ref.PLAIN.intra_levels is ref.intra_levels


def np_state(rng, K, L=3):
    """A JAX-layout state whose versions span NEG up to 2^30 - 1: some at
    NEG, some just above it (they saturate at any delta above 5, the last
    one among them), the rest wide."""
    bval = rng.integers(int(ref.NEG), 1 << 30, K).astype(np.int32)
    bval[rng.random(K) < 0.2] = ref.NEG
    bval[rng.random(K) < 0.2] = ref.NEG + 5
    bval[-1] = ref.NEG + 5
    keys = np.full((L, K), 0xFFFFFFFF, np.uint32)
    keys[:, 0] = 0
    return {"bkeys": keys, "bval": bval, "nb": np.int32(1),
            "oldest": np.int32(rng.integers(-(1 << 29), 1 << 29)),
            "table": np.asarray(jconf._build_table(jnp.asarray(bval))),
            "poisoned": np.asarray(False)}


@pytest.mark.parametrize("delta", [0, 1, 1 << 29, 1 << 30])
@pytest.mark.parametrize("K", [1, 5, 1000, 2049])
def test_plain_rebase_equals_jax(K, delta):
    rng = np.random.default_rng(K + delta % 1000)
    state = np_state(rng, K)
    want = jconf.rebase_state({k: jnp.asarray(v) for k, v in state.items()},
                              jnp.int32(delta))
    got = ref.state_to_numpy(ref.rebase_state(
        ref.state_from_numpy(state, "cpu"), delta))
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    if delta >= 1 << 29:
        saturated = (got["bval"] == ref.NEG).sum()
        assert saturated > (state["bval"] == ref.NEG).sum()


def test_rebase_wrapper_runs_the_plain_version_on_cpu():
    rng = np.random.default_rng(6)
    kernels.reset_launches()
    for K, delta in ((1, 3), (300, 1 << 29), (4097, 1 << 30)):
        tstate = ref.state_from_numpy(np_state(rng, K), "cpu")
        want = ref.rebase_table(tstate["bval"], tstate["oldest"], delta)
        got = kernels.rebase_table(tstate["bval"], tstate["oldest"], delta)
        for w, g in zip(want, got):
            assert torch.equal(g, w)
        via = ref.rebase_state(tstate, delta, phases=kernels.PHASES)
        assert torch.equal(via["bval"], want[0])
        assert torch.equal(via["oldest"], want[1])
        assert torch.equal(via["table"], want[2])
    assert kernels.LAUNCHES["rebase_table"] == 0
    assert kernels.LAUNCHES["sparse_table"] == 0
    assert kernels.PHASES.rebase_table is kernels.rebase_table
    assert ref.PLAIN.rebase_table is ref.rebase_table
