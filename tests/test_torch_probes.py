"""The port's probe kernels (ops/probes.py) against the Pallas kernel bodies.

scripts/ab_pallas.py and scripts/ab_pallas2.py run their probes when they
are imported, so the six kernel functions are lifted out of their source
with `ast` and executed alone, with small TILE/QT/LK, through
`pl.pallas_call(..., interpret=True)` on the CPU with the scripts' grids
and BlockSpecs. Each probe's plain version, and its wrapper on the CPU
(which runs the plain version), must equal the Pallas output exactly.

Two departures from the scripts, both forced by the kernel bodies:
  * join_kernel indexes its query block as (QT, L) and stores a (QT,) row,
    but ab_pallas.py gives it a (1, QT, L) query block, which does not
    broadcast against the state tile, and a (1, QT) output block, which
    refuses the (QT,) store (jax raises at trace time for both); the test
    squeezes both blocks' leading axis (`None`), the shapes the body
    indexes.
  * dynwrite_kernel writes 8 of its 64 output rows and leaves the rest
    unwritten (interpret mode fills them with the dtype's minimum); the
    port defines them as zero, so only the written rows are compared.
    Where they go at offsets outside [0, 56] is the dynamic slice's rule
    (a negative offset counts from the end, the start is clamped so that
    the rows fit), held on `probes.dynwrite_edge_calls`.

The rank joins are held to the Pallas bodies also on their edges
(`probes.rank_edge_calls`: ties, queries equal to tile keys, prefixes
shared up to LK - 1 limbs, uint32 limbs past 2^31, LK = 1 to 8, tiles that
are not a power of two; ab_pallas2.py's lexjoin is signed, so its unsigned
edge is held to a packed-key searchsorted instead). The card's algorithm
for them (csrc/probes.cu: a tile's queries merge-sorted by ranks, a
round a merge of runs in pairs, each query placed at its index in its run
plus its rank in the other run; each row's upper bound among them by
bisection into a histogram; the histogram's prefix sums as the counts) is
emulated in numpy, round for round, and held to `rank_plain` on the same
edges and on the scripts' first tiles; its constants are read from the
source.
"""

import ast
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from foundationdb_tpu_torch.ops import kernels, probes
from foundationdb_tpu_torch.utils.errors import FDBError

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
# small shapes: K state rows in tiles of TILE, QT queries a tile, 2 passes
K, L, TILE, QT, LK, REP = 64, 8, 16, 8, 5, 2
NT = K // TILE


def lift(script: str, name: str, **consts):
    """The function `name` of scripts/<script>, compiled alone with jnp, pl
    and `consts` as its globals."""
    path = os.path.join(SCRIPTS, script)
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    fn = next(node for node in tree.body
              if isinstance(node, ast.FunctionDef) and node.name == name)
    ns = {"jnp": jnp, "pl": pl, **consts}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns[name]


def t32(a):
    """numpy (u)int32 -> torch int32 of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def both(name, *args, **kw):
    """(plain version, wrapper on the CPU) outputs, as numpy."""
    kernels.reset_launches()
    out = (probes.PLAIN[name](*args, **kw).numpy(),
           probes.WRAPPERS[name](*args, **kw).numpy())
    assert kernels.LAUNCHES[name] == 0
    return out


def test_add():
    x = np.arange(1024, dtype=np.int32).reshape(8, 128)
    want = pl.pallas_call(
        lift("ab_pallas.py", "add_kernel"),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
        interpret=True)(jnp.asarray(x))
    for got in both("probe_add", t32(x)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_stream_rows_uint32():
    rng = np.random.RandomState(1)
    state = rng.randint(0, 1 << 32, size=(K, L), dtype=np.uint64).astype(
        np.uint32)
    state[:, 3] = rng.randint(0, 5, size=K)  # a limb far below 2^31
    want = pl.pallas_call(
        lift("ab_pallas.py", "stream_kernel"), grid=(K // TILE,),
        in_specs=[pl.BlockSpec((TILE, L), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((1, L), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, L), jnp.uint32),
        interpret=True)(jnp.asarray(state))
    for got in both("probe_stream_rows", t32(state), layout="rows",
                    unsigned=True):
        np.testing.assert_array_equal(got.view(np.uint32), np.asarray(want))
    assert np.asarray(want).max() >= 1 << 31  # the unsigned order mattered


def test_join_uint32():
    rng = np.random.RandomState(2)
    state = rng.randint(0, 1 << 32, size=(K, L), dtype=np.uint64).astype(
        np.uint32)
    queries = rng.randint(0, 1 << 32, size=(NT, QT, L),
                          dtype=np.uint64).astype(np.uint32)
    queries[0, :2, 0] = state[:2, 0]  # ties: equal is not below
    want = pl.pallas_call(
        lift("ab_pallas.py", "join_kernel"), grid=(K // TILE,),
        in_specs=[pl.BlockSpec((TILE, L), lambda i: (i, 0)),
                  pl.BlockSpec((None, QT, L), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((None, QT), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((K // TILE, QT), jnp.int32),
        interpret=True)(jnp.asarray(state), jnp.asarray(queries))
    for got in both("probe_join", t32(state), t32(queries), unsigned=True):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("off", [16, 0, 56])
def test_dynwrite(off):
    x = np.arange(8 * 128, dtype=np.int32).reshape(8, 128) + 1
    want = np.asarray(pl.pallas_call(
        lift("ab_pallas.py", "dynwrite_kernel"),
        in_specs=[pl.BlockSpec((1,), lambda: (0,)),
                  pl.BlockSpec((8, 128), lambda: (0, 0))],
        out_specs=pl.BlockSpec((64, 128), lambda: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((64, 128), jnp.int32),
        interpret=True)(jnp.asarray([off], jnp.int32), jnp.asarray(x)))
    for got in both("probe_dynwrite", t32(np.array([off], np.int32)), t32(x),
                    rows=64):
        np.testing.assert_array_equal(got[off:off + 8], want[off:off + 8])
        assert not np.delete(got, np.s_[off:off + 8], axis=0).any()


def _pallas_dynwrite(c):
    """dynwrite_kernel at C columns, jitted once: (off, x) -> (64, C)."""
    return jax.jit(pl.pallas_call(
        lift("ab_pallas.py", "dynwrite_kernel"),
        in_specs=[pl.BlockSpec((1,), lambda: (0,)),
                  pl.BlockSpec((8, c), lambda: (0, 0))],
        out_specs=pl.BlockSpec((64, c), lambda: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((64, c), jnp.int32),
        interpret=True))


@pytest.mark.parametrize("c", [128, 6, 5, 1, 4, 132])
def test_dynwrite_edges_equal_the_pallas_body(c):
    # offsets below zero, at and past the last row, and where the 8 rows
    # run past the end: the Pallas slice counts a negative offset from the
    # end and clamps the start so that the rows fit, and so must the port
    # (probes.dynwrite_edge_calls, which the card's kernel is held to as
    # well); C = 6, 5 and 1 are not multiples of 4
    fn = _pallas_dynwrite(c)
    calls = [(a, kw) for a, kw in probes.dynwrite_edge_calls("cpu")
             if a[1].shape == (8, c)]
    assert len(calls) == 13
    for (off, x), kw in calls:
        assert int(x.min()) > np.iinfo(np.int32).min  # unwritten marker
        want = np.asarray(fn(jnp.asarray(off.numpy()),
                             jnp.asarray(x.numpy())))
        written = (want != np.iinfo(np.int32).min).any(axis=1)
        assert written.sum() == 8, int(off)
        for got in both("probe_dynwrite", off, x, **kw):
            np.testing.assert_array_equal(got[written], want[written])
            assert not got[~written].any()
        start = int(probes.dynwrite_start(off, 8, 64))
        assert written[start:start + 8].all()


def test_dynwrite_refuses_more_rows_than_the_output():
    with pytest.raises(FDBError):
        probes.dynwrite(torch.zeros(1, dtype=torch.int32),
                        torch.zeros((9, 4), dtype=torch.int32), rows=8)


def test_stream_limbs_int32():
    rng = np.random.RandomState(3)
    state = rng.randint(-(1 << 31), 1 << 31, size=(L, K)).astype(np.int32)
    state[2] = -rng.randint(1, 9, size=K)  # an all-negative limb: max is 0
    want = pl.pallas_call(
        lift("ab_pallas2.py", "stream_kernel"), grid=(REP, NT),
        in_specs=[pl.BlockSpec((L, TILE), lambda r, i: (0, i))],
        out_specs=pl.BlockSpec((L, 1), lambda r, i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((L, 1), jnp.int32),
        interpret=True)(jnp.asarray(state))
    for got in both("probe_stream_limbs", t32(state), layout="limbs"):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert int(np.asarray(want)[2, 0]) == 0


def test_lexjoin_int32():
    rng = np.random.RandomState(4)
    # limb values in [0, 3): the first limbs tie often, so later limbs and
    # full-key ties decide ranks
    state = rng.randint(0, 3, size=(L, K)).astype(np.int32)
    queries = rng.randint(0, 3, size=(NT, L, QT)).astype(np.int32)
    state[:, 5] = -7  # a negative limb value
    want = pl.pallas_call(
        lift("ab_pallas2.py", "lexjoin_kernel", QT=QT, TILE=TILE, LK=LK),
        grid=(REP, NT),
        in_specs=[pl.BlockSpec((L, TILE), lambda r, i: (0, i)),
                  pl.BlockSpec((1, L, QT), lambda r, i: (i, 0, 0))],
        out_specs=pl.BlockSpec((QT,), lambda r, i: (i,)),
        out_shape=jax.ShapeDtypeStruct((NT * QT,), jnp.int32),
        interpret=True)(jnp.asarray(state), jnp.asarray(queries))
    for got in both("probe_lexjoin", t32(state), t32(queries), limbs=LK):
        np.testing.assert_array_equal(got, np.asarray(want))
    # and the searchsorted check of ab_pallas2.py:89-105 agrees
    probes.lexjoin_searchsorted_check(t32(state), t32(queries),
                                      torch.from_numpy(np.array(want)))


def test_script_calls_have_the_scripts_shapes():
    calls = probes.script_calls("meta")
    (s1,), kw = calls["probe_stream_rows"]
    assert tuple(s1.shape) == (1 << 18, 8) and kw["unsigned"]
    (s2, q2), kw = calls["probe_lexjoin"]
    assert tuple(q2.shape) == (128, 8, 1024) and kw["limbs"] == 5
    (_, q1), _ = calls["probe_join"]
    assert tuple(q1.shape) == (128, 256, 8)


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(FDBError) as ei:
        probes.main()
    assert ei.value.name == "platform_error"


# ---------------------------------------------------------------------------
# the rank joins: edges, and the card's algorithm emulated
# ---------------------------------------------------------------------------

EDGES = probes.rank_edge_calls("cpu")
SOURCE = os.path.join(os.path.dirname(probes.__file__), "..", "csrc",
                      "probes.cu")


def pallas_join(state, queries):
    """join_kernel over state (K, L) uint32 and queries (NT, QT, L)."""
    nt, qt, nl = queries.shape
    tile = state.shape[0] // nt
    return np.asarray(pl.pallas_call(
        lift("ab_pallas.py", "join_kernel"), grid=(nt,),
        in_specs=[pl.BlockSpec((tile, nl), lambda i: (i, 0)),
                  pl.BlockSpec((None, qt, nl), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((None, qt), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((nt, qt), jnp.int32),
        interpret=True)(jnp.asarray(state), jnp.asarray(queries)))


def pallas_lexjoin(state, queries, limbs):
    """lexjoin_kernel over state (L, K) int32 and queries (NT, L, QT)."""
    nt, nl, qt = queries.shape
    tile = state.shape[1] // nt
    return np.asarray(pl.pallas_call(
        lift("ab_pallas2.py", "lexjoin_kernel", QT=qt, TILE=tile, LK=limbs),
        grid=(1, nt),
        in_specs=[pl.BlockSpec((nl, tile), lambda r, i: (0, i)),
                  pl.BlockSpec((1, nl, qt), lambda r, i: (i, 0, 0))],
        out_specs=pl.BlockSpec((qt,), lambda r, i: (i,)),
        out_shape=jax.ShapeDtypeStruct((nt * qt,), jnp.int32),
        interpret=True)(jnp.asarray(state), jnp.asarray(queries)))


def packed_ranks(state, queries, limbs, unsigned):
    """Each query's searchsorted position among its tile's sorted keys,
    packed into Python integers (ab_pallas2.py:89-105's check)."""
    nt, _, qt = queries.shape
    tile = state.shape[1] // nt
    bits = np.uint32 if unsigned else np.int32
    s = state.view(bits).astype(np.int64)[:limbs]
    q = queries.view(bits).astype(np.int64)[:, :limbs]

    def pack(a):
        v = np.zeros(a.shape[1], dtype=object)
        for lvl in range(limbs):
            v = v * (1 << 32) + (a[lvl] + (0 if unsigned else 1 << 31))
        return v
    out = [np.searchsorted(np.sort(pack(s[:, t * tile:(t + 1) * tile])),
                           pack(q[t]), side="left") for t in range(nt)]
    return np.concatenate(out).astype(np.int32)


@pytest.mark.parametrize("i", range(len(EDGES)))
def test_rank_edges_equal_the_pallas_bodies(i):
    name, (state, queries), kw = EDGES[i]
    s, q = state.numpy(), queries.numpy()
    if name == "probe_join":
        want = pallas_join(s.view(np.uint32), q.view(np.uint32))
    elif kw["unsigned"]:  # ab_pallas2.py's lexjoin is signed
        want = packed_ranks(s, q, kw["limbs"], True)
    else:
        want = pallas_lexjoin(s, q, kw["limbs"])
        np.testing.assert_array_equal(
            want, packed_ranks(s, q, kw["limbs"], False))
    for got in both(name, state, queries, **kw):
        np.testing.assert_array_equal(got, want)


def source_define(name: str) -> int:
    with open(SOURCE) as f:
        for line in f:
            if line.startswith(f"#define {name} "):
                return int(line.split()[2])
    raise KeyError(name)


def test_rank_constants_match_the_source():
    assert source_define("RANK_PRIMARY") == probes.RANK_PRIMARY
    assert source_define("RANK_MAX_QT") == probes.RANK_MAX_QT
    assert source_define("PROBE_MAX_L") == probes.MAX_LIMBS
    assert source_define("RANK_ROWS") >= 1
    # the scripts' queries fit, and 2,500 queries of 8 limbs pass 48 KB
    assert probes.rank_smem_bytes(256, 1) == 256 * 20 + 257 * 4
    assert probes.rank_smem_bytes(1024, 5) == 1024 * 20 + 4 * 1024 * 4 + 4
    assert probes.rank_smem_bytes(2500, 8) > 48 * 1024


@pytest.mark.parametrize("qt", [probes.RANK_MAX_QT + 1, 1 << 14])
def test_rank_refuses_what_does_not_fit(qt):
    # past the 16-bit query indices; 16,384 queries of 8 limbs: 720 KB of
    # shared memory
    s = torch.zeros((8, 64), dtype=torch.int32, device="meta")
    q = torch.zeros((1, 8, qt), dtype=torch.int32, device="meta")
    with pytest.raises(FDBError) as ei:
        probes._launch_rank("probe_lexjoin", s, q, 64, 1, qt, 8,
                            (1, 64), (8 * qt, 1, qt), False, (qt,))
    assert ei.value.name == "invalid_option"


def emulate_rank(s_keys, q_keys, unsigned):
    """csrc/probes.cu's probe_rank_kernel in numpy, round for round:
    s_keys (NT, TILE, LK) and q_keys (NT, QT, LK) int32 bits ->
    (NT, QT) counts."""
    flip = np.uint32(0 if unsigned else 0x80000000)
    s = (s_keys.view(np.uint32) ^ flip).astype(np.int64)
    q = (q_keys.view(np.uint32) ^ flip).astype(np.int64)
    nt, qt, _ = q.shape
    out = np.empty((nt, qt), np.int32)

    def cmp(a, b):
        """-1, 0, 1 row by row: keys a against keys b, lexicographically."""
        res = np.zeros(a.shape[0], np.int64)
        for lvl in range(a.shape[1]):
            res = np.where(res == 0, np.sign(a[:, lvl] - b[:, lvl]), res)
        return res

    def count(keys, sorted_keys, lo, n, or_equal):
        """rank_count: positions p in [lo, lo + n) of sorted_keys below
        each key (or at or below it), by a bisection that halves the
        window each step."""
        base = lo.copy()

        def below(p):
            c = cmp(keys, sorted_keys[np.clip(p, 0, len(sorted_keys) - 1)])
            return (c > 0) | ((c == 0) & or_equal)
        while (n > 1).any():
            act = n > 1
            half = n >> 1
            base = np.where(act & below(base + half - 1), base + half, base)
            n = np.where(act, n - half, n)
        return base + ((n == 1) & below(base)) - lo

    for t in range(nt):
        order = np.arange(qt)  # position -> query index
        e = np.arange(qt)
        w = 1
        while w < qt:
            base = e & ~(2 * w - 1)
            left = e - base < w
            other = np.where(left, base + w, base)
            n = np.where(left, np.minimum(w, qt - other), w)
            keys = q[t, order]
            cnt = count(keys, keys, other, np.maximum(n, 0), ~left)
            pos = np.where(left, e, e - w) + cnt
            assert np.array_equal(np.sort(pos), e)  # distinct places
            new = np.empty_like(order)
            new[pos] = order
            order = new
            w *= 2
        rows = s[t]
        u = count(rows, q[t, order], np.zeros(rows.shape[0], np.int64),
                  np.full(rows.shape[0], qt, np.int64), True)
        hist = np.bincount(u, minlength=qt + 1)
        out[t, order] = np.cumsum(hist[:qt])
    return out


def rank_inputs(name, state, queries, kw):
    """(s_keys, q_keys, unsigned) of a rank-join call, as numpy: the
    arguments of `probes.rank_plain`."""
    nt = queries.shape[0]
    unsigned = kw.get("unsigned", name == "probe_join")
    if name == "probe_join":
        return (state[:, :1].reshape(nt, -1, 1).numpy(),
                queries[:, :, :1].numpy(), unsigned)
    lk = kw["limbs"]
    return (state[:lk].T.reshape(nt, -1, lk).numpy(),
            queries[:, :lk, :].transpose(1, 2).numpy(), unsigned)


def script_tiles(name, tiles=2):
    """The scripts' inputs of a rank join, their first `tiles` tiles."""
    (state, queries), kw = probes.script_calls("cpu")[name]
    rows = tiles * probes.TILE
    state = state[:rows] if name == "probe_join" else state[:, :rows]
    return name, (state, queries[:tiles]), kw


@pytest.mark.parametrize("case", list(range(len(EDGES)))
                         + ["probe_join", "probe_lexjoin"])
def test_rank_kernel_algorithm_equals_rank_plain(case):
    name, (state, queries), kw = (EDGES[case] if isinstance(case, int)
                                  else script_tiles(case))
    s_keys, q_keys, unsigned = rank_inputs(name, state, queries, kw)
    want = probes.rank_plain(torch.from_numpy(s_keys),
                             torch.from_numpy(q_keys), unsigned=unsigned)
    np.testing.assert_array_equal(emulate_rank(s_keys, q_keys, unsigned),
                                  want.numpy())
