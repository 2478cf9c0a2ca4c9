"""Counterparts of the Pallas A/B probes: a streaming pass and a rank join
over a 2^18-row key state.

scripts/ab_pallas.py and scripts/ab_pallas2.py hold the repository's six
`pl.pallas_call` kernels. Each has a Hopper kernel in csrc/probes.cu (built
into the conflict kernels' library, ops/kernels.py), a wrapper here with
its launch count in `kernels.LAUNCHES`, and a plain PyTorch version:

  add       probe_add           ab_pallas.py:37   add_kernel
  stream    probe_stream_rows   ab_pallas.py:49   stream_kernel (uint32, rows)
            probe_stream_limbs  ab_pallas2.py:39  stream_kernel (int32, limbs)
  join      probe_join          ab_pallas.py:80   join_kernel
  lexjoin   probe_lexjoin       ab_pallas2.py:64  lexjoin_kernel
  dynwrite  probe_dynwrite      ab_pallas.py:112  dynwrite_kernel

dynwrite writes x's rows where the Pallas body's dynamic slice puts them:
a negative offset counts from the end and the start is clamped so that
the rows fit (`dynwrite_start`), as Pallas's interpret mode runs it.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises. The uint32 data of ab_pallas.py travels as
int32 tensors holding the same bits, with `unsigned=True`, so results keep
uint32 order and bits.

`python -m foundationdb_tpu_torch.ops.probes` is the counterpart of the two
scripts' top level: on the card it runs each probe at the scripts' shapes
(K = 2^18, L = 8, TILE = 2,048, 50 passes, QT = 256 and 1,024), prints
ms/pass, and checks lexjoin against a sorted-key searchsorted as
ab_pallas2.py:89-105 does. It raises where there is no card. Importing the
module runs nothing.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from foundationdb_tpu_torch.ops import kernels
from foundationdb_tpu_torch.utils import cudaenv
from foundationdb_tpu_torch.utils.errors import FDBError

# the scripts' shapes
K = 1 << 18
L = 8
TILE = 2048
NT = K // TILE
PASSES = 50
QT_JOIN = 256
QT_LEX = 1024
LK = 5
MAX_LIMBS = 8  # PROBE_MAX_L in the source
RANK_PRIMARY = 2  # limbs in the rank join's 64-bit primary key
RANK_MAX_QT = (1 << 16) - 1  # queries a tile: their indices are 16 bits
RANK_SMEM_LIMIT = 227 * 1024  # shared memory an H100 block may opt in to

_I32 = torch.int32
_U32 = 1 << 32


def _check(name, t, shape=None):
    kernels._check(name, t.device,
                   t=(t, _I32, tuple(t.shape) if shape is None else shape))


def _as_ordered(x: torch.Tensor, unsigned: bool) -> torch.Tensor:
    """int64 values whose order is the uint32 (or int32) order of x."""
    v = x.to(torch.int64)
    return v & (_U32 - 1) if unsigned else v


def _to_i32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [-2^31, 2^32) -> int32 tensors of the same low bits."""
    return ((v + (1 << 31)) % _U32 - (1 << 31)).to(_I32)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def add_plain(x):
    return x + 1


def stream_plain(state, *, layout: str, unsigned: bool = False):
    """max(0, max over rows) per limb: (1, L) for a row-major (K, L) state,
    (L, 1) for a limb-major (L, K) one."""
    axis = 0 if layout == "rows" else 1
    m = torch.clamp(_as_ordered(state, unsigned).amax(dim=axis,
                                                      keepdim=True), min=0)
    return _to_i32_bits(m)


def rank_plain(s_keys, q_keys, *, unsigned: bool = False):
    """Per tile t and query q: the count of tile t's state keys below query
    q's key, lexicographically. s_keys (NT, TILE, LK), q_keys (NT, QT, LK)
    -> (NT, QT) int32."""
    s = _as_ordered(s_keys, unsigned)[:, None, :, :]
    q = _as_ordered(q_keys, unsigned)[:, :, None, :]
    lt = torch.zeros(s.shape[0], q.shape[1], s.shape[2], dtype=torch.bool,
                     device=s_keys.device)
    eq = torch.ones_like(lt)
    for lvl in range(s_keys.shape[2]):
        lt |= eq & (s[..., lvl] < q[..., lvl])
        eq &= s[..., lvl] == q[..., lvl]
    return lt.sum(dim=2, dtype=_I32)


def join_plain(state, queries, *, unsigned: bool = True):
    nt = queries.shape[0]
    return rank_plain(state[:, :1].reshape(nt, -1, 1), queries[:, :, :1],
                      unsigned=unsigned)


def lexjoin_plain(state, queries, *, limbs: int = LK,
                  unsigned: bool = False):
    nt = queries.shape[0]
    s = state[:limbs].T.reshape(nt, -1, limbs)
    q = queries[:, :limbs, :].transpose(1, 2)
    return rank_plain(s, q, unsigned=unsigned).reshape(-1)


def dynwrite_start(off, nx: int, rows: int):
    """Where dynwrite_kernel's `o_ref[pl.ds(off, 8), :]` writes its rows:
    a dynamic update slice adds `rows` to a negative offset and clamps the
    start to [0, rows - nx], so that the rows fit. off (1,) -> (1,) int64,
    on off's device."""
    o = off.to(torch.int64)
    return torch.where(o < 0, o + rows, o).clamp(0, rows - nx)


def dynwrite_plain(off, x, *, rows: int):
    """(rows, C) zeros with x's rows written from `dynwrite_start`."""
    nx = x.shape[0]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if nx == 0:
        return zero.expand(rows, x.shape[1]).clone()
    k = torch.arange(rows, device=x.device)[:, None] - \
        dynwrite_start(off, nx, rows)
    keep = (k >= 0) & (k < nx)
    return torch.where(keep, x[torch.clamp(k[:, 0], 0, nx - 1)], zero)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def add(x):
    """x + 1 (add_kernel)."""
    if not kernels._on_cuda("probe_add", x):
        return add_plain(x)
    _check("probe_add", x)
    out = torch.empty_like(x)
    rc = kernels.library().fdb_probe_add(x.data_ptr(), out.data_ptr(),
                                         x.numel(), kernels._stream())
    kernels._launched("probe_add", rc)
    return out


def stream(state, *, layout: str, unsigned: bool = False):
    """Per-limb max of a key state, zero-initialised (stream_kernel):
    layout "rows" is ab_pallas.py's (K, L) state -> (1, L), layout "limbs"
    ab_pallas2.py's (L, K) state -> (L, 1)."""
    if layout not in ("rows", "limbs"):
        raise FDBError("invalid_option", f"stream: layout {layout!r}")
    name = f"probe_stream_{layout}"
    if not kernels._on_cuda(name, state):
        return stream_plain(state, layout=layout, unsigned=unsigned)
    _check(name, state)
    if layout == "rows":
        nk, nl = state.shape
        strides, out_shape = (nl, 1), (1, nl)
    else:
        nl, nk = state.shape
        strides, out_shape = (1, nk), (nl, 1)
    if nl > MAX_LIMBS:
        raise FDBError("invalid_option", f"{name}: at most {MAX_LIMBS} limbs")
    out = torch.zeros(out_shape, dtype=_I32, device=state.device)
    rc = kernels.library().fdb_probe_stream(
        state.data_ptr(), nk, nl, strides[0], strides[1], int(unsigned),
        out.data_ptr(), kernels._stream())
    kernels._launched(name, rc)
    return out


def join(state, queries, *, unsigned: bool = True):
    """join_kernel: state (K, L) row-major, queries (NT, QT, L) ->
    (NT, QT) int32, the count of tile i's state rows whose limb 0 is below
    each of tile i's queries' limb 0."""
    if not kernels._on_cuda("probe_join", state):
        return join_plain(state, queries, unsigned=unsigned)
    nk, nl = state.shape
    nt, qt, _ = queries.shape
    _check("probe_join", queries, (nt, qt, nl))
    return _launch_rank("probe_join", state, queries, nk, nt, qt, 1,
                        (nl, 1), (qt * nl, nl, 1), unsigned, (nt, qt))


def lexjoin(state, queries, *, limbs: int = LK, unsigned: bool = False):
    """lexjoin_kernel: state (L, K) limb-major, queries (NT, L, QT) ->
    (NT * QT,) int32, each query's rank among its tile's state keys over
    the first `limbs` limbs."""
    if not kernels._on_cuda("probe_lexjoin", state):
        return lexjoin_plain(state, queries, limbs=limbs, unsigned=unsigned)
    nl, nk = state.shape
    nt, _, qt = queries.shape
    _check("probe_lexjoin", queries, (nt, nl, qt))
    if limbs > nl:
        raise FDBError("invalid_option", f"probe_lexjoin: {limbs} > {nl} limbs")
    return _launch_rank("probe_lexjoin", state, queries, nk, nt, qt, limbs,
                        (1, nk), (nl * qt, 1, qt), unsigned, (nt * qt,))


def rank_smem_bytes(qt: int, lk: int) -> int:
    """Shared memory of a rank-join CTA (`rank_smem_bytes` in the source):
    two buffers of the qt queries' primary keys (8 bytes) and indices (2),
    the limbs past the primary key of every query and qt + 1 histogram
    bins (4 bytes each)."""
    return qt * 20 + (max(0, lk - RANK_PRIMARY) * qt + qt + 1) * 4


def _launch_rank(name, state, queries, nk, nt, qt, lk, s_strides,
                 q_strides, unsigned, out_shape):
    """Launch probe_rank: tile t's rows are [t * nk / nt, (t + 1) * nk / nt),
    row r's limb l at r * s_strides[0] + l * s_strides[1], query (t, q)'s
    limb l at t * q_strides[0] + q * q_strides[1] + l * q_strides[2]."""
    _check(name, state)
    tile = nk // max(nt, 1)
    if nt < 1 or nt * tile != nk or not 1 <= lk <= MAX_LIMBS:
        raise FDBError("invalid_option",
                       f"{name}: {nt} tiles do not divide the state, or "
                       f"{lk} limbs is not in [1, {MAX_LIMBS}]")
    if qt > RANK_MAX_QT or rank_smem_bytes(qt, lk) > RANK_SMEM_LIMIT:
        raise FDBError("invalid_option",
                       f"{name}: {qt} queries a tile x {lk} limbs need "
                       f"{rank_smem_bytes(qt, lk)} bytes of shared memory "
                       f"(at most {RANK_SMEM_LIMIT}, and {RANK_MAX_QT} "
                       f"queries)")
    out = torch.empty(out_shape, dtype=_I32, device=state.device)
    rc = kernels.library().fdb_probe_rank(
        state.data_ptr(), queries.data_ptr(), nt, tile, qt, lk, *s_strides,
        *q_strides, int(unsigned), out.data_ptr(), kernels._stream())
    kernels._launched(name, rc)
    return out


def dynwrite(off, x, *, rows: int):
    """dynwrite_kernel: (rows, C) with x's rows written at the offset held
    on the device in off (1,), placed as the Pallas slice places them
    (`dynwrite_start`), zeros elsewhere. x may not have more rows than the
    output (the Pallas slice refuses that too)."""
    nx, c = x.shape
    if nx > rows:
        raise FDBError("invalid_option",
                       f"probe_dynwrite: {nx} rows of x into {rows} rows")
    if not kernels._on_cuda("probe_dynwrite", x):
        return dynwrite_plain(off, x, rows=rows)
    kernels._check("probe_dynwrite", x.device, off=(off, _I32, (1,)),
                   x=(x, _I32, (nx, c)))
    out = torch.empty((rows, c), dtype=_I32, device=x.device)
    rc = kernels.library().fdb_probe_dynwrite(
        off.data_ptr(), x.data_ptr(), nx, rows, c, out.data_ptr(),
        kernels._stream())
    kernels._launched("probe_dynwrite", rc)
    return out


PLAIN = {"probe_add": add_plain, "probe_stream_rows": stream_plain,
         "probe_join": join_plain, "probe_dynwrite": dynwrite_plain,
         "probe_stream_limbs": stream_plain, "probe_lexjoin": lexjoin_plain}
WRAPPERS = {"probe_add": add, "probe_stream_rows": stream,
            "probe_join": join, "probe_dynwrite": dynwrite,
            "probe_stream_limbs": stream, "probe_lexjoin": lexjoin}


# ---------------------------------------------------------------------------
# the scripts' top level
# ---------------------------------------------------------------------------

def script_calls(device) -> dict:
    """{probe name: (args, kwargs)} at the scripts' shapes, drawn as the
    scripts draw them (numpy RandomState(0) in each script)."""
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rng = np.random.RandomState(0)
    state1 = rng.randint(0, 1 << 31, size=(K, L)).astype(np.uint32)
    queries1 = rng.randint(0, 1 << 31, size=(NT, QT_JOIN, L)).astype(
        np.uint32)
    rng = np.random.RandomState(0)
    state2 = rng.randint(0, 1 << 30, size=(L, K)).astype(np.int32)
    queries2 = rng.randint(0, 1 << 30, size=(NT, L, QT_LEX)).astype(np.int32)
    s1 = t(state1.view(np.int32))
    return {
        "probe_add": ((t(np.arange(1024, dtype=np.int32).reshape(8, 128)),),
                      {}),
        "probe_stream_rows": ((s1,), {"layout": "rows", "unsigned": True}),
        "probe_join": ((s1, t(queries1.view(np.int32))), {"unsigned": True}),
        "probe_dynwrite": ((t(np.array([16], np.int32)),
                            t(np.ones((8, 128), np.int32))), {"rows": 64}),
        "probe_stream_limbs": ((t(state2),), {"layout": "limbs"}),
        "probe_lexjoin": ((t(state2), t(queries2)), {"limbs": LK}),
    }


def rank_edge_calls(device) -> list:
    """[(probe name, args, kwargs)]: the rank joins' edge inputs, drawn
    from a seeded numpy generator. join (uint32 bits, row-major): an
    all-equal tile with queries below, at and above it; the full uint32
    range with half the queries equal to tile keys; four values with the
    high bits set in tiles of 1,000 rows (not a power of two) and more
    queries than a block has threads; tiles of one row. lexjoin (int32,
    limb-major): LK = 1 to 8 over few values (ties on every prefix);
    rows that share their first LK - 1 limbs (LK = 5 and 8); an all-equal
    tile; queries equal to tile keys; tiles of 3,000 rows and 2,500
    queries at LK = 8 (past 48 KB of shared memory, and more queries than
    a block has threads); unsigned limbs with the high bit set."""
    dev = torch.device(device)
    rng = np.random.default_rng(41)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(
            dev)

    def u32(lo, hi, shape):
        return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.uint32)
    out = []

    def join(state, queries):
        out.append(("probe_join", (t(state), t(queries)), {"unsigned": True}))

    def lex(state, queries, limbs, unsigned=False):
        out.append(("probe_lexjoin", (t(state), t(queries)),
                    {"limbs": limbs, "unsigned": unsigned}))
    v = 0x80000005
    join(np.full((2048, 8), v, np.uint32),
         rng.choice(np.array([v - 1, v, v + 1], np.uint32), (2, 256, 8)))
    state = u32(0, 1 << 32, (4096, 8))
    queries = u32(0, 1 << 32, (2, 512, 8))
    tiles = state.reshape(2, 2048, 8)
    take = rng.random((2, 512)) < 0.5
    rows = rng.integers(0, 2048, (2, 512))
    tile_of = np.broadcast_to(np.arange(2)[:, None], (2, 512))
    queries[take] = tiles[tile_of[take], rows[take]]
    join(state, queries)
    four = np.array([0, 1 << 30, 1 << 31, 3 << 30], np.uint32)
    join(rng.choice(four, (3000, 3)), rng.choice(four, (3, 1500, 3)))
    join(u32(0, 8, (64, 2)), u32(0, 8, (64, 5, 2)))
    for lk in range(1, L + 1):
        lex(rng.integers(-2, 2, (L, 4096)).astype(np.int32),
            rng.integers(-2, 2, (2, L, 300)).astype(np.int32), lk)
    for lk in (5, 8):
        state = np.full((L, 2048), 9, np.int32)
        state[lk - 1] = rng.integers(-3, 3, 2048)
        queries = np.full((1, L, 256), 9, np.int32)
        queries[0, lk - 1] = rng.integers(-4, 4, 256)
        queries[0, rng.integers(0, lk - 1, 64), rng.integers(0, 256, 64)] = \
            rng.integers(8, 11, 64)  # some differ earlier
        lex(state, queries, lk)
    lex(np.full((L, 2048), 7, np.int32),
        rng.integers(6, 9, (2, L, 256)).astype(np.int32), LK)
    state = rng.integers(-(1 << 31), 1 << 31, (L, 4096)).astype(np.int32)
    queries = rng.integers(-(1 << 31), 1 << 31, (2, L, 512)).astype(np.int32)
    cols = rng.integers(0, 2048, (2, 512))
    for i in range(2):
        queries[i, :, ::2] = state[:, i * 2048 + cols[i, ::2]]
    lex(state, queries, LK)
    lex(rng.integers(-1, 2, (L, 9000)).astype(np.int32),
        rng.integers(-1, 2, (3, L, 2500)).astype(np.int32), L)
    high = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    lex(rng.choice(high, (L, 2048)), rng.choice(high, (2, L, 300)), LK,
        unsigned=True)
    return out


def dynwrite_edge_calls(device) -> list:
    """[(args, kwargs)] of dynwrite's edges at the script's 64 output rows,
    x drawn from a seeded numpy generator: offsets below zero (-3, -8,
    -20, -64, -65 and -2^31: the slice adds 64, then clamps to [0, 56]),
    at and past the last row (64, 70, 2^31 - 1), and where the 8 rows run
    past the end (57, 60, 63: clamped to 56), each at C = 128 (the
    script's), 6, 5 and 1 (not multiples of 4: one int32 a thread), 4 and
    132; x with one row, 64 rows (the whole output) and no row."""
    dev = torch.device(device)
    rng = np.random.default_rng(43)

    def x_of(nx, c):
        return torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, (nx, c)).astype(np.int32)).to(dev)

    def off_of(v):
        return torch.tensor([v], dtype=_I32, device=dev)
    out = []
    for off in (-3, -8, -20, -64, -65, -(1 << 31), 64, 70, (1 << 31) - 1,
                57, 60, 63, 16):
        for c in (128, 6, 5, 1, 4, 132):
            out.append(((off_of(off), x_of(8, c)), {"rows": 64}))
    for nx, off in ((1, 63), (1, -1), (64, 5), (64, -70), (0, 3)):
        out.append(((off_of(off), x_of(nx, 12)), {"rows": 64}))
    return out


def time_passes(fn, passes: int = PASSES, reps: int = 3) -> float:
    """Best of `reps` runs of `passes` back-to-back calls on the card, in
    ms per call (CUDA events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(passes):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / passes)
    return best


def lexjoin_searchsorted_check(state, queries, out, limbs: int = LK):
    """ab_pallas2.py:89-105: for the first and the last tile, each query's
    rank is the searchsorted position of its packed key among the tile's
    sorted packed keys. Raises AssertionError on a mismatch."""
    s_np = state.cpu().numpy()[:limbs].astype(np.int64)
    q_np = queries.cpu().numpy()
    got_all = out.cpu().numpy()
    nt, _, qt = q_np.shape
    tile = s_np.shape[1] // nt

    def pack(a):
        v = np.zeros(a.shape[1], dtype=object)
        for lvl in range(limbs):
            v = v * (1 << 32) + a[lvl]
        return v
    for t in (0, nt - 1):
        sl = s_np[:, t * tile:(t + 1) * tile]
        ql = q_np[t, :limbs].astype(np.int64)
        ranks = np.searchsorted(np.sort(pack(sl)), pack(ql), side="left")
        got = got_all[t * qt:(t + 1) * qt]
        assert np.array_equal(ranks, got), (t, ranks[:5], got[:5])


def main(device=None) -> dict:
    """The scripts' top level on the card: returns {probe: ms per pass}
    and prints as the scripts do."""
    dev = cudaenv.resolve_device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise FDBError("invalid_option", "the probes run on the card")
    calls = script_calls(dev)
    out = {}
    a, kw = calls["probe_add"]
    y = add(*a, **kw)
    assert torch.equal(y, a[0] + 1), "probe add differs from x + 1"
    print("probe add: OK")
    for name, label in (("probe_stream_rows", "stream max over (256k,8)"),
                        ("probe_join", "co-partition join 128tiles"),
                        ("probe_stream_limbs", "stream (8,256k) limb-major"),
                        ("probe_lexjoin", "lexjoin 5-limb")):
        a, kw = calls[name]
        fn = WRAPPERS[name]
        out[name] = time_passes(lambda fn=fn, a=a, kw=kw: fn(*a, **kw))
        print(f"{label:34s} {out[name]:8.3f} ms/pass")
    a, kw = calls["probe_dynwrite"]
    o = dynwrite(*a, **kw).cpu()
    print("dyn write row16 sum:", int(o[16].sum()), "(expect 128); row0:",
          int(o[0].sum()))
    assert int(o[16].sum()) == 128 and int(o[0].sum()) == 0
    out["probe_dynwrite"] = time_passes(lambda: dynwrite(*a, **kw))
    out["probe_add"] = time_passes(lambda: add(*calls["probe_add"][0]))
    (state, queries), kw = calls["probe_lexjoin"]
    lexjoin_searchsorted_check(state, queries, lexjoin(state, queries, **kw))
    print("lexjoin correctness: OK")
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
