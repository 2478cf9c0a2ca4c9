"""K5's algorithm (csrc/legacy_overlap.cu), emulated in numpy on the CPU,
against the plain `legacy_fixpoint` and `legacy_sweep`.

The kernel cannot run here, so its algorithm is written out pass by pass
at small sizes: the prologue's bounds (each read chunk's largest live
owner, each write chunk's smallest owner), tiles of reads x writes skipped
where no write of the chunk precedes a read, each tile's staged writes
(active in the pass's input, owned below the chunk's largest read owner)
against its live reads (eligible, above the chunk's smallest write owner,
their txn not yet marked in this pass), the blocked reads' txns marked in
one of four rotating bit sets (pass p writes set p % 4, reads p - 1 and
zeroes p + 1), the body's test as the count of marks that differ between
a pass's input and output after every even pass from 2 on, and the guard
(T / 2 + 2 bodies unless the caller gives another). Tiles run in a random
order each pass, as CTAs do. The committed set and the count of
evaluations must equal the plain version exactly (integers; the tolerance
is zero): dependency chains, owners in any order, padding, no reads or
writes, several tiles a chunk, the strided bench layout, a guard that
stops a chain unconverged, and one evaluation on a committed set that is
not within g; with the kernel's own constants, read from its source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops import kernels

CSRC = (Path(__file__).resolve().parent.parent / "foundationdb_tpu_torch"
        / "csrc")
CPU = torch.device("cpu")
INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1


def source_constant(name):
    m = re.search(rf"^#define {name} ([^/\n]+)",
                  (CSRC / "legacy_overlap.cu").read_text(), re.M)
    text = m.group(1).strip()
    if text.startswith("("):  # a product of two constants
        a, b = text.strip("()").split(" * ")
        return source_constant(a) * source_constant(b)
    return int(text)


RCHUNK = source_constant("LG_RCHUNK")
WCHUNK = source_constant("LG_WCHUNK")
BITSETS = source_constant("LG_BITSETS")


def test_the_wrapper_sizes_its_scratch_with_the_kernel_constants():
    assert kernels.LEGACY_TILE_READS == RCHUNK
    assert kernels.LEGACY_TILE_WRITES == WCHUNK
    assert kernels.LEGACY_BITSETS == BITSETS


def emulate(c, g, wtxn, rtxn, w_ok, r_ok, wbr, wer, rbr, rer, fixpoint,
            seed=0, max_bodies=None):
    """K5, pass by pass: (out, converged, evaluations)."""
    rng = np.random.default_rng(seed)
    c, g, wtxn, rtxn, w_ok, r_ok, wbr, wer, rbr, rer = (
        x.numpy().astype(np.int64) if x.dtype != torch.bool else x.numpy()
        for x in (c, g, wtxn, rtxn, w_ok, r_ok, wbr, wer, rbr, rer))
    T, NW, NR = g.shape[0], wtxn.shape[0], rtxn.shape[0]
    if max_bodies is None:
        max_bodies = T // 2 + 2
    n_rc, n_wc = -(-NR // RCHUNK), -(-NW // WCHUNK)

    def in_range(t):
        return (t >= 0) & (t < T)
    rmax, wmin = [], []
    for r in range(n_rc):
        j = np.arange(r * RCHUNK, min(NR, (r + 1) * RCHUNK))
        t = rtxn[j]
        live = r_ok[j] & in_range(t)
        live[live] &= g[t[live]]
        rmax.append(int(t[live].max()) if live.any() else INT_MIN)
    for w in range(n_wc):
        i = np.arange(w * WCHUNK, min(NW, (w + 1) * WCHUNK))
        t = wtxn[i]
        ok = w_ok[i] & in_range(t)
        ok[ok] &= g[t[ok]] | c[t[ok]]
        wmin.append(int(t[ok].min()) if ok.any() else INT_MAX)
    marks = np.zeros((BITSETS, T), dtype=bool)
    converged, p = True, 0
    while True:
        mp, mprev = marks[p % BITSETS], marks[(p - 1) % BITSETS]
        if p > 0:
            marks[(p + 1) % BITSETS] = False
        tiles = [(r, w) for r in range(n_rc) for w in range(n_wc)]
        for k in rng.permutation(len(tiles)):
            r, w = tiles[k]
            if wmin[w] >= rmax[r]:
                continue
            i = np.arange(w * WCHUNK, min(NW, (w + 1) * WCHUNK))
            t = wtxn[i]
            act = w_ok[i] & in_range(t) & (t < rmax[r])
            tc = t[act]
            act[act] = c[tc] if p == 0 else g[tc] & ~mprev[tc]
            i = i[act]
            j = np.arange(r * RCHUNK, min(NR, (r + 1) * RCHUNK))
            t = rtxn[j]
            live = r_ok[j] & in_range(t) & (t > wmin[w])
            tl = t[live]
            live[live] = g[tl] & ~mp[tl]
            j = j[live]
            if not len(i) or not len(j):
                continue
            hit = ((wtxn[i][:, None] < rtxn[j][None, :])
                   & (wbr[i][:, None] < rer[j][None, :])
                   & (rbr[j][None, :] < wer[i][:, None])).any(axis=0)
            mp[rtxn[j][hit]] = True
        if not fixpoint:
            break
        if p >= 2 and p % 2 == 0:
            if not (mp ^ mprev).any():
                break
            if p // 2 >= max_bodies:
                converged = False
                break
        p += 1
    return g & ~marks[p % BITSETS], converged, p + 1


def assert_fixpoint(args, seed=0):
    g = args[0]
    n = torch.zeros((), dtype=torch.int32)
    want, want_conv = ref.legacy_fixpoint(*args, evals=n)
    got, conv, evals = emulate(g, *args, fixpoint=True, seed=seed)
    np.testing.assert_array_equal(got, want.numpy())
    assert conv and bool(want_conv)
    assert evals == int(n)
    return evals


def chain(T):
    ar = torch.arange(T, dtype=torch.int32)
    ok = torch.ones(T, dtype=torch.bool)
    return (ok, ar, ar, ok, ok, ar + 1, ar + 2, ar, ar + 1)


def random_pooled(seed, T, NW, NR, span=40, p_g=0.9):
    rng = np.random.default_rng(seed)

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
    wt, rt = t32(rng.integers(0, T + 1, NW)), t32(rng.integers(0, T + 1, NR))
    wb, rb = t32(rng.integers(0, span, NW)), t32(rng.integers(0, span, NR))
    we, re_ = wb + t32(rng.integers(0, 5, NW)), rb + t32(rng.integers(0, 5, NR))
    g = torch.from_numpy(rng.random(T) < p_g)
    return (g, wt, rt, (wt < T) & (wb < we), (rt < T) & (rb < re_), wb, we,
            rb, re_)


def shuffled(args, seed, reads=True, writes=True):
    rng = np.random.default_rng(seed)
    a = list(args)
    for flag, idx in ((reads, (2, 4, 7, 8)), (writes, (1, 3, 5, 6))):
        if flag:
            perm = torch.from_numpy(rng.permutation(a[idx[0]].shape[0]))
            for i in idx:
                a[i] = a[i][perm].contiguous()
    return tuple(a)


@pytest.mark.parametrize("T", [1, 64, 700, 1100])
def test_chains_take_an_evaluation_a_txn(T):
    evals = assert_fixpoint(chain(T), seed=T)
    assert evals >= T


@pytest.mark.parametrize("seed,T,NW,NR", [(1, 700, 2100, 1900),
                                         (2, 64, 1100, 1300),
                                         (3, 33, 0, 80), (4, 33, 80, 0),
                                         (5, 1024, 1024, 1024)])
def test_random_pooled_owners_in_any_order(seed, T, NW, NR):
    args = random_pooled(seed, T, NW, NR)
    assert_fixpoint(args, seed)
    assert_fixpoint(shuffled(args, seed + 10), seed + 1)


def test_shuffled_chains_and_nothing_eligible():
    assert_fixpoint(shuffled(chain(900), 7), 3)
    assert_fixpoint(shuffled(chain(900), 8, reads=False), 4)
    a = chain(600)
    assert_fixpoint((torch.zeros_like(a[0]),) + a[1:])


def test_the_strided_bench_layout():
    """A legacy step's fixpoint call at the kernel bench's strided shape
    (T=2,048: four read tiles by eight write tiles, about half of them skipped)."""
    from foundationdb_tpu_torch import bench
    T = 2048
    batches = bench.stage(bench._encode_batches(2, seed=3,
                                                version0=bench.WINDOW, T=T),
                          CPU)
    state = ref.init_state(1 << 14, bench.LIMBS, CPU)
    calls = []

    def spy(*a):
        calls.append(a)
        return ref.legacy_fixpoint(*a)
    phases = type(ref.PLAIN)(**dict(vars(ref.PLAIN), legacy_fixpoint=spy))
    for i in range(2):
        state, _st, _info = ref.conflict_step(
            state, {k: v[i] for k, v in batches.items()},
            max_write_life=bench.WINDOW, intra_mode="legacy", strided=True,
            phases=phases)
    assert len(calls) == 2
    for k, a in enumerate(calls):
        assert assert_fixpoint(a, seed=k) >= 3


def test_the_default_guard_is_the_plain_versions():
    assert ref.legacy_guard(1100) == 1100 // 2 + 2


@pytest.mark.parametrize("T,max_bodies", [(64, 1), (64, 5), (700, 40)])
def test_the_guard_stops_a_chain_unconverged(T, max_bodies):
    """A chain needs an evaluation a txn: stopped after `max_bodies`
    bodies, the kernel's last lower bound, converged False and its count
    of evaluations equal the guarded plain version's."""
    args = shuffled(chain(T), T)
    n = torch.zeros((), dtype=torch.int32)
    want, want_conv = ref.legacy_fixpoint(*args, evals=n,
                                          max_bodies=max_bodies)
    got, conv, evals = emulate(args[0], *args, fixpoint=True, seed=T,
                               max_bodies=max_bodies)
    np.testing.assert_array_equal(got, want.numpy())
    assert not conv and not bool(want_conv)
    assert evals == int(n) == 1 + 2 * max_bodies
    full, _conv = ref.legacy_fixpoint(*args)
    assert not torch.equal(want, full)


@pytest.mark.parametrize("seed", [1, 2])
def test_one_evaluation_on_any_committed_set(seed):
    rng = np.random.default_rng(seed)
    args = random_pooled(seed, 900, 1600, 1400)
    c = torch.from_numpy(rng.random(900) < 0.5)  # not within g
    got, conv, evals = emulate(c, *args, fixpoint=False, seed=seed)
    np.testing.assert_array_equal(got, ref.legacy_sweep(c, *args).numpy())
    assert conv and evals == 1
