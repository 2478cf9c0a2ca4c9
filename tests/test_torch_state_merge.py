"""K7's and K8's algorithms (csrc/state_merge.cu, csrc/endpoint_ranks.cu),
emulated in numpy on the CPU, against the plain `state_merge` and
`endpoint_ranks`.

The kernels cannot run here, so their algorithms are written out step for
step at small sizes. K7: tiles of threads * run outputs; the co-ranks of
each tile's two ends found by the two halves of the block, `probes`
evenly spaced candidates a round each; each thread's co-rank by bisection
in the tile's slices, then its run merged with two fingers into a staged
order, comparing from the first limb on which the slices' extremes differ
(a tile with no endpoint is the state slice in order); the rows written
from that order. K8: tiles of threads * run endpoints over a grid of at
most `grid` CTAs, each looping over its tiles; the key changes, striped
over the threads, as ballot words of 32 with their prefix counts; a
tile's count written; then (after the grid barrier) each tile's prefix
summed from the counts before it and each rank written. Every output must
equal the plain version exactly (integers; the tolerance is zero), at
tile and run edges, on tiles that hold only state (a padding tail) and
only endpoints, endpoints equal to state keys in every class, all-equal
keys, L = 2, 5 and 7, M = 0 and M <= 1,024, more tiles than CTAs, and
with the kernels' own constants, read from their sources.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops import kernels
from foundationdb_tpu_torch.ops.conflict import ConflictShapes

CSRC = (Path(__file__).resolve().parent.parent / "foundationdb_tpu_torch"
        / "csrc")
PAD = ref.PAD_LIMB


def source_constant(source, name):
    m = re.search(rf"^#define {name} (\d+)", (CSRC / source).read_text(),
                  re.M)
    return int(m.group(1))


def group_corank(q, na, nb, group, before):
    """The co-rank of output q as half a block finds it: `group` evenly
    spaced probes a round. (co-rank, rounds)."""
    lo, hi = max(0, q - nb), min(q, na)
    rounds = 0
    while lo < hi:
        step = -(-(hi - lo) // group)
        probes = [lo + m * step for m in range(group)]
        hits = [x < hi and before(x, q - x - 1) for x in probes]
        c = sum(hits)
        assert hits[:c] == [True] * c  # the predicate is a prefix
        if c == 0:
            hi = lo
        else:
            nxt = lo + c * step
            lo += (c - 1) * step + 1
            hi = min(hi, nxt)
        rounds += 1
    return lo, rounds


def bisect_corank(q, na, nb, before):
    """`fdb_corank`: one thread's bisection."""
    lo, hi = max(0, q - nb), min(q, na)
    while lo < hi:
        mid = (lo + hi) // 2
        if before(mid, q - mid - 1):
            lo = mid + 1
        else:
            hi = mid
    return lo


def emulate_merge(bkeys, bval, ekeys, eids, NR, threads, run, probes):
    """K7 step for step: (skeys, scls, sval, sidx, spos, cum_state) as
    numpy, and the most co-rank rounds a search took."""
    L, K = bkeys.shape
    M = ekeys.shape[1]
    N = K + M
    bk = [tuple(c) for c in bkeys.T]
    ek = [tuple(c) for c in ekeys.T]
    ecls = np.where((eids >= NR) & (eids < 2 * NR), 0, 2)
    tile_n = threads * run
    out = dict(skeys=np.zeros((L, N), np.int32),
               **{k: np.full(N, -7, np.int32)
                  for k in ("scls", "sval", "sidx", "spos", "cum")})

    def before(i, k):  # state i before endpoint k, in global memory
        return bk[i] < ek[k] or (bk[i] == ek[k] and ecls[k] == 2)

    max_rounds = 0
    for tile in range(-(-N // tile_n)):
        p0 = tile * tile_n
        p1 = min(p0 + tile_n, N)
        n = p1 - p0
        # 1. the two ends' co-ranks, a half of the block each
        (i0, r0), (i1, r1) = (group_corank(q, K, M, probes, before)
                              for q in (p0, p1))
        max_rounds = max(max_rounds, r0, r1)
        e0 = p0 - i0
        na = i1 - i0
        nb = n - na
        # 2. the slices in shared memory: state, then endpoints
        sk = bk[i0:i1] + ek[e0:e0 + nb]
        sv = list(bval[i0:i1]) + list(eids[e0:e0 + nb])
        # 3. each thread's run, merged with two fingers into `ord`,
        # comparing from f, the first limb on which the slices' extremes
        # differ
        order = list(range(n))
        if nb > 0:
            extremes = [sk[na], sk[na + nb - 1]]
            if na > 0:
                extremes += [sk[0], sk[na - 1]]
            f = next((l for l in range(L)
                      if len({e[l] for e in extremes}) > 1), L)
            assert all(key[:f] == extremes[0][:f] for key in sk)

            def local_before(i, k):
                a, b = sk[i][f:], sk[na + k][f:]
                return a < b or (a == b and ecls[e0 + k] == 2)
            for t in range(threads):
                q0 = t * run
                if q0 >= n:
                    continue
                i = bisect_corank(q0, na, nb, local_before)
                k = q0 - i
                for q in range(q0, min(q0 + run, n)):
                    st = k >= nb or (i < na and local_before(i, k))
                    order[q] = i if st else na + k
                    i, k = (i + 1, k) if st else (i, k + 1)
        # 4. the rows, from the staged order
        for q in range(n):
            src, p = order[q], p0 + q
            out["skeys"][:, p] = sk[src]
            if src < na:
                idx = i0 + src
                out["scls"][p], out["sval"][p] = 1, sv[src]
                out["sidx"][p], out["cum"][p] = idx, idx + 1
            else:
                j = sv[src]
                idx = K + j
                out["scls"][p] = 0 if NR <= j < 2 * NR else 2
                out["sval"][p], out["sidx"][p] = ref.NEG, idx
                out["cum"][p] = i0 + q - (src - na)
            out["spos"][idx] = p
    return (out["skeys"], out["scls"], out["sval"], out["sidx"],
            out["spos"], out["cum"]), max_rounds


def emulate_ranks(ekeys, eids, threads, run, grid):
    """K8 step for step: qranks as numpy."""
    L, M = ekeys.shape
    ek = [tuple(c) for c in ekeys.T]
    tile_n = threads * run
    n_tiles = -(-M // tile_n)
    G = min(n_tiles, grid)

    def flags(tile):  # ballot words of the tile and their prefix counts
        bits = [i < M and (i == 0 or ek[i] != ek[i - 1])
                for i in range(tile * tile_n, (tile + 1) * tile_n)]
        words = [sum(b << k for k, b in enumerate(bits[w:w + 32]))
                 for w in range(0, tile_n, 32)]
        pre = np.concatenate([[0], np.cumsum(
            [bin(w).count("1") for w in words])]).astype(int)
        return words, pre
    # 1. each CTA's tiles' counts
    counts = np.zeros(n_tiles, int)
    for cta in range(G):
        for t in range(cta, n_tiles, G):
            counts[t] = flags(t)[1][-1]
    # 3. after the barrier: each tile's prefix, then its ranks
    qranks = np.full(M, -7, np.int32)
    for cta in range(G):
        for t in range(cta, n_tiles, G):
            words, pre = flags(t)
            base = int(counts[:t].sum())
            for k in range(tile_n):
                i = t * tile_n + k
                if i < M:
                    upto = (2 << (k & 31)) - 1  # bits 0..k % 32
                    qranks[eids[i]] = (base + pre[k >> 5]
                                       + bin(words[k >> 5] & upto)
                                       .count("1") - 1)
    return qranks


def make_inputs(seed, L, K, NR, NW, *, live=None, values=3,
                ends_from_state=False, pad_ends=0.1):
    """(bkeys, bval, rb, re, wb, we) as int32 torch tensors: `live` sorted
    state keys (all K by default) then a padding tail, limbs from
    `values` small integers (ties of every kind); endpoints drawn from the
    same space, a share equal to state keys (all, with `ends_from_state`,
    padding tail included), some padding."""
    rng = np.random.default_rng(seed)
    live = K if live is None else live
    keys = rng.integers(-values // 2, values - values // 2, (L, live))
    keys = keys[:, np.lexsort(keys[::-1])].astype(np.int32)
    bkeys = np.full((L, K), PAD, np.int32)
    bkeys[:, :live] = keys
    bval = rng.integers(ref.NEG, 10_000, K).astype(np.int32)

    def ends(n):
        e = rng.integers(-values // 2, values - values // 2,
                         (L, n)).astype(np.int32)
        from_state = rng.random(n) < (1.0 if ends_from_state else 0.3)
        if K:
            e[:, from_state] = bkeys[:, rng.integers(0, K, from_state.sum())]
        if not ends_from_state:
            e[:, rng.random(n) < pad_ends] = PAD
        return torch.from_numpy(e)
    return (torch.from_numpy(bkeys), torch.from_numpy(bval),
            ends(NR), ends(NR), ends(NW), ends(NW))


# (inputs, (threads, run, probes, grid)): a tile is threads * run outputs
# (K7) or endpoints (K8), a co-rank round probes `probes` candidates, and
# K8's grid has at most `grid` CTAs
CASES = {
    # N = K + M at, one below and one above three tiles of 8
    "tile_edges_at": (dict(seed=1, L=5, K=12, NR=3, NW=3), (4, 2, 2, 9)),
    "tile_edges_below": (dict(seed=2, L=5, K=11, NR=3, NW=3), (4, 2, 2, 9)),
    "tile_edges_above": (dict(seed=3, L=5, K=13, NR=3, NW=3),
                         (4, 2, 2, 9)),
    # runs of 3 that straddle the endpoints' edges, and runs of 1
    "odd_runs": (dict(seed=4, L=7, K=200, NR=40, NW=31), (8, 3, 3, 2)),
    "runs_of_one": (dict(seed=5, L=5, K=90, NR=20, NW=17), (2, 1, 1, 3)),
    # a long padding tail: most tiles hold only state
    "state_only_tiles": (dict(seed=6, L=7, K=900, NR=6, NW=5, live=150,
                              pad_ends=0.0), (4, 4, 2, 9)),
    # a tiny state: most tiles hold only endpoints
    "endpoint_only_tiles": (dict(seed=7, L=5, K=3, NR=90, NW=80),
                            (4, 2, 2, 5)),
    # every endpoint a state key, live or padding, in every class
    "ends_equal_state_keys": (dict(seed=8, L=7, K=300, NR=60, NW=60,
                                   live=200, ends_from_state=True),
                              (4, 8, 4, 9)),
    "all_equal_keys": (dict(seed=9, L=7, K=100, NR=70, NW=50, values=1,
                            pad_ends=0.0), (4, 2, 2, 9)),
    "L2": (dict(seed=10, L=2, K=150, NR=45, NW=30), (8, 2, 2, 9)),
    "L5": (dict(seed=11, L=5, K=150, NR=45, NW=30), (8, 2, 2, 9)),
    "L7": (dict(seed=12, L=7, K=150, NR=45, NW=30), (8, 2, 2, 9)),
    "M0": (dict(seed=13, L=5, K=77, NR=0, NW=0), (4, 2, 2, 9)),
    "M1024": (dict(seed=14, L=5, K=700, NR=256, NW=256, values=5),
              (16, 8, 4, 9)),
    # a co-rank interval far wider than a round's probes: several rounds
    "many_rounds": (dict(seed=15, L=3, K=1500, NR=300, NW=200, values=9),
                    (2, 2, 1, 9)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_kernels_equal_the_plain_merge_and_ranks(case):
    inputs, (threads, run, probes, grid) = CASES[case]
    bkeys, bval, rb, re, wb, we = make_inputs(**inputs)
    NR = rb.shape[1]
    ekeys, eidx = ref.endpoint_sort(rb, re, wb, we)
    want = ref.state_merge(bkeys, bval, ekeys, eidx, NR)
    got, rounds = emulate_merge(bkeys.numpy(), bval.numpy(), ekeys.numpy(),
                                eidx.numpy(), NR, threads, run, probes)
    names = ("skeys", "scls", "sval", "sidx", "spos", "cum_state")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    if case == "many_rounds":
        assert rounds >= 3
    if ekeys.shape[1]:
        np.testing.assert_array_equal(
            emulate_ranks(ekeys.numpy(), eidx.numpy(), threads, run, grid),
            ref.endpoint_ranks(ekeys, eidx).numpy(), err_msg="qranks")


def test_emulation_with_the_kernels_constants():
    # SM_THREADS, SM_MAX_RUN and SM_PROBES of K7 and RANK_THREADS and
    # RANK_RUN of K8 as compiled: two K7 tiles of 2,048 and a short third,
    # co-ranks over M = 1,024 endpoints found in two rounds (32 probes a
    # round cover 32^2 candidates in two); K8 on two tiles of 512
    threads = source_constant("state_merge.cu", "SM_THREADS")
    run = source_constant("state_merge.cu", "SM_MAX_RUN")
    probes = source_constant("state_merge.cu", "SM_PROBES")
    assert threads * run == 2048 and probes == 32
    rthreads = source_constant("endpoint_ranks.cu", "RANK_THREADS")
    rrun = source_constant("endpoint_ranks.cu", "RANK_RUN")
    # the wrapper sizes K8's `counts` scratch by its tile
    assert rthreads * rrun == kernels.RANK_TILE == 512
    # K7 takes keys up to the engine's widest (64 bytes), and its wrapper
    # refuses wider ones before the kernel would
    assert (source_constant("state_merge.cu", "SM_MAX_LIMBS")
            == kernels.MERGE_MAX_LIMBS
            == ConflictShapes(1, 1, 1, 1, key_bytes=64).limbs)
    bkeys, bval, rb, re, wb, we = make_inputs(16, 5, 4000, 300, 212,
                                              live=3000, values=4)
    NR = rb.shape[1]
    ekeys, eidx = ref.endpoint_sort(rb, re, wb, we)
    got, rounds = emulate_merge(bkeys.numpy(), bval.numpy(), ekeys.numpy(),
                                eidx.numpy(), NR, threads, run, probes)
    for g, w in zip(got, ref.state_merge(bkeys, bval, ekeys, eidx, NR)):
        np.testing.assert_array_equal(g, w.numpy())
    assert rounds <= 2
    np.testing.assert_array_equal(
        emulate_ranks(ekeys.numpy(), eidx.numpy(), rthreads, rrun, 132),
        ref.endpoint_ranks(ekeys, eidx).numpy())


@pytest.mark.parametrize("tiles, grid", [(5, 5), (5, 2), (7, 1)])
def test_emulated_ranks_with_more_tiles_than_ctas(tiles, grid):
    # K8's CTAs loop over tiles when the card cannot hold one a tile; the
    # last tile short, keys with long runs of ties
    rng = np.random.default_rng(tiles * 10 + grid)
    M = tiles * 64 - 5
    keys = np.sort(rng.integers(0, 40, M)).astype(np.int32)
    ekeys = torch.from_numpy(np.stack([np.full(M, 3, np.int32), keys]))
    eidx = torch.from_numpy(rng.permutation(M).astype(np.int32))
    np.testing.assert_array_equal(
        emulate_ranks(ekeys.numpy(), eidx.numpy(), 16, 4, grid),
        ref.endpoint_ranks(ekeys, eidx).numpy())
