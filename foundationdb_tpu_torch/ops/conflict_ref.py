"""The conflict step in plain PyTorch: the parity spine of the port.

Counterpart of foundationdb_tpu/ops/conflict.py:124-799 (`conflict_step`,
`_merge_phase`, `init_state`, `rebase_state`, `_build_table`, `_range_max`,
`_intra_scan_levels`, `_intra_scan_blocked`, `_run_sandwich`,
`_auto_rounds`, `conflict_scan`): the pooled and the strided layouts, and
the `scan` and `legacy` intra-batch evaluators. It is held to the JAX step
exactly (state, statuses and every `info` field) by
tests/test_torch_conflict_ref.py, test_torch_strided_scan.py and
test_torch_legacy.py, and every Hopper kernel of ops/kernels.py is held to
the phase function here that it replaces.

The strided layout is the pooled step with its range->txn maps derived on
the device once per batch (`strided_owners`). The JAX step folds per txn
with reshapes there, because a scatter costs a TPU far more than a
reshape; on the card an atomic-OR fold costs about what a reshape does, so
the same phases and kernels serve both layouts.

The step is written as plain tensor code around eight phase functions,
passed in as `phases` (an object with `sort_and_rank`, `masks_and_history`,
`build_table`, `intra_levels`, `intra_sandwich`, `merge_compact`,
`legacy_fixpoint` and `step_verdicts`); `rebase_state`
calls a ninth, `rebase_table`, and the
sharded engine (parallel/sharded_conflict.py) two more around the step of
each shard, `clip_ranges` and `shard_combine`.
`PLAIN` holds the plain versions below;
ops/kernels.py holds wrappers with the same signatures that launch the CUDA
kernels for CUDA tensors. Nothing here synchronises with the device but the
plain legacy fixpoint (`run_legacy` reads its test on the host once a
body, as the JAX `while_loop` tests on the device): every other
data-dependent choice is a tensor op, so the step with the kernels
enqueues without a host round trip on the card.

Representation (see utils/keys.py): key limbs are int32 holding
u32 ^ 0x80000000, so signed order is the unsigned order of the JAX limbs.
Versions are int32 offsets from the engine's host-side int64 base, with NEG
as "no version". Scalars of the state (nb, oldest, poisoned) and of the
batch (commit_version, advance_floor) are 0-dim tensors on the device.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from foundationdb_tpu_torch.ops.batch import COMMITTED, CONFLICT, TOO_OLD
# NEG ("no version", below any clamped offset) and PAD_LIMB (the padding
# sentinel 0xFFFFFFFF, sign-flipped) live with the torch-free encoder
from foundationdb_tpu_torch.ops.encode_np import NEG, PAD_LIMB  # noqa: F401
from foundationdb_tpu_torch.utils import keys as keylib

EMPTY_LIMB = -(1 << 31)  # encode(b"") limbs (all zero), sign-flipped

_I32 = torch.int32


def table_levels(K: int) -> int:
    """Rows of the sparse table: ceil(log2 K) + 1 (at least 1)."""
    return max(1, (max(K, 2) - 1).bit_length() + 1)


def auto_rounds(T: int) -> int:
    """Default sandwich bound (`_auto_rounds`): exact for T <= 64, capped
    at 32 rounds; deeper chains finish on the host (DetectHandle)."""
    return min(T // 2 + 1, 32)


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------

def key_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b lexicographically over the limb axis; a, b are (L, ...)."""
    lt = torch.zeros(a.shape[1:], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[1:], dtype=torch.bool, device=a.device)
    for i in range(a.shape[0]):
        lt = lt | (eq & (a[i] < b[i]))
        eq = eq & (a[i] == b[i])
    return lt


def key_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def _cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.cumsum(x.to(_I32), dim=dim, dtype=_I32)


def _cummax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.cummax(x, dim=dim).values


def carry_last_flagged(values: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """At each position, `values` at the latest flagged position at-or-
    before it, or values[0] if there is none (`_carry_last_flagged`)."""
    idx = torch.arange(values.shape[-1], device=values.device)
    return values[_cummax(torch.where(flags, idx, 0))]


def carry_next_flagged(values: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """At each position, `values` at the earliest flagged position at-or-
    after it, or values[-1] if there is none (the flipped carry)."""
    n = values.shape[-1]
    idx = torch.arange(n, device=values.device)
    last = torch.flip(torch.cummin(torch.flip(
        torch.where(flags, idx, n - 1), [0]), dim=0).values, [0])
    return values[last]


def seg_cummax(vals: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
    """Running max along the last axis restarting wherever reset is True
    (`_seg_cummax`). vals >= -1. Each segment is lifted above every earlier
    one, so one plain cummax does it."""
    seg = torch.cumsum(reset.to(torch.int64), dim=-1)
    lifted = seg * (1 << 32) + (vals.to(torch.int64) + 1)
    return (_cummax(lifted) - seg * (1 << 32) - 1).to(_I32)


def fold_any(flags: torch.Tensor, owner: torch.Tensor, T: int) -> torch.Tensor:
    """(T,) bool: any flag among the slots of each owner (owner T = padding,
    dropped) — the `zeros(T + 1).at[owner].max(flags)[:T]` fold."""
    acc = torch.zeros(T + 1, dtype=_I32, device=flags.device)
    acc.scatter_reduce_(0, owner.to(torch.int64), flags.to(_I32), "amax")
    return acc[:T] > 0


def floor_log2(w: torch.Tensor) -> torch.Tensor:
    """Exact floor(log2 w) for w >= 1 (the `31 - clz(w)` of the JAX step)."""
    _mant, exp = torch.frexp(w.to(torch.float64))
    return (exp - 1).to(torch.int64)


# ---------------------------------------------------------------------------
# the phases, plain versions (each Hopper kernel is held to one)
# ---------------------------------------------------------------------------

def build_table(vals: torch.Tensor, out=None) -> torch.Tensor:
    """(K,) int32 -> (LEVELS, K) window maxima `_build_table`:
    table[l, i] = max(vals[i : i + 2**l]), NEG past K. With `out`, the
    table is written there and `out` returned."""
    if out is not None:
        return out.copy_(build_table(vals))
    K = vals.shape[0]
    rows = [vals]
    cur = vals
    for lvl in range(1, table_levels(K)):
        shift = 1 << (lvl - 1)
        pad = torch.full((min(shift, K),), NEG, dtype=vals.dtype,
                         device=vals.device)
        cur = torch.maximum(cur, torch.cat([cur[shift:], pad])[:K])
        rows.append(cur)
    return torch.stack(rows)


def range_max(table: torch.Tensor, i0: torch.Tensor, i1: torch.Tensor):
    """max(vals[i0:i1]) for i0 < i1, from the sparse table (`_range_max`)."""
    w = torch.clamp(i1 - i0, min=1)
    lvl = floor_log2(w)
    i0l = i0.to(torch.int64)
    right = torch.maximum(i1.to(torch.int64) - (torch.ones_like(lvl) << lvl),
                          i0l)
    return torch.maximum(table[lvl, i0l], table[lvl, right])


def history_check(table, cum_state, spos, rb, re, rtxn, snapshot, txn_valid,
                  oldest, skip_history: bool = False):
    """Too-old and history verdicts per txn (conflict.py:423-444).

    Each read's segment range comes from the sorted positions of its
    endpoints (`spos`, state elements counted by `cum_state`); the range
    max of the step function is compared with the txn's snapshot and the
    hits fold to their txn. Returns (too_old, g0) with
    g0 = txn_valid & ~too_old & ~hist_conflict. With `skip_history` (the
    `no_hist` and `only_merge` ablations) no read hits: too_old is still
    computed."""
    K = table.shape[1]
    NR = rb.shape[1]
    T = snapshot.shape[0]
    rvalid = rtxn < T
    has_reads = fold_any(rvalid, rtxn, T)
    too_old = txn_valid & has_reads & (snapshot < oldest)
    if skip_history:
        return too_old, txn_valid & ~too_old
    ub_rb = cum_state[spos[K:K + NR].to(torch.int64)]
    lb_re = cum_state[spos[K + NR:K + 2 * NR].to(torch.int64)]
    i0 = torch.clamp(ub_rb - 1, min=0)
    maxver = range_max(table, i0, torch.maximum(lb_re, i0 + 1))
    rsnap = snapshot[torch.clamp(rtxn, max=T - 1).to(torch.int64)]
    read_hits = rvalid & key_lt(rb, re) & (maxver > rsnap)
    hist = fold_any(read_hits, rtxn, T)
    return too_old, txn_valid & ~too_old & ~hist


def intra_sweep(c, g, geo, wtxn_c, w_ok, r_ok, rtxn, rbr, skip=None,
                prev=None):
    """One evaluation of the antitone map f of the sandwich
    (`_f_commit` over `_intra_scan_blocked`, conflict.py:295-308, 537-541):
    f(c)[t] = g[t] and no write of an EARLIER txn committed in c overlaps
    any of t's reads. All levels at once: case A is a masked prefix sum
    between a read's two query positions, case B a block-segmented running
    max of committed write-end ranks at its first query position.

    With `skip` (a 0-dim bool tensor) set, returns `prev` instead — the
    round-skip of `lax.cond` once the sandwich has pinched."""
    T = g.shape[0]
    wl = wtxn_c.to(torch.int64)
    cw = c[wl] & w_ok
    cm = geo["is_w"] & cw[geo["src"].to(torch.int64)]
    pref = _cumsum(cm, dim=1)
    qlo = geo["qlo"].to(torch.int64)
    qhi = geo["qhi"].to(torch.int64)
    count_a = torch.gather(pref, 1, qhi) - torch.gather(pref, 1, qlo)
    segmax = seg_cummax(torch.where(cm, geo["werl"], -1), geo["bnd"])
    blocked = ((count_a > 0)
               | (torch.gather(segmax, 1, qlo) > rbr[None, :])).any(dim=0)
    out = g & ~fold_any(blocked & r_ok, rtxn, T)
    if skip is not None:
        out = torch.where(skip, prev, out)
    return out


def merge_compact(skeys, scls, sval, sidx, spos, merge_commit, wb, we, wtxn,
                  nb, oldest, poisoned, vnew, advance_floor, *, K: int,
                  max_write_life: int, out=None):
    """Merge the committed writes into the step function at vnew, clamp to
    the new MVCC floor, coalesce and compact to K slots (`_merge_phase`,
    conflict.py:589-704). Overflow poisons the state (sticky), never
    truncates it.

    Returns (keys (L,K), vals (K,), nb, oldest, poisoned, boundaries).
    With `out` = (keys, vals), those two are written there: the state's
    own buffers may be given, since the phase reads the sorted union, not
    the state's keys or values."""
    if out is not None:
        keys, vals, *rest = merge_compact(
            skeys, scls, sval, sidx, spos, merge_commit, wb, we, wtxn, nb,
            oldest, poisoned, vnew, advance_floor, K=K,
            max_write_life=max_write_life)
        return (out[0].copy_(keys), out[1].copy_(vals), *rest)
    L, N = skeys.shape
    NW = wb.shape[1]
    NR = (N - K - 2 * NW) // 2
    T = merge_commit.shape[0]
    dev = skeys.device
    wvalid = wtxn < T
    commit_w = merge_commit[torch.clamp(wtxn, max=T - 1).to(torch.int64)]
    cw = (wvalid & commit_w & key_lt(wb, we)).to(_I32)
    delta = torch.zeros(N, dtype=_I32, device=dev)
    delta.scatter_(0, spos[K + 2 * NR:].to(torch.int64), torch.cat([cw, -cw]))

    live_state = (scls == 1) & (sidx < nb)
    is_src = live_state | (delta != 0)
    newgrp = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        ~key_eq(skeys[:, 1:], skeys[:, :-1])])
    src_i = is_src.to(_I32)
    cum_src_excl = _cumsum(src_i) - src_i
    grp_start = _cummax(torch.where(newgrp, cum_src_excl, -1))
    rep = is_src & (cum_src_excl == grp_start)

    val_u = carry_last_flagged(torch.where(live_state, sval, NEG), live_state)
    grp_last = torch.cat([newgrp[1:],
                          torch.ones(1, dtype=torch.bool, device=dev)])
    cover = carry_next_flagged(torch.where(grp_last, _cumsum(delta), 0),
                               grp_last) > 0
    newval = torch.where(cover, torch.maximum(val_u, vnew), val_u)
    floor = torch.where(advance_floor, vnew - max_write_life, oldest)
    new_oldest = torch.maximum(oldest, floor)
    newval = torch.maximum(newval, new_oldest)

    cum_rep = _cumsum(rep)
    carried = carry_last_flagged(torch.where(rep, newval, NEG), rep)
    prev_rep_val = torch.cat([torch.full((1,), NEG, dtype=_I32, device=dev),
                              carried[:-1]])
    keep = rep & ((cum_rep == 1) | (newval != prev_rep_val))
    n2 = keep.sum(dtype=_I32)
    cpos = _cumsum(keep) - 1
    cpos = torch.where(keep, torch.clamp(cpos, max=K - 1), K).to(torch.int64)
    csrc = torch.full((K + 1,), -1, dtype=torch.int64, device=dev)
    csrc.scatter_(0, cpos, torch.arange(N, device=dev))
    csrc = csrc[:K]
    kept = csrc >= 0
    csrc_c = torch.clamp(csrc, 0, N - 1)
    out_keys = torch.where(kept[None, :], skeys[:, csrc_c], PAD_LIMB)
    out_vals = torch.where(kept, newval[csrc_c], NEG)

    poisoned2 = poisoned | (n2 > K)
    pois_keys = torch.full((L, K), PAD_LIMB, dtype=_I32, device=dev)
    pois_keys[:, 0] = EMPTY_LIMB
    pois_vals = torch.full((K,), NEG, dtype=_I32, device=dev)
    pois_vals[0] = vnew
    out_keys = torch.where(poisoned2, pois_keys, out_keys)
    out_vals = torch.where(poisoned2, pois_vals, out_vals)
    n2 = torch.where(poisoned2, 1, n2).to(_I32)
    return (out_keys, out_vals, torch.clamp(n2, max=K), new_oldest.to(_I32),
            poisoned2, n2)


def legacy_sweep(c, g, wtxn, rtxn, w_ok, r_ok, wbr, wer, rbr, rer):
    """One evaluation of the legacy evaluator's map f (`_f_commit` over the
    dense overlap matrix, conflict.py:491-514): f(c)[t] = g[t] and no write
    of an EARLIER txn committed in c overlaps any of t's reads. Like the
    JAX step it materialises the (NW, NR) overlap matrix, here with bool
    ops (torch has no integer matrix-vector product on CUDA)."""
    T = g.shape[0]
    overlap = ((wbr[:, None] < rer[None, :]) & (rbr[None, :] < wer[:, None])
               & w_ok[:, None] & r_ok[None, :]
               & (wtxn[:, None] < rtxn[None, :]))
    cw = c[torch.clamp(wtxn, max=T - 1).to(torch.int64)] & (wtxn < T)
    blocked = (overlap & cw[:, None]).any(dim=0)
    return g & ~fold_any(blocked, rtxn, T)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def lex_sort_perm(limbs: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """Permutation sorting columns by (limb 0, ..., limb L-1, cls).

    Two 32-bit fields pack into one int64 key, order-preserving; the keys
    are sorted least-significant first with stable sorts (radix order), so
    L=7 limbs + class cost four `torch.sort`s of N elements."""
    fields = list(limbs) + [cls]
    if len(fields) % 2:
        fields.append(torch.zeros_like(cls))
    perm = None
    for i in range(len(fields) - 2, -1, -2):
        key = ((fields[i].to(torch.int64) << 32)
               + (fields[i + 1].to(torch.int64) + (1 << 31)))
        if perm is not None:
            key = key[perm]
        order = torch.sort(key, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def sort_and_rank(bkeys, bval, rb, re, wb, we):
    """Phase 0 and the endpoint ranks of the step (conflict.py:397-421,
    455-476): the stable sort of [state | rb | re | wb | we] by (limbs,
    class), class tiebreak at equal keys re(0) < state(1) < rb/wb/we(2),
    then the original index. Returns (skeys (L,N), scls, sval, sidx, spos,
    cum_state, qranks): sorted keys, classes, state values (NEG for
    endpoints) and original indices; the sorted position of each element;
    the inclusive count of state elements; and the dense rank of each
    endpoint's key among the 2NR+2NW endpoint keys, (2NR+2NW,) int32."""
    L, K = bkeys.shape
    NR, NW = rb.shape[1], wb.shape[1]
    dev = bkeys.device
    N = K + 2 * NR + 2 * NW
    allk = torch.cat([bkeys, rb, re, wb, we], dim=1)
    cls = torch.cat([
        torch.ones(K, dtype=_I32, device=dev),
        torch.full((NR,), 2, dtype=_I32, device=dev),
        torch.zeros(NR, dtype=_I32, device=dev),
        torch.full((2 * NW,), 2, dtype=_I32, device=dev)])
    vpay = torch.cat([bval, torch.full((2 * NR + 2 * NW,), NEG, dtype=_I32,
                                       device=dev)])
    perm = lex_sort_perm(allk, cls)
    skeys = allk[:, perm].contiguous()
    scls = cls[perm]
    sval = vpay[perm]
    sidx = perm.to(_I32)
    spos = torch.empty(N, dtype=_I32, device=dev)
    spos.scatter_(0, perm, torch.arange(N, dtype=_I32, device=dev))
    is_state = scls == 1
    cum_state = _cumsum(is_state)

    # rank = distinct endpoint key groups at-or-before an element; state
    # elements interleave but contribute no rank
    is_b = (~is_state).to(_I32)
    newgrp = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        ~key_eq(skeys[:, 1:], skeys[:, :-1])])
    cum_b_excl = _cumsum(is_b) - is_b
    first_b = (is_b > 0) & (cum_b_excl == _cummax(
        torch.where(newgrp, cum_b_excl, -1)))
    rank_carried = _cummax(torch.where(first_b, _cumsum(first_b) - 1, -1))
    qranks = rank_carried[spos[K:].to(torch.int64)]
    return skeys, scls, sval, sidx, spos, cum_state, qranks


# The phase in three parts, as its kernels K6-K8 compute it: the state
# keys arrive sorted, so only the endpoints are sorted and then merged in.
# `sort_and_rank_parts` equals `sort_and_rank` output for output.

def endpoint_classes(NR: int, NW: int, device) -> torch.Tensor:
    """Class of each endpoint of [rb | re | wb | we] at equal keys: re 0,
    the rest 2 (a state element's is 1)."""
    cls = torch.full((2 * NR + 2 * NW,), 2, dtype=_I32, device=device)
    cls[NR:2 * NR] = 0
    return cls


def endpoint_sort(rb, re, wb, we):
    """K6's plain version: the endpoints [rb | re | wb | we] sorted by
    (limbs, class, index): (keys (L, M), idx (M,) int32, each sorted
    element's endpoint index j), M = 2NR + 2NW."""
    ekeys = torch.cat([rb, re, wb, we], dim=1)
    perm = lex_sort_perm(ekeys, endpoint_classes(rb.shape[1], wb.shape[1],
                                                 rb.device))
    return ekeys[:, perm].contiguous(), perm.to(_I32)


def endpoint_ranks(ekeys, eidx):
    """K8's plain version: from the sorted endpoints, the dense rank of
    each endpoint's key among all endpoint keys (limbs only, not the
    class), written at its endpoint index: (M,) int32."""
    M = eidx.shape[0]
    newkey = torch.cat([torch.ones(min(M, 1), dtype=torch.bool,
                                   device=ekeys.device),
                        ~key_eq(ekeys[:, 1:], ekeys[:, :-1])])
    qranks = torch.empty(M, dtype=_I32, device=ekeys.device)
    qranks.scatter_(0, eidx.to(torch.int64), _cumsum(newkey) - 1)
    return qranks


def state_merge(bkeys, bval, ekeys, eidx, NR: int):
    """K7's plain version: the sorted endpoints merged into the sorted
    state in the order of `sort_and_rank` (a state element before an
    equal-keyed endpoint of class 2, after one of class 0). Returns
    (skeys, scls, sval, sidx, spos, cum_state) as `sort_and_rank` does."""
    L, K = bkeys.shape
    M = eidx.shape[0]
    N = K + M
    dev = bkeys.device
    ecls = endpoint_classes(NR, (M - 2 * NR) // 2, dev)[eidx.to(torch.int64)]
    allk = torch.cat([bkeys, ekeys], dim=1)
    cls = torch.cat([torch.ones(K, dtype=_I32, device=dev), ecls])
    perm = lex_sort_perm(allk, cls)
    from_state = perm < K
    # one spare id, so that the gather is in range when M is 0
    ids = torch.cat([eidx.to(torch.int64),
                     torch.zeros(1, dtype=torch.int64, device=dev)])
    sidx = torch.where(from_state, perm, K + ids[(perm - K).clamp(min=0)])
    sval = torch.where(from_state, bval[perm.clamp(max=K - 1)], NEG)
    spos = torch.empty(N, dtype=_I32, device=dev)
    spos.scatter_(0, sidx, torch.arange(N, dtype=_I32, device=dev))
    return (allk[:, perm].contiguous(), cls[perm], sval.to(_I32),
            sidx.to(_I32), spos, _cumsum(from_state))


def sort_and_rank_parts(bkeys, bval, rb, re, wb, we, parts=None):
    """`sort_and_rank` through its three parts (an object with
    `endpoint_sort`, `endpoint_ranks` and `state_merge`; the plain ones by
    default)."""
    parts = parts or SimpleNamespace(endpoint_sort=endpoint_sort,
                                     endpoint_ranks=endpoint_ranks,
                                     state_merge=state_merge)
    ekeys, eidx = parts.endpoint_sort(rb, re, wb, we)
    qranks = parts.endpoint_ranks(ekeys, eidx)
    return (*parts.state_merge(bkeys, bval, ekeys, eidx, rb.shape[1]),
            qranks)


def level_sort_keys(T, wtxn_c, rtxn, rbr, rer, wbr, wer) -> torch.Tensor:
    """The keys `intra_levels` sorts, (n_levels, M) int64: (block + 1,
    rank, class + 1) packed into 24, 38 and 2 bits, for the elements
    [writes | lo queries | hi queries]."""
    NW, NR = wbr.shape[0], rbr.shape[0]
    dev = wbr.device
    n_levels = max(1, int(T - 1).bit_length())
    shift = torch.arange(n_levels, device=dev, dtype=torch.int64)[:, None]
    rt = rtxn.to(torch.int64)[None, :] >> shift
    key1 = torch.cat([wtxn_c.to(torch.int64)[None, :] >> shift, rt - 1, rt - 1],
                     dim=1)
    key2 = torch.cat([wbr, rbr, rer]).to(torch.int64)
    cls = torch.cat([torch.zeros(NW, dtype=torch.int64, device=dev),
                     torch.ones(NR, dtype=torch.int64, device=dev),
                     torch.full((NR,), -1, dtype=torch.int64, device=dev)])
    return ((key1 + 1) << 40) | (key2 << 2)[None, :] | (cls + 1)[None, :]


def intra_levels(T, wtxn_c, rtxn, rbr, rer, wbr, wer) -> dict:
    """Sweep-invariant geometry of the scan evaluator (`_intra_scan_levels`,
    conflict.py:243-292), every level in one 2-D sort: level l orders writes
    by (wtxn >> l, rank) and places each read's two query elements in block
    (rtxn >> l) - 1, class hi-query(-1) < write(0) < lo-query(1) at equal
    (block, rank). The three keys pack into one int64, and the sort is
    stable, so the order is total: (block, rank, class, element index),
    with element i a write i < NW, a lo query NW + j, a hi query
    NW + NR + j. (`lax.sort` leaves the order of equal keys unspecified;
    the sandwich's outputs do not depend on it, K9's fields do.) Owners
    lie in [0, T - 1] (writes) and [0, T] (reads, T = padding), in any
    order. Returns {src, is_w, werl, bnd: (n_levels, M); qlo, qhi:
    (n_levels, NR)}, M = NW + 2 NR, n_levels = max(1, bit_length(T - 1))."""
    NW, NR = wbr.shape[0], rbr.shape[0]
    M = NW + 2 * NR
    dev = wbr.device
    packed = level_sort_keys(T, wtxn_c, rtxn, rbr, rer, wbr, wer)
    n_levels = packed.shape[0]
    s, si = torch.sort(packed, dim=1, stable=True)
    inv = torch.empty_like(si)
    inv.scatter_(1, si, torch.arange(M, device=dev).expand(n_levels, M))
    is_w = si < NW
    src = torch.clamp(si, max=NW - 1)
    werl = torch.where(is_w, wer.to(torch.int64)[src], -1)
    s1 = s >> 40
    bnd = torch.cat([torch.ones(n_levels, 1, dtype=torch.bool, device=dev),
                     s1[:, 1:] != s1[:, :-1]], dim=1)
    return {"src": src.to(_I32).contiguous(), "is_w": is_w.contiguous(),
            "werl": werl.to(_I32).contiguous(), "bnd": bnd.contiguous(),
            "qlo": inv[:, NW:NW + NR].to(_I32).contiguous(),
            "qhi": inv[:, NW + NR:].to(_I32).contiguous()}


def run_sandwich(sweep, g, rounds: int, read_pinch: bool = False):
    """Bounded lower/upper sandwich on the antitone map f (`_run_sandwich`):
    upper ⊇ truth ⊇ lower; each round tightens both and is skipped once they
    meet. The skip is a device flag handed to `sweep`, not a host branch;
    with `read_pinch` the loop also reads a CUDA flag on the host (a sync a
    round) and stops at the pinch, as it always does on the CPU: the
    rounds it leaves out would change nothing. Returns (lower, upper,
    converged)."""
    upper = g
    lower = sweep(upper, None, None)
    for _ in range(max(rounds, 0)):
        pinched = torch.all(lower == upper)
        if (read_pinch or not pinched.is_cuda) and bool(pinched):
            break  # the flag is read on the host; same result
        up2 = sweep(lower, pinched, upper)
        lower = sweep(up2, pinched, lower)
        upper = up2
    return lower, upper, torch.all(lower == upper)


def intra_sandwich(g, geo, wtxn_c, w_ok, r_ok, rtxn, rbr, rounds: int,
                   evals=None):
    """The scan evaluator's sandwich (`_run_sandwich` over `_f_commit`,
    conflict.py:311-334, 537-548): `run_sandwich` over `intra_sweep`.
    Returns (lower, upper, converged). With `evals` (a 0-dim int32 tensor)
    it also writes how many evaluations of f were not skipped, the count
    the kernel reports; it then reads the pinch flags on the host, and so
    stops at the pinch on the card too."""
    skips = []

    def sweep(c, skip, prev):
        if evals is not None:
            skips.append(skip)
        return intra_sweep(c, g, geo, wtxn_c, w_ok, r_ok, rtxn, rbr, skip,
                           prev)
    out = run_sandwich(sweep, g, rounds, read_pinch=evals is not None)
    if evals is not None:
        evals.fill_(sum(1 for s in skips if s is None or not bool(s)))
    return out


def rebase_table(bval, oldest, delta: int):
    """Shift the version offsets down by `delta` (0 <= delta <= 2^30),
    saturating at NEG, and build the table of the shifted values
    (`rebase_state`): (bval', oldest', table)."""
    bval2 = torch.clamp(bval - delta, min=NEG)
    return bval2, torch.clamp(oldest - delta, min=NEG), build_table(bval2)


def clip_ranges(rb, re, wb, we, lo, hi, out=None):
    """K10's plain version: every range clipped to every shard's key range
    (`_clip_ranges`, parallel/sharded_conflict.py:111-121, once per shard):
    begin' = lo if begin < lo else begin, end' = hi if hi < end else end,
    lexicographic over the limbs. rb, re (L, NR) and wb, we (L, NW); lo, hi
    (W, L). Returns four (W, L, N) tensors, shard d's slice [d] contiguous.
    A range the shard does not own comes out empty or inverted, and every
    phase of the step ignores it. With `out` (four such tensors) the
    result is written there and `out` returned."""
    W = lo.shape[0]

    def clip(keys, bound, begin):
        k = keys.unsqueeze(0).expand(W, -1, -1)  # (W, L, N)
        b = bound.unsqueeze(2).expand_as(k)
        kt, bt = k.transpose(0, 1), b.transpose(0, 1)  # limbs first
        take = key_lt(kt, bt) if begin else key_lt(bt, kt)  # (W, N)
        return torch.where(take[:, None, :], b, k).contiguous()
    got = (clip(rb, lo, True), clip(re, hi, False), clip(wb, lo, True),
           clip(we, hi, False))
    if out is None:
        return got
    for o, g in zip(out, got):
        o.copy_(g)
    return tuple(out)


def shard_combine(statuses, eligible, overflow, boundaries, converged,
                  txn_valid):
    """K11's plain version: the combine of `local_step`
    (parallel/sharded_conflict.py:193-210) over the W shards' outputs (each
    argument but txn_valid a sequence of W tensors): statuses min over the
    shards (Conflict 0 < TooOld 1 < Committed 2, the proxy's rule), eligible
    and converged all, overflow any, boundaries max, and committed the
    count of committed valid txns. Returns (statuses, info, row): row
    the engine's (2T+2,) int32 readback row [statuses | eligible |
    overflow | converged] (`_combine_fn`, as `step_verdicts` writes it for
    one device), statuses a view of its head."""
    st = torch.stack(list(statuses)).amin(dim=0).to(_I32)
    info = {"overflow": torch.stack(list(overflow)).any(),
            "boundaries": torch.stack(list(boundaries)).amax(),
            "committed": ((st == COMMITTED) & txn_valid).sum(dtype=_I32),
            "converged": torch.stack(list(converged)).all(),
            "eligible": torch.stack(list(eligible)).all(dim=0)}
    row = torch.cat([st, info["eligible"].to(_I32),
                     info["overflow"].to(_I32).reshape(1),
                     info["converged"].to(_I32).reshape(1)])
    return row[:st.shape[0]], info, row


def strided_owners(begins: torch.Tensor, T: int) -> torch.Tensor:
    """The strided layout's range->txn map (conflict.py:385-391, 436-442,
    486-489, 601-605): slot j of NS belongs to txn j // (NS // T), or to T
    (padding) when its begin key carries the padding length limb. Real
    keys never carry it, so an empty real range still belongs to its txn."""
    L, NS = begins.shape
    owner = torch.arange(NS, dtype=_I32, device=begins.device) // (NS // T)
    return torch.where(begins[L - 1] != PAD_LIMB, owner, T).to(_I32)


def step_masks(rb, wb, rtxn, wtxn, rbr, rer, wbr, wer, T: int,
               strided: bool):
    """The first part of K2's plain version: the range->txn maps and the
    masks of the intra-batch phase (conflict.py:385-395, 477-489): (rtxn,
    wtxn, wtxn_c, r_ok, w_ok). In the strided layout the maps come from
    the keys (`strided_owners`; the batch's rtxn/wtxn are not read), else
    they are the batch's. wtxn_c = min(wtxn, T - 1); a range is ok when it is real
    (owner < T) and not empty or inverted (begin rank < end rank)."""
    if strided:
        rtxn, wtxn = strided_owners(rb, T), strided_owners(wb, T)
    return (rtxn, wtxn, torch.clamp(wtxn, max=T - 1),
            (rtxn < T) & (rbr < rer), (wtxn < T) & (wbr < wer))


def masks_and_history(table, cum_state, spos, rb, re, wb, rtxn, wtxn, rbr,
                      rer, wbr, wer, snapshot, txn_valid, oldest,
                      strided: bool = False, skip_history: bool = False):
    """K2's plain version: `step_masks`, then `history_check` with the
    owners it gives, as the phase's two parts (the kernel does both in one
    launch). Returns (rtxn, wtxn, wtxn_c, r_ok, w_ok, too_old, g0)."""
    owners = step_masks(rb, wb, rtxn, wtxn, rbr, rer, wbr, wer,
                        snapshot.shape[0], strided)
    return (*owners, *history_check(table, cum_state, spos, rb, re,
                                    owners[0], snapshot, txn_valid, oldest,
                                    skip_history))


def step_verdicts(commit, too_old, txn_valid, eligible, overflow, converged,
                  scan_out=None, index: int = 0):
    """K13's plain version: the verdicts of a step (conflict.py:545-553)
    and the readback row of `_combine_fn` (:1190-1198). Returns
    (statuses (T,) int32, committed () int32, row (2T+2,) int32): row =
    [statuses | eligible | overflow | converged], statuses a view of its
    head; a txn that is not valid reads Committed. With `scan_out` =
    (statuses (M, T) int8, committed (M,) int32, overflow (M,) bool),
    entry `index` of each is written too: the outputs of
    `conflict_scan`."""
    T = commit.shape[0]
    st = torch.where(commit, COMMITTED,
                     torch.where(too_old, TOO_OLD, CONFLICT))
    st = torch.where(txn_valid, st, COMMITTED).to(_I32)
    row = torch.cat([st, eligible.to(_I32), overflow.to(_I32).reshape(1),
                     converged.to(_I32).reshape(1)])
    committed = commit.sum(dtype=_I32)
    if scan_out is not None:
        scan_out[0][index].copy_(st)
        scan_out[1][index].copy_(committed)
        scan_out[2][index].copy_(overflow)
    return row[:T], committed, row


def run_legacy(sweep, g, max_bodies=None):
    """The legacy evaluator's fixpoint (conflict.py:516-530): one `body`,
    then `body` again while the bounds differ, reading the test on the
    host once per `body`. Unbounded, as the JAX `while_loop` is, it
    returns the committed set (lower == upper). With `max_bodies` it
    returns (lower, converged), stopping after that many bodies."""
    upper = g
    lower = sweep(upper)
    bodies = 0
    while True:
        upper = sweep(lower)
        lower = sweep(upper)
        bodies += 1
        if not bool(torch.any(lower != upper)):
            return lower if max_bodies is None else (lower, True)
        if max_bodies is not None and bodies >= max_bodies:
            return lower, False


def legacy_guard(T: int) -> int:
    """The legacy fixpoint's guard in bodies: more than a monotone map
    needs (after k evaluations the first k txns are exact)."""
    return T // 2 + 2


def legacy_fixpoint(g, wtxn, rtxn, w_ok, r_ok, wbr, wer, rbr, rer,
                    evals=None, max_bodies=None):
    """K5's plain version: the legacy evaluator's fixpoint, `run_legacy`
    over `legacy_sweep`, guarded as the kernel is. Returns (commit (T,)
    bool, converged () bool): converged is False, and commit the last
    lower bound, only if the bounds still differ after `max_bodies`
    bodies (default `legacy_guard(T)`, which a monotone map never
    reaches, so the result is JAX's unbounded loop's). With `evals` (a
    0-dim int32 tensor) the evaluations of f are written there."""
    guard = legacy_guard(g.shape[0]) if max_bodies is None else max_bodies
    if guard < 1:
        raise ValueError(f"legacy_fixpoint: max_bodies={guard}")
    n = [0]

    def sweep(c):
        n[0] += 1
        return legacy_sweep(c, g, wtxn, rtxn, w_ok, r_ok, wbr, wer, rbr, rer)
    commit, converged = run_legacy(sweep, g, guard)
    if evals is not None:
        evals.fill_(n[0])
    return commit, torch.tensor(converged, device=g.device)


PLAIN = SimpleNamespace(sort_and_rank=sort_and_rank,
                        masks_and_history=masks_and_history,
                        build_table=build_table,
                        intra_levels=intra_levels,
                        intra_sandwich=intra_sandwich,
                        merge_compact=merge_compact,
                        legacy_fixpoint=legacy_fixpoint,
                        step_verdicts=step_verdicts,
                        rebase_table=rebase_table, clip_ranges=clip_ranges,
                        shard_combine=shard_combine)


INTRA_MODES = ("scan", "legacy")
# the `ablate` values of the JAX step (conflict.py:346), for the bench's
# per-phase profile: what each leaves out
ABLATE_MODES = ("", "no_hist", "only_merge", "no_intra", "only_hist",
                "no_merge", "no_table")
_NO_HIST = ("no_hist", "only_merge")  # no history hits (too-old stays)
_NO_INTRA = ("no_intra", "only_merge", "only_hist")  # commit = eligible
_NO_MERGE = ("no_merge", "only_hist")  # the state keeps its boundaries


def write_state(out: dict, new: dict) -> dict:
    """The state `new` written into the tensors of `out` (fixed buffers:
    the counterpart of the JAX step's donated state), field by field; a
    field a kernel already wrote in place is not copied. Returns `out`."""
    for k in _STATE_FIELDS:
        if out[k].data_ptr() != new[k].data_ptr():
            out[k].copy_(new[k])
    return out


def conflict_step(state: dict, batch: dict, *, max_write_life: int,
                  intra_rounds: int = 0, intra_mode: str = "scan",
                  strided: bool = False, phases=PLAIN, ablate: str = "",
                  out: dict | None = None, scan_out=None, scan_index: int = 0):
    """(state, batch) -> (state', statuses, info), as the JAX
    `conflict_step`. `strided` selects the strided layout (every txn owns
    NR/T read and NW/T write slots; the batch's rtxn/wtxn are not read),
    `intra_mode` the intra-batch evaluator ("scan" or "legacy"), `ablate`
    one of the JAX step's ablations (`ABLATE_MODES`; "" runs everything).

    state: bkeys (L,K) i32 sorted; bval (K,) i32; nb, oldest () i32;
      table (LEVELS,K) i32; poisoned () bool
    batch: txn_valid (T,) bool; snapshot (T,) i32; rb, re (L,NR) i32;
      rtxn (NR,) i32 (= T for padding); wb, we (L,NW) i32; wtxn (NW,) i32;
      commit_version () i32; advance_floor () bool
    Shapes come from the tensors. Without `out` the new state is new
    tensors and the inputs are not modified; with `out` (a state dict of
    fixed buffers, which may be `state` itself) it is written there, and
    `out` is returned. Every reader of a state field runs before that
    field is written. `info` holds the JAX step's five fields and
    "readback", the (2T+2,) int32 row [statuses | eligible | overflow |
    converged] that the resolver reads back; `scan_out` and `scan_index`
    go to `step_verdicts` (the outputs of `conflict_scan`)."""
    if intra_mode not in INTRA_MODES:
        raise ValueError(f"intra_mode must be one of {INTRA_MODES}, got "
                         f"{intra_mode!r}")
    if ablate not in ABLATE_MODES:
        raise ValueError(f"ablate must be one of {ABLATE_MODES}, got "
                         f"{ablate!r}")
    bkeys, bval, table = state["bkeys"], state["bval"], state["table"]
    rb, re, wb, we = batch["rb"], batch["re"], batch["wb"], batch["we"]
    snapshot, txn_valid = batch["snapshot"], batch["txn_valid"]
    K = bkeys.shape[1]
    NR, NW, T = rb.shape[1], wb.shape[1], snapshot.shape[0]
    dev = bkeys.device

    # ---- 0. the sort of [state | rb | re | wb | we], 3. endpoint ranks ----
    skeys, scls, sval, sidx, spos, cum_state, qranks = phases.sort_and_rank(
        bkeys, bval, rb, re, wb, we)
    rbr, rer = qranks[:NR], qranks[NR:2 * NR]
    wbr, wer = qranks[2 * NR:2 * NR + NW], qranks[2 * NR + NW:]
    # ---- the range->txn maps and the masks (empty/inverted ranges take
    # part in neither side of the intra-batch phase); 1+2. too-old and
    # history check ----
    rtxn, wtxn, wtxn_c, r_ok, w_ok, too_old, g = phases.masks_and_history(
        table, cum_state, spos, rb, re, wb, batch["rtxn"], batch["wtxn"],
        rbr, rer, wbr, wer, snapshot, txn_valid, state["oldest"],
        strided=strided, skip_history=ablate in _NO_HIST)

    # ---- 3. intra-batch: dyadic levels -> sandwich; strict wtxn < rtxn
    # is "earlier txns win" (SkipList.cpp:1139-1152) ----
    if ablate in _NO_INTRA:
        commit = merge_commit = g
        converged = torch.ones((), dtype=torch.bool, device=dev)
    elif intra_mode == "legacy":
        commit, converged = phases.legacy_fixpoint(g, wtxn, rtxn, w_ok, r_ok,
                                                   wbr, wer, rbr, rer)
        merge_commit = commit
    else:
        geo = phases.intra_levels(T, wtxn_c, rtxn, rbr, rer, wbr, wer)
        rounds = intra_rounds if intra_rounds > 0 else auto_rounds(T)
        # statuses come from `lower` (never a false commit), the merge uses
        # `upper` (never a write missing from history)
        commit, merge_commit, converged = phases.intra_sandwich(
            g, geo, wtxn_c, w_ok, r_ok, rtxn, rbr, rounds)

    # ---- 4+5. merge, window GC, compaction; then the table ----
    if ablate in _NO_MERGE:
        # the boundaries stay; only the MVCC floor advances (:579-587)
        oldest = state["oldest"]
        new_state = dict(state, oldest=torch.maximum(oldest, torch.where(
            batch["advance_floor"], batch["commit_version"] - max_write_life,
            oldest)).to(_I32))
        overflow, boundaries = state["poisoned"], state["nb"]
    else:
        kw = {} if out is None else {"out": (out["bkeys"], out["bval"])}
        keys2, vals2, nb2, oldest2, overflow, boundaries = \
            phases.merge_compact(
                skeys, scls, sval, sidx, spos, merge_commit, wb, we, wtxn,
                state["nb"], state["oldest"], state["poisoned"],
                batch["commit_version"], batch["advance_floor"], K=K,
                max_write_life=max_write_life, **kw)
        if ablate == "no_table":  # the merge runs, the old table stays
            table2 = table
        else:
            table2 = phases.build_table(
                vals2, **({} if out is None else {"out": out["table"]}))
        new_state = {"bkeys": keys2, "bval": vals2, "nb": nb2,
                     "oldest": oldest2, "table": table2, "poisoned": overflow}
    if out is not None:
        new_state = write_state(out, new_state)

    statuses, committed, row = phases.step_verdicts(
        commit, too_old, txn_valid, g, overflow, converged,
        **({} if scan_out is None else {"scan_out": scan_out,
                                        "index": scan_index}))
    info = {"overflow": overflow, "boundaries": boundaries,
            "committed": committed, "converged": converged, "eligible": g,
            "readback": row}
    return new_state, statuses, info


def conflict_scan(state: dict, stacked: dict, *, max_write_life: int,
                  intra_rounds: int = 0, intra_mode: str = "scan",
                  strided: bool = False, phases=PLAIN, ablate: str = "",
                  out: dict | None = None):
    """M batches in order (`conflict_scan`, conflict.py:771-790): `stacked`
    holds a step's batch fields with a leading batch axis. The steps are
    enqueued back to back with no host sync (for the scan evaluator), each
    writing its verdicts into row i of the outputs; with `out` the last
    step writes the final state there. Returns (state', statuses (M, T)
    int8, committed (M,) int32, overflow (M,) bool)."""
    M, T = stacked["snapshot"].shape
    dev = state["bval"].device
    scan_out = (torch.empty((M, T), dtype=torch.int8, device=dev),
                torch.empty(M, dtype=_I32, device=dev),
                torch.empty(M, dtype=torch.bool, device=dev))
    for i in range(M):
        state, _st, _info = conflict_step(
            state, {k: v[i] for k, v in stacked.items()},
            max_write_life=max_write_life, intra_rounds=intra_rounds,
            intra_mode=intra_mode, strided=strided, phases=phases,
            ablate=ablate, out=out if i == M - 1 else None,
            scan_out=scan_out, scan_index=i)
    return (state, *scan_out)


def rebase_state(state: dict, delta: int, phases=PLAIN,
                 out: dict | None = None) -> dict:
    """Shift every version offset down by delta (the host rebases its int64
    base), saturating at NEG, and rebuild the table (`rebase_state`). With
    `out` (fixed buffers, may be `state`), the result is written there."""
    bval, oldest, table = phases.rebase_table(state["bval"], state["oldest"],
                                              delta)
    new = dict(state, bval=bval, oldest=oldest, table=table)
    return new if out is None else write_state(out, new)


def init_state(capacity: int, limbs: int, device, oldest: int = 0,
               phases=PLAIN, out: dict | None = None) -> dict:
    """Empty state: segment 0 starts at b"" with no version. With `out` (a
    state of these shapes) the buffers are filled in place and returned."""
    if out is None:
        keys = torch.full((limbs, capacity), PAD_LIMB, dtype=_I32,
                          device=device)
        keys[:, 0] = EMPTY_LIMB
        bval = torch.full((capacity,), NEG, dtype=_I32, device=device)
        return {"bkeys": keys, "bval": bval,
                "nb": torch.tensor(1, dtype=_I32, device=device),
                "oldest": torch.tensor(oldest, dtype=_I32, device=device),
                "table": phases.build_table(bval),
                "poisoned": torch.tensor(False, device=device)}
    out["bkeys"].fill_(PAD_LIMB)
    out["bkeys"][:, 0] = EMPTY_LIMB
    out["bval"].fill_(NEG)
    out["nb"].fill_(1)
    out["oldest"].fill_(oldest)
    out["poisoned"].fill_(False)
    phases.build_table(out["bval"], out=out["table"])
    return out


# ---------------------------------------------------------------------------
# carrying state and batches over from the JAX package's numpy layout
# ---------------------------------------------------------------------------

_LIMB_FIELDS = ("bkeys", "rb", "re", "wb", "we")


def _from_np(name, value, device):
    a = np.asarray(value)
    if name in _LIMB_FIELDS:
        a = keylib.to_signed_limbs(a)
    elif a.dtype == np.uint32:
        raise ValueError(f"{name}: unexpected uint32 field")
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


_STATE_FIELDS = ("bkeys", "bval", "nb", "oldest", "table", "poisoned")


def state_from_numpy(np_state: dict, device) -> dict:
    """JAX state dict (bkeys (L,K) uint32, bval, nb, oldest, table,
    poisoned; numpy or anything np.asarray takes) -> the port's tensors."""
    return {k: _from_np(k, np_state[k], device) for k in _STATE_FIELDS}


def batch_from_numpy(np_batch: dict, device) -> dict:
    """JAX pooled-layout batch dict (rb/re/wb/we (L,N) uint32, rtxn, wtxn,
    snapshot, txn_valid, commit_version, advance_floor) -> port tensors."""
    return {k: _from_np(k, np_batch[k], device)
            for k in ("rb", "re", "rtxn", "wb", "we", "wtxn", "snapshot",
                      "txn_valid", "commit_version", "advance_floor")}


def state_to_numpy(state: dict) -> dict:
    """The port's state -> the JAX numpy layout (uint32 key limbs)."""
    out = {}
    for k in _STATE_FIELDS:
        a = state[k].detach().cpu().numpy()
        out[k] = keylib.from_signed_limbs(a) if k == "bkeys" else a
    return out


def sharded_state_from_numpy(np_state: dict, devices) -> dict:
    """The JAX sharded engine's stacked state (every leaf with a leading
    shard axis; lo, hi (W, L) uint32) -> the port's: {"shards": W state
    dicts, shard d's on devices[d]; "lo", "hi": (W, L) int32 on
    devices[0]}."""
    shards = [state_from_numpy({k: np.asarray(np_state[k])[d]
                                for k in _STATE_FIELDS}, dev)
              for d, dev in enumerate(devices)]
    return {"shards": shards,
            **{k: torch.from_numpy(np.ascontiguousarray(keylib.to_signed_limbs(
                np_state[k]))).to(devices[0]) for k in ("lo", "hi")}}


def sharded_state_to_numpy(states: dict) -> dict:
    """The port's sharded state -> the JAX stacked numpy layout."""
    per = [state_to_numpy(s) for s in states["shards"]]
    out = {k: np.stack([p[k] for p in per]) for k in _STATE_FIELDS}
    for k in ("lo", "hi"):
        out[k] = keylib.from_signed_limbs(states[k].detach().cpu().numpy())
    return out
