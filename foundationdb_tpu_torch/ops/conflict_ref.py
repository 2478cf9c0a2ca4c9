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

The step is written as plain tensor code around five phase functions,
passed in as `phases` (an object with `build_table`, `history_check`,
`intra_sweep`, `merge_compact` and `legacy_sweep`). `PLAIN` holds the plain
versions below;
ops/kernels.py holds wrappers with the same signatures that launch the CUDA
kernels for CUDA tensors. Nothing here synchronises with the device: every
data-dependent choice is a tensor op, so the step enqueues without a host
round trip on the card.

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
from foundationdb_tpu_torch.utils import keys as keylib

NEG = -(1 << 30)  # "no version", below any clamped offset
PAD_LIMB = 0x7FFFFFFF  # the padding sentinel 0xFFFFFFFF, sign-flipped
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
# the four phases, plain versions (each Hopper kernel is held to one)
# ---------------------------------------------------------------------------

def build_table(vals: torch.Tensor) -> torch.Tensor:
    """(K,) int32 -> (LEVELS, K) window maxima `_build_table`:
    table[l, i] = max(vals[i : i + 2**l]), NEG past K."""
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
                  oldest):
    """Too-old and history verdicts per txn (conflict.py:423-444).

    Each read's segment range comes from the sorted positions of its
    endpoints (`spos`, state elements counted by `cum_state`); the range
    max of the step function is compared with the txn's snapshot and the
    hits fold to their txn. Returns (too_old, g0) with
    g0 = txn_valid & ~too_old & ~hist_conflict."""
    K = table.shape[1]
    NR = rb.shape[1]
    T = snapshot.shape[0]
    rvalid = rtxn < T
    has_reads = fold_any(rvalid, rtxn, T)
    too_old = txn_valid & has_reads & (snapshot < oldest)
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
                  max_write_life: int):
    """Merge the committed writes into the step function at vnew, clamp to
    the new MVCC floor, coalesce and compact to K slots (`_merge_phase`,
    conflict.py:589-704). Overflow poisons the state (sticky), never
    truncates it.

    Returns (keys (L,K), vals (K,), nb, oldest, poisoned, boundaries)."""
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


PLAIN = SimpleNamespace(build_table=build_table, history_check=history_check,
                        intra_sweep=intra_sweep, merge_compact=merge_compact,
                        legacy_sweep=legacy_sweep)


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


def intra_levels(T, wtxn_c, rtxn, rbr, rer, wbr, wer) -> dict:
    """Sweep-invariant geometry of the scan evaluator (`_intra_scan_levels`,
    conflict.py:243-292), every level in one 2-D sort: level l orders writes
    by (wtxn >> l, rank) and places each read's two query elements in block
    (rtxn >> l) - 1, class hi-query(-1) < write(0) < lo-query(1) at equal
    (block, rank). The three keys pack into one int64."""
    NW, NR = wbr.shape[0], rbr.shape[0]
    M = NW + 2 * NR
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
    packed = ((key1 + 1) << 40) | (key2 << 2)[None, :] | (cls + 1)[None, :]
    s, si = torch.sort(packed, dim=1)
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


def run_sandwich(sweep, g, rounds: int):
    """Bounded lower/upper sandwich on the antitone map f (`_run_sandwich`):
    upper ⊇ truth ⊇ lower; each round tightens both and is skipped once they
    meet. The skip is a device flag handed to `sweep`, not a host branch.
    Returns (lower, upper, converged)."""
    upper = g
    lower = sweep(upper, None, None)
    for _ in range(max(rounds, 0)):
        pinched = torch.all(lower == upper)
        if not pinched.is_cuda and bool(pinched):
            break  # on the host the flag is free to read; same result
        up2 = sweep(lower, pinched, upper)
        lower = sweep(up2, pinched, lower)
        upper = up2
    return lower, upper, torch.all(lower == upper)


def run_legacy(sweep, g):
    """The legacy evaluator's fixpoint (conflict.py:516-530): one `body`,
    then `body` again while the bounds differ. The loop is unbounded, as
    the JAX `while_loop` is, so it reads the test on the host once per
    `body`. Returns the committed set (lower == upper)."""
    upper = g
    lower = sweep(upper)
    while True:
        upper = sweep(lower)
        lower = sweep(upper)
        if not bool(torch.any(lower != upper)):
            return lower


def strided_owners(begins: torch.Tensor, T: int) -> torch.Tensor:
    """The strided layout's range->txn map (conflict.py:385-391, 436-442,
    486-489, 601-605): slot j of NS belongs to txn j // (NS // T), or to T
    (padding) when its begin key carries the padding length limb. Real
    keys never carry it, so an empty real range still belongs to its txn."""
    L, NS = begins.shape
    owner = torch.arange(NS, dtype=_I32, device=begins.device) // (NS // T)
    return torch.where(begins[L - 1] != PAD_LIMB, owner, T).to(_I32)


INTRA_MODES = ("scan", "legacy")


def conflict_step(state: dict, batch: dict, *, max_write_life: int,
                  intra_rounds: int = 0, intra_mode: str = "scan",
                  strided: bool = False, phases=PLAIN):
    """(state, batch) -> (state', statuses, info), as the JAX
    `conflict_step`. `strided` selects the strided layout (every txn owns
    NR/T read and NW/T write slots; the batch's rtxn/wtxn are not read),
    `intra_mode` the intra-batch evaluator ("scan" or "legacy").

    state: bkeys (L,K) i32 sorted; bval (K,) i32; nb, oldest () i32;
      table (LEVELS,K) i32; poisoned () bool
    batch: txn_valid (T,) bool; snapshot (T,) i32; rb, re (L,NR) i32;
      rtxn (NR,) i32 (= T for padding); wb, we (L,NW) i32; wtxn (NW,) i32;
      commit_version () i32; advance_floor () bool
    Shapes come from the tensors. Outputs are new tensors; the inputs are
    not modified."""
    if intra_mode not in INTRA_MODES:
        raise ValueError(f"intra_mode must be one of {INTRA_MODES}, got "
                         f"{intra_mode!r}")
    if strided:
        T = batch["snapshot"].shape[0]
        batch = dict(batch, rtxn=strided_owners(batch["rb"], T),
                     wtxn=strided_owners(batch["wb"], T))
    bkeys, bval, table = state["bkeys"], state["bval"], state["table"]
    rb, re, rtxn = batch["rb"], batch["re"], batch["rtxn"]
    wb, we, wtxn = batch["wb"], batch["we"], batch["wtxn"]
    snapshot, txn_valid = batch["snapshot"], batch["txn_valid"]
    L, K = bkeys.shape
    NR, NW, T = rb.shape[1], wb.shape[1], snapshot.shape[0]
    dev = bkeys.device
    rvalid = rtxn < T
    wvalid = wtxn < T

    # ---- 0. the sort of [state | rb | re | wb | we] ----
    # class tiebreak at equal keys: re(0) < state(1) < rb/wb/we(2)
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

    # ---- 1+2. too-old and history check ----
    too_old, g = phases.history_check(table, cum_state, spos, rb, re, rtxn,
                                      snapshot, txn_valid, state["oldest"])

    # ---- 3. intra-batch: endpoint ranks -> dyadic levels -> sandwich ----
    is_b = (~is_state).to(_I32)
    newgrp = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        ~key_eq(skeys[:, 1:], skeys[:, :-1])])
    cum_b_excl = _cumsum(is_b) - is_b
    first_b = (is_b > 0) & (cum_b_excl == _cummax(
        torch.where(newgrp, cum_b_excl, -1)))
    rank_carried = _cummax(torch.where(first_b, _cumsum(first_b) - 1, -1))
    qranks = rank_carried[spos[K:].to(torch.int64)]
    rbr, rer = qranks[:NR], qranks[NR:2 * NR]
    wbr, wer = qranks[2 * NR:2 * NR + NW], qranks[2 * NR + NW:]

    # empty/inverted ranges take part in neither side; strict wtxn < rtxn
    # is "earlier txns win" (SkipList.cpp:1139-1152)
    wtxn_c = torch.clamp(wtxn, max=T - 1)
    r_ok = (rvalid & (rbr < rer)).contiguous()
    w_ok = (wvalid & (wbr < wer)).contiguous()

    if intra_mode == "legacy":
        def legacy(c):
            return phases.legacy_sweep(c, g, wtxn, rtxn, w_ok, r_ok, wbr, wer,
                                       rbr, rer)
        commit = merge_commit = run_legacy(legacy, g)
        converged = torch.ones((), dtype=torch.bool, device=dev)
    else:
        geo = intra_levels(T, wtxn_c, rtxn, rbr, rer, wbr, wer)

        def sweep(c, skip, prev):
            return phases.intra_sweep(c, g, geo, wtxn_c, w_ok, r_ok, rtxn,
                                      rbr, skip, prev)

        rounds = intra_rounds if intra_rounds > 0 else auto_rounds(T)
        # statuses come from `lower` (never a false commit), the merge uses
        # `upper` (never a write missing from history)
        commit, merge_commit, converged = run_sandwich(sweep, g, rounds)

    statuses = torch.where(
        commit, COMMITTED, torch.where(too_old, TOO_OLD, CONFLICT)).to(_I32)
    statuses = torch.where(txn_valid, statuses, COMMITTED).to(_I32)

    # ---- 4+5. merge, window GC, compaction; then the table ----
    keys2, vals2, nb2, oldest2, poisoned2, boundaries = phases.merge_compact(
        skeys, scls, sval, sidx, spos, merge_commit, wb, we, wtxn,
        state["nb"], state["oldest"], state["poisoned"],
        batch["commit_version"], batch["advance_floor"], K=K,
        max_write_life=max_write_life)
    new_state = {"bkeys": keys2, "bval": vals2, "nb": nb2, "oldest": oldest2,
                 "table": phases.build_table(vals2), "poisoned": poisoned2}
    info = {"overflow": poisoned2, "boundaries": boundaries,
            "committed": commit.sum(dtype=_I32), "converged": converged,
            "eligible": g}
    return new_state, statuses, info


def conflict_scan(state: dict, stacked: dict, *, max_write_life: int,
                  intra_rounds: int = 0, intra_mode: str = "scan",
                  strided: bool = False, phases=PLAIN):
    """M batches in order (`conflict_scan`, conflict.py:771-790): `stacked`
    holds a step's batch fields with a leading batch axis. The steps are
    enqueued back to back with no host sync (for the scan evaluator).
    Returns (state', statuses (M, T) int8, committed (M,) int32,
    overflow (M,) bool)."""
    statuses, committed, overflow = [], [], []
    for i in range(stacked["snapshot"].shape[0]):
        state, st, info = conflict_step(
            state, {k: v[i] for k, v in stacked.items()},
            max_write_life=max_write_life, intra_rounds=intra_rounds,
            intra_mode=intra_mode, strided=strided, phases=phases)
        statuses.append(st.to(torch.int8))
        committed.append(info["committed"])
        overflow.append(info["overflow"])
    return (state, torch.stack(statuses), torch.stack(committed),
            torch.stack(overflow))


def rebase_state(state: dict, delta: int, phases=PLAIN) -> dict:
    """Shift every version offset down by delta (the host rebases its int64
    base), saturating at NEG, and rebuild the table (`rebase_state`)."""
    bval = torch.clamp(state["bval"] - delta, min=NEG)
    return dict(state, bval=bval,
                oldest=torch.clamp(state["oldest"] - delta, min=NEG),
                table=phases.build_table(bval))


def init_state(capacity: int, limbs: int, device, oldest: int = 0,
               phases=PLAIN) -> dict:
    """Empty state: segment 0 starts at b"" with no version."""
    keys = torch.full((limbs, capacity), PAD_LIMB, dtype=_I32, device=device)
    keys[:, 0] = EMPTY_LIMB
    bval = torch.full((capacity,), NEG, dtype=_I32, device=device)
    return {"bkeys": keys, "bval": bval,
            "nb": torch.tensor(1, dtype=_I32, device=device),
            "oldest": torch.tensor(oldest, dtype=_I32, device=device),
            "table": phases.build_table(bval),
            "poisoned": torch.tensor(False, device=device)}


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


def state_from_numpy(np_state: dict, device) -> dict:
    """JAX state dict (bkeys (L,K) uint32, bval, nb, oldest, table,
    poisoned; numpy or anything np.asarray takes) -> the port's tensors."""
    return {k: _from_np(k, np_state[k], device)
            for k in ("bkeys", "bval", "nb", "oldest", "table", "poisoned")}


def batch_from_numpy(np_batch: dict, device) -> dict:
    """JAX pooled-layout batch dict (rb/re/wb/we (L,N) uint32, rtxn, wtxn,
    snapshot, txn_valid, commit_version, advance_floor) -> port tensors."""
    return {k: _from_np(k, np_batch[k], device)
            for k in ("rb", "re", "rtxn", "wb", "we", "wtxn", "snapshot",
                      "txn_valid", "commit_version", "advance_floor")}


def state_to_numpy(state: dict) -> dict:
    """The port's state -> the JAX numpy layout (uint32 key limbs)."""
    out = {}
    for k in ("bkeys", "bval", "nb", "oldest", "table", "poisoned"):
        a = state[k].detach().cpu().numpy()
        out[k] = keylib.from_signed_limbs(a) if k == "bkeys" else a
    return out
