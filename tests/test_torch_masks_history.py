"""K2's phase `masks_and_history` on the CPU: the range->txn maps and the
intra-batch masks (`step_masks`), then the too-old and history verdicts
(`history_check`), which the card runs as one cooperative launch.

- The plain phase equals its two parts called in turn, on the phase calls
  of seeded steps in both layouts, with and without `skip_history`; K2's
  wrapper on CPU tensors is the plain phase and counts no launch.
- The step through the fused phase equals the JAX step (state, statuses
  and every `info` field, EXACTLY: integer outputs) in the pooled and the
  strided layout, with the scan and the legacy evaluator, and under the
  `no_hist` ablation; neither phases object has a masks phase of its own.
- The plain phase decides a read's hit with a key compare (`rb < re`);
  the fused kernel decides both the hit and r_ok with the endpoint ranks
  (`rbr < rer`), and `history_check` alone, with no ranks, with the keys.
  The two compares agree on ties, empty and inverted ranges, padding and
  collapsed long keys, since the ranks are dense over the endpoint keys.
The card tests of the launch are in test_torch_kernels.py.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import conflict as jconf
from foundationdb_tpu.ops.batch import TxnConflictInfo as JTxn
from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops import kernels
from foundationdb_tpu_torch.utils.knobs import KNOBS

CPU = torch.device("cpu")
WINDOW = 5_000_000
STEP = 500_000
INFO = ("overflow", "boundaries", "committed", "converged", "eligible")
# the shapes of test_torch_ablate.py, whose JAX programs the persistent
# compile cache may already hold
SHAPES = {
    "pooled": jconf.ConflictShapes(capacity=512, txns=32, reads=96,
                                   writes=96),
    "strided": jconf.ConflictShapes(capacity=512, txns=32, reads=64,
                                    writes=64, strided=True)}


@pytest.fixture(autouse=True)
def _reset_port_knobs():
    KNOBS.reset()
    yield
    KNOBS.reset()


@functools.cache
def jax_step(shapes, ablate, intra_mode):
    return jax.jit(functools.partial(
        jconf.conflict_step, shapes=shapes, max_write_life=WINDOW,
        ablate=ablate, intra_mode=intra_mode))


def rand_range(rng, space):
    a = space[rng.integers(len(space))]
    kind = rng.integers(10)
    if kind < 4:
        return (a, a + b"\x00")  # point
    if kind == 4:
        return (a, a)  # empty
    b = space[rng.integers(len(space))]
    if kind == 5:
        return (max(a, b), min(a, b))  # inverted (or empty)
    if kind == 6:
        return (a + b"x" * 40, a + b"y" * 40)  # long keys: they collapse
    return (min(a, b), max(a, b) + b"\x00")


def trajectory(shapes, seed, steps=5):
    """(numpy batch) list from the JAX encoder: up to T txns a step, 0 to
    3 (strided: 2) reads and writes each, stale snapshots, ranges whose
    ends tie with other ranges' ends."""
    rng = np.random.default_rng(seed)
    space = sorted({rng.integers(97, 104, rng.integers(1, 4)).astype(
        np.uint8).tobytes() for _ in range(40)})
    per = 2 if shapes.strided else 3
    enc = jconf.BatchEncoder(shapes)
    out, version = [], STEP
    for _ in range(steps):
        version += int(rng.integers(2 * STEP, 5 * STEP))
        txns = [JTxn(max(0, version - int(rng.integers(0, 20 * STEP))),
                     [rand_range(rng, space)
                      for _ in range(rng.integers(0, per + 1))],
                     [rand_range(rng, space)
                      for _ in range(rng.integers(0, per + 1))])
                for _ in range(rng.integers(1, shapes.txns + 1))]
        out.append({k: np.array(v)
                    for k, v in enc.encode_batch(txns, version).items()})
    return out


def captured_calls(shapes, seed, ablate=""):
    """The `masks_and_history` calls of a plain trajectory."""
    calls = []

    def spy(*a, **kw):
        calls.append((a, kw))
        return ref.masks_and_history(*a, **kw)
    phases = type(ref.PLAIN)(**dict(vars(ref.PLAIN), masks_and_history=spy))
    state = ref.init_state(shapes.capacity, shapes.limbs, CPU)
    for batch in trajectory(shapes, seed):
        state, _st, _info = ref.conflict_step(
            state, ref.batch_from_numpy(batch, CPU), max_write_life=WINDOW,
            strided=shapes.strided, ablate=ablate, phases=phases)
    return calls


@pytest.mark.parametrize("layout", ["pooled", "strided"])
@pytest.mark.parametrize("ablate", ["", "no_hist"])
def test_fused_phase_is_step_masks_then_history_check(layout, ablate):
    shapes = SHAPES[layout]
    calls = captured_calls(shapes, seed=5, ablate=ablate)
    assert calls
    kernels.reset_launches()
    for a, kw in calls:
        (table, cum_state, spos, rb, re, wb, rtxn, wtxn, rbr, rer, wbr, wer,
         snapshot, txn_valid, oldest) = a
        assert kw == {"strided": shapes.strided,
                      "skip_history": ablate == "no_hist"}
        masks = ref.step_masks(rb, wb, rtxn, wtxn, rbr, rer, wbr, wer,
                               snapshot.shape[0], shapes.strided)
        verdicts = ref.history_check(table, cum_state, spos, rb, re,
                                     masks[0], snapshot, txn_valid, oldest,
                                     skip_history=kw["skip_history"])
        want = masks + verdicts
        for got in (ref.masks_and_history(*a, **kw),
                    kernels.masks_and_history(*a, **kw)):
            assert len(got) == 7
            for w, g in zip(want, got):
                assert g.dtype == w.dtype and torch.equal(g, w)
    assert all(n == 0 for n in kernels.LAUNCHES.values())


CASES = [("", "pooled", "scan"), ("", "strided", "scan"),
         ("", "pooled", "legacy"), ("", "strided", "legacy"),
         ("no_hist", "pooled", "scan"), ("no_hist", "strided", "scan")]


@pytest.mark.parametrize("ablate,layout,intra_mode", CASES)
def test_step_with_the_fused_phase_equals_jax(ablate, layout, intra_mode):
    for phases in (ref.PLAIN, kernels.PHASES):
        assert hasattr(phases, "masks_and_history")
        assert not hasattr(phases, "step_masks")
        assert not hasattr(phases, "history_check")
    shapes = SHAPES[layout]
    step = jax_step(shapes, ablate, intra_mode)
    jstate = jconf.init_state(shapes)
    tstate = ref.state_from_numpy({k: np.asarray(v)
                                   for k, v in jstate.items()}, CPU)
    statuses = set()
    for i, batch in enumerate(trajectory(shapes, seed=11 + len(ablate))):
        where = f"{ablate or 'full'} {layout} {intra_mode} step {i}"
        jstate, jst, jinfo = step(jstate, batch)
        tstate, tst, tinfo = ref.conflict_step(
            tstate, ref.batch_from_numpy(batch, CPU), max_write_life=WINDOW,
            strided=shapes.strided, intra_mode=intra_mode, ablate=ablate,
            phases=kernels.PHASES)
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst),
                                      err_msg=f"statuses {where}")
        for k in INFO:
            np.testing.assert_array_equal(
                tinfo[k].numpy(), np.asarray(jinfo[k]),
                err_msg=f"info[{k}] {where}")
        got = ref.state_to_numpy(tstate)
        for k, v in jstate.items():
            np.testing.assert_array_equal(got[k], np.asarray(v),
                                          err_msg=f"{k} {where}")
        statuses |= set(tst.numpy().tolist())
    assert {1, 2} <= statuses  # too old and committed
    if not ablate:
        assert 0 in statuses  # a conflict


@pytest.mark.parametrize("layout", ["pooled", "strided"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_key_compare_equals_the_rank_compare(layout, seed):
    shapes = SHAPES[layout]
    state = ref.init_state(shapes.capacity, shapes.limbs, CPU)
    seen = {"tie": False, "empty": False, "inverted": False, "pad": False}
    for batch in trajectory(shapes, seed):
        tb = ref.batch_from_numpy(batch, CPU)
        rb, re, wb, we = tb["rb"], tb["re"], tb["wb"], tb["we"]
        qranks = ref.sort_and_rank(state["bkeys"], state["bval"], rb, re, wb,
                                   we)[6]
        NR, NW = rb.shape[1], wb.shape[1]
        ranks = {"r": (qranks[:NR], qranks[NR:2 * NR]),
                 "w": (qranks[2 * NR:2 * NR + NW], qranks[2 * NR + NW:])}
        for side, (b, e) in (("r", (rb, re)), ("w", (wb, we))):
            br, er = ranks[side]
            assert torch.equal(ref.key_lt(b, e), br < er), side
            seen["empty"] |= bool((ref.key_eq(b, e) & (b[-1] != ref.PAD_LIMB)
                                   ).any())
            seen["inverted"] |= bool(ref.key_lt(e, b).any())
            seen["pad"] |= bool((b[-1] == ref.PAD_LIMB).any())
        # an end that equals another range's begin: equal ranks
        ends = torch.cat([rb, re, wb, we], dim=1)
        seen["tie"] |= bool(torch.unique(ends, dim=1).shape[1]
                            < ends.shape[1])
    assert all(seen.values()), seen
