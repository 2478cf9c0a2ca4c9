"""The `ablate` modes of the port's plain step against the JAX step.

`conflict_step(..., ablate=mode)` leaves a phase out for the bench's
per-phase profile (scripts/profile_kernel.py): no history hits, commit =
eligible, no merge (only the MVCC floor moves), or no table rebuild. Every
mode of the JAX step (`ablate`, conflict.py:346) runs here in both layouts
(pooled and strided) with the scan evaluator, and `no_intra` and
`no_merge` with the legacy evaluator too (the JAX step branches before the
evaluator). A seeded numpy trajectory of batches from the JAX encoder
feeds the jitted JAX step and the port's plain step on the CPU; after
every step the state, the statuses and every `info` field must be EQUAL.
The port's step then runs the same trajectory through its fixed buffers
(`out=`), which must give the same and keep their addresses.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import conflict as jconf
from foundationdb_tpu.ops.batch import TxnConflictInfo as JTxn
from foundationdb_tpu_torch.ops import conflict_ref as ref

CPU = torch.device("cpu")
WINDOW = 5_000_000
STEP = 500_000
INFO = ("overflow", "boundaries", "committed", "converged", "eligible")
POOLED = jconf.ConflictShapes(capacity=512, txns=32, reads=96, writes=96)
STRIDED = jconf.ConflictShapes(capacity=512, txns=32, reads=64, writes=64,
                               strided=True)
CASES = ([(mode, layout, "scan") for mode in ref.ABLATE_MODES
          for layout in ("pooled", "strided")]
         + [(mode, layout, "legacy") for mode in ("no_intra", "no_merge")
            for layout in ("pooled", "strided")])


@functools.cache
def jax_step(shapes, ablate, intra_mode):
    return jax.jit(functools.partial(
        jconf.conflict_step, shapes=shapes, max_write_life=WINDOW,
        ablate=ablate, intra_mode=intra_mode))


def to_np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def rand_range(rng, space):
    a = space[rng.integers(len(space))]
    kind = rng.integers(10)
    if kind < 5:
        return (a, a + b"\x00")  # point
    if kind == 5:
        return (a, a)  # empty
    b = space[rng.integers(len(space))]
    if kind == 6:
        return (max(a, b), min(a, b))  # inverted (or empty)
    return (min(a, b), max(a, b) + b"\x00")


def rand_batch(rng, space, version, per_txn):
    """Up to T txns, 0..per_txn reads and writes each, stale snapshots."""
    return [JTxn(max(0, version - int(rng.integers(0, 20 * STEP))),
                 [rand_range(rng, space)
                  for _ in range(rng.integers(0, per_txn + 1))],
                 [rand_range(rng, space)
                  for _ in range(rng.integers(0, per_txn + 1))])
            for _ in range(rng.integers(1, 33))]


def trajectory(shapes, seed, steps=6):
    """(version, numpy batch) pairs from the JAX encoder; the first step
    fills some history, later ones conflict with it."""
    rng = np.random.default_rng(seed)
    space = sorted({rng.integers(97, 110, rng.integers(1, 4)).astype(
        np.uint8).tobytes() for _ in range(60)})
    per_txn = 2 if shapes.strided else 3
    enc = jconf.BatchEncoder(shapes)
    out, version = [], STEP
    for _ in range(steps):
        version += int(rng.integers(2 * STEP, 5 * STEP))
        txns = rand_batch(rng, space, version, per_txn)
        out.append({k: np.array(v)
                    for k, v in enc.encode_batch(txns, version).items()})
    return out


def assert_equal_step(jout, tout, where):
    jstate, jst, jinfo = jout
    tstate, tst, tinfo = tout
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst),
                                  err_msg=f"statuses {where}")
    for k in INFO:
        np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                      err_msg=f"info[{k}] {where}")
    got, want = ref.state_to_numpy(tstate), to_np(jstate)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} {where}")


@pytest.mark.parametrize("mode,layout,intra_mode", CASES)
def test_ablate_mode_equals_the_jax_step(mode, layout, intra_mode):
    shapes = POOLED if layout == "pooled" else STRIDED
    step = jax_step(shapes, mode, intra_mode)
    jstate = jconf.init_state(shapes)
    tstate = ref.state_from_numpy(to_np(jstate), CPU)
    fixed = ref.state_from_numpy(to_np(jstate), CPU)
    ptrs = {k: v.data_ptr() for k, v in fixed.items()}
    saw = {"conflict": False, "too_old": False, "commit": False}
    kw = dict(max_write_life=WINDOW, strided=shapes.strided, ablate=mode,
              intra_mode=intra_mode)
    for i, batch in enumerate(trajectory(shapes, seed=len(mode) + 7)):
        where = f"{mode or 'full'} {layout} {intra_mode} step {i}"
        jout = step(jstate, batch)
        tbatch = ref.batch_from_numpy(batch, CPU)
        tout = ref.conflict_step(tstate, tbatch, **kw)
        assert_equal_step(jout, tout, where)
        # the same step into fixed buffers: same outputs, same addresses
        fout = ref.conflict_step(fixed, tbatch, out=fixed, **kw)
        assert fout[0] is fixed
        assert_equal_step(jout, fout, where + " (out=)")
        assert {k: v.data_ptr() for k, v in fixed.items()} == ptrs
        jstate, tstate = jout[0], tout[0]
        st = tout[1].numpy()
        saw["conflict"] |= bool((st == 0).any())
        saw["too_old"] |= bool((st == 1).any())
        saw["commit"] |= bool((st == 2).any())
    assert saw["commit"] and saw["too_old"]
    if mode not in ("no_hist", "only_merge", "no_merge", "only_hist"):
        assert saw["conflict"], "the trajectory never conflicted"


def test_unknown_ablate_mode_is_refused():
    shapes = POOLED
    state = ref.init_state(shapes.capacity, shapes.limbs, CPU)
    batch = ref.batch_from_numpy(trajectory(shapes, 1, steps=1)[0], CPU)
    with pytest.raises(ValueError):
        ref.conflict_step(state, batch, max_write_life=WINDOW,
                          ablate="no_sort")
