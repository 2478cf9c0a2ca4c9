"""The port's intra-batch sandwich (the phase function K3 replaces) against
the JAX `_run_sandwich` over `_intra_scan_levels` and `_intra_scan_blocked`.

Seeded numpy batches of ranks feed both sides: the JAX `_f_commit` of the
scan evaluator (pooled: gather and scatter by txn; strided: repeat and
reshape, every slot owned by its txn) inside `_run_sandwich`, jitted on the
CPU, and `conflict_ref.intra_sandwich` on the CPU (strided: padding slots
belong to txn T, as `strided_owners` makes them). `lower`, `upper` and
`converged` must be EQUAL for every bound on the rounds, including a
dependency chain that does not converge. On the CPU the kernel wrapper
runs this plain version and counts no launch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import conflict as jconf
from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops import kernels

T = 32
STRIDE = 3  # reads and writes a txn
RANKS = 14  # a small rank space: many overlaps, long chains


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def jax_sandwich(T, strided, rounds, g, wtxn, rtxn, rbr, rer, wbr, wer, w_ok,
                 r_ok):
    NW, NR = wtxn.shape[0], rtxn.shape[0]
    wtxn_c = jnp.minimum(wtxn, T - 1)
    levels = jconf._intra_scan_levels(T, wtxn_c, rtxn, rbr, rer, wbr, wer)

    def fold(blocked):
        if strided:
            return blocked.reshape(T, NR // T).any(axis=1)
        return jnp.zeros(T + 1, bool).at[rtxn].max(blocked)[:T]

    def f(c):
        cw = (jnp.repeat(c, NW // T) if strided else c[wtxn_c]) & w_ok
        return g & ~fold(jconf._intra_scan_blocked(cw, levels, rbr) & r_ok)
    return jconf._run_sandwich(f, g, rounds)


def make_batch(rng, strided):
    """numpy inputs of both sides: (jax args, port args). A tenth of the
    slots are padding; inverted or empty ranges are inert."""
    n = T * STRIDE
    owner = np.arange(n, dtype=np.int32) // STRIDE
    pad_r, pad_w = rng.random(n) < 0.1, rng.random(n) < 0.1
    if strided:
        rtxn_j, wtxn_j = owner, owner  # the JAX strided layout's slots
    else:
        rtxn_j = np.sort(rng.integers(0, T, n)).astype(np.int32)
        wtxn_j = np.sort(rng.integers(0, T, n)).astype(np.int32)
        rtxn_j[pad_r], wtxn_j[pad_w] = T, T
    rtxn_t = np.where(pad_r, T, rtxn_j).astype(np.int32)
    wtxn_t = np.where(pad_w, T, wtxn_j).astype(np.int32)
    rbr, rer, wbr, wer = (rng.integers(0, RANKS, n).astype(np.int32)
                          for _ in range(4))
    r_ok = ~pad_r & (rbr < rer)
    w_ok = ~pad_w & (wbr < wer)
    g = rng.random(T) < 0.9
    jargs = (g, wtxn_j, rtxn_j, rbr, rer, wbr, wer, w_ok, r_ok)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in dict(
        g=g, wtxn=wtxn_t, rtxn=rtxn_t, rbr=rbr, rer=rer, wbr=wbr, wer=wer,
        w_ok=w_ok, r_ok=r_ok).items()}
    wtxn_c = torch.clamp(t["wtxn"], max=T - 1)
    geo = ref.intra_levels(T, wtxn_c, t["rtxn"], t["rbr"], t["rer"],
                           t["wbr"], t["wer"])
    targs = (t["g"], geo, wtxn_c, t["w_ok"], t["r_ok"], t["rtxn"], t["rbr"])
    return jargs, targs


def assert_equal(jout, tout, where):
    for name, j, t in zip(("lower", "upper", "converged"), jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=f"{name} {where}")


@pytest.mark.parametrize("rounds", [0, 1, 2, "auto"])
@pytest.mark.parametrize("strided", [False, True])
def test_plain_sandwich_equals_jax(strided, rounds):
    rounds = ref.auto_rounds(T) if rounds == "auto" else rounds
    assert ref.auto_rounds(T) == jconf._auto_rounds(T)
    rng = np.random.default_rng(17 + strided)
    seen = set()
    for i in range(4):
        jargs, targs = make_batch(rng, strided)
        jout = jax_sandwich(T, strided, rounds, *jargs)
        tout = ref.intra_sandwich(*targs, rounds)
        assert_equal(jout, tout, f"batch {i}")
        seen.add(bool(tout[2]))
    if rounds >= 2:
        assert True in seen


def chain_batch(n):
    """Txn t reads the key txn t - 1 writes: a chain n deep."""
    ar = np.arange(n, dtype=np.int32)
    ok = np.ones(n, bool)
    return (ok, ar, ar, ar, ar + 1, ar + 1, ar + 2, ok, ok)


@pytest.mark.parametrize("rounds", [1, 2])
def test_plain_sandwich_leaves_a_deep_chain_unconverged(rounds):
    jargs = chain_batch(T)
    g, wtxn, rtxn, rbr, rer, wbr, wer, w_ok, r_ok = (torch.from_numpy(a)
                                                     for a in jargs)
    geo = ref.intra_levels(T, wtxn, rtxn, rbr, rer, wbr, wer)
    tout = ref.intra_sandwich(g, geo, wtxn, w_ok, r_ok, rtxn, rbr, rounds)
    assert_equal(jax_sandwich(T, False, rounds, *jargs), tout, "chain")
    assert not bool(tout[2])
    # never a false commit: lower is below the truth (every other txn),
    # upper above it
    truth = torch.arange(T) % 2 == 0
    assert not bool((tout[0] & ~truth).any())
    assert not bool((truth & ~tout[1]).any())


def test_plain_sandwich_counts_its_evaluations():
    jargs = chain_batch(T)
    g, wtxn, rtxn, rbr, rer, wbr, wer, w_ok, r_ok = (torch.from_numpy(a)
                                                     for a in jargs)
    geo = ref.intra_levels(T, wtxn, rtxn, rbr, rer, wbr, wer)
    args = (g, geo, wtxn, w_ok, r_ok, rtxn, rbr)
    evals = torch.zeros((), dtype=torch.int32)
    for rounds in (0, 1, 3):
        ref.intra_sandwich(*args, rounds, evals)
        assert int(evals) == 1 + 2 * rounds  # never pinched
    lower, upper, conv = ref.intra_sandwich(*args, T, evals)
    assert bool(conv) and torch.equal(lower, upper)
    assert int(evals) < 1 + 2 * T  # the rounds after the pinch are skipped
    # a batch with no overlaps pinches at the first test
    free = (torch.ones(T, dtype=torch.bool), geo, wtxn,
            torch.zeros(T, dtype=torch.bool), r_ok, rtxn, rbr)
    ref.intra_sandwich(*free, 5, evals)
    assert int(evals) == 1


def test_sandwich_wrapper_runs_the_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    kernels.reset_launches()
    for strided in (False, True):
        _jargs, targs = make_batch(rng, strided)
        for rounds in (0, 2, 17):
            want = ref.intra_sandwich(*targs, rounds)
            got = kernels.intra_sandwich(*targs, rounds)
            for w, g in zip(want, got):
                assert torch.equal(g, w)
    assert kernels.LAUNCHES["intra_sandwich"] == 0
    assert kernels.PHASES.intra_sandwich is kernels.intra_sandwich
    assert ref.PLAIN.intra_sandwich is ref.intra_sandwich
