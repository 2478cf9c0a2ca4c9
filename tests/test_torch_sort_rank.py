"""The step's sort and endpoint ranks (`sort_and_rank`, K6-K8's phase)
against the JAX package and numpy, on the CPU.

`ref.sort_and_rank` is held three ways, exactly (every output is an
integer; the tolerance is zero):

- against the JAX step's phase-0 expression (foundationdb_tpu/ops/
  conflict.py:397-421, one `lax.sort` of [state | rb | re | wb | we]) and
  its endpoint ranks (:465-476), run here on the same inputs with JAX's
  own `_key_eq`. `lax.sort` is not stable, so sidx and spos are held to the
  same sort with the original index added as the last key; skeys, scls,
  sval and cum_state are held to both;
- its ranks against numpy's dense rank of the endpoint keys
  (`np.unique(..., axis=1, return_inverse=True)`);
- through the three parts the kernels compute (`sort_and_rank_parts`:
  sort the endpoints, rank them, merge them into the sorted state), and
  through the kernel wrappers, which on CPU tensors run the plain versions
  and count no launch.

The inputs are made from a seed with numpy: byte keys encoded at L = 3, 5
and 7 limbs, a state with a PAD_LIMB tail or a poisoned one, endpoints
equal to state keys in every class, empty and inverted ranges, padding
endpoints, keys longer than the width that collapse to one prefix, and
endpoint counts that are not a power of two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from foundationdb_tpu.ops import conflict as jconf
from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops import kernels
from foundationdb_tpu_torch.utils import keys as tkeys

PAD = np.uint32(0xFFFFFFFF)
NEG = ref.NEG


def jax_phase0(bkeys, bval, rb, re, wb, we, stable):
    """conflict.py:397-421 and :465-476 on uint32 limbs: (skeys, scls,
    sval, sidx, spos, cum_state, qranks) as numpy. With `stable` the
    original index is the last sort key."""
    L, K = bkeys.shape
    NR, NW = rb.shape[1], wb.shape[1]
    N = K + 2 * NR + 2 * NW
    allk = jnp.concatenate([bkeys, rb, re, wb, we], axis=1)
    cls = jnp.concatenate([
        jnp.ones(K, jnp.int32),
        jnp.full(NR, 2, jnp.int32), jnp.zeros(NR, jnp.int32),
        jnp.full(2 * NW, 2, jnp.int32)])
    vpay = jnp.concatenate([bval, jnp.full(2 * NR + 2 * NW, NEG, jnp.int32)])
    idx = jnp.arange(N, dtype=jnp.int32)
    limbs = [allk[i] for i in range(L)]
    if stable:
        out = lax.sort(limbs + [cls, idx, vpay], num_keys=L + 2)
        sidx, sval = out[L + 1], out[L + 2]
    else:
        out = lax.sort(limbs + [cls, vpay, idx], num_keys=L + 1)
        sval, sidx = out[L + 1], out[L + 2]
    skeys = jnp.stack(out[:L])
    scls = out[L]
    spos = jnp.zeros(N, jnp.int32).at[sidx].set(idx)
    is_state = scls == 1
    cum_state = jnp.cumsum(is_state.astype(jnp.int32))
    is_batch = ~is_state
    newgrp = jnp.concatenate(
        [jnp.ones(1, bool), ~jconf._key_eq(skeys[:, 1:], skeys[:, :-1])])
    cum_b_excl = jnp.cumsum(is_batch.astype(jnp.int32)) - is_batch
    grp_start_b = lax.cummax(jnp.where(newgrp, cum_b_excl, -1))
    first_b = is_batch & (cum_b_excl == grp_start_b)
    rank_grp = jnp.cumsum(first_b.astype(jnp.int32)) - 1
    rank_carried = lax.cummax(jnp.where(first_b, rank_grp, -1))
    qranks = rank_carried[spos[K:]]
    return tuple(np.asarray(a) for a in (skeys, scls, sval, sidx, spos,
                                         cum_state, qranks))


def encode(keys, key_bytes, round_up=False):
    return tkeys.encode_keys_bulk(keys, key_bytes, round_up=round_up)


def make_case(seed, L, K, NR, NW, *, poisoned=False, long_keys=False,
              all_equal=False, all_state_keys=False):
    """(bkeys, bval, rb, re, wb, we) in the JAX layout (uint32 limbs).
    `all_equal`: every endpoint the same key; `all_state_keys`: every
    endpoint a live state key."""
    rng = np.random.default_rng(seed)
    kb = (L - 1) * 4
    alphabet = np.frombuffer(b"abcd", np.uint8)
    space = sorted({alphabet[rng.integers(0, 4, rng.integers(0, kb + 1))]
                    .tobytes() for _ in range(6 * K)})
    if long_keys:  # longer than the width: many collapse onto one prefix
        space = sorted(set(space) | {b"c" * kb + bytes([97 + i % 4]) * (i + 1)
                                     for i in range(8)})
    bkeys = np.full((L, K), PAD, np.uint32)
    bval = np.full(K, NEG, np.int32)
    if poisoned:
        bkeys[:, 0] = encode([b""], kb)[:, 0]
        bval[0] = 7_000
        nb = 1
        live = [b""]
    else:
        nb = K // 2
        live = sorted(rng.choice(len(space), nb, replace=False).tolist())
        live = [space[i] for i in live]
        bkeys[:, :nb] = encode(live, kb)
        bval[:nb] = rng.integers(NEG, 10_000, nb)

    def pick(n):
        if all_equal:
            return [live[0]] * n
        if all_state_keys:
            return [live[i] for i in rng.integers(0, len(live), n)]
        ks = [space[i] for i in rng.integers(0, len(space), n)]
        # a share of the endpoints equal a live state boundary
        for i in np.flatnonzero(rng.random(n) < 0.3):
            ks[i] = live[rng.integers(0, len(live))]
        return ks
    rbk, rek, wbk, wek = pick(NR), pick(NR), pick(NW), pick(NW)
    for b, e in ((rbk, rek), (wbk, wek)):
        for i in range(len(b)):
            u = rng.random()
            if u < 0.15:
                e[i] = b[i]  # empty
            elif u < 0.3:
                b[i], e[i] = max(b[i], e[i]), min(b[i], e[i])  # inverted
            elif u < 0.75 and e[i] < b[i]:
                b[i], e[i] = e[i], b[i]
    rb, re = encode(rbk, kb), encode(rek, kb, round_up=True)
    wb, we = encode(wbk, kb), encode(wek, kb, round_up=True)
    if all_equal:  # begins and ends alike, none padding
        return bkeys, bval, encode(rbk, kb), encode(rek, kb), \
            encode(wbk, kb), encode(wek, kb)
    if all_state_keys:
        return bkeys, bval, rb, re, wb, we
    for arr in (rb, re, wb, we):  # padding endpoints
        arr[:, rng.random(arr.shape[1]) < 0.1] = PAD
    return bkeys, bval, rb, re, wb, we


CASES = {
    "L3": dict(seed=1, L=3, K=64, NR=37, NW=23),
    "L5": dict(seed=2, L=5, K=128, NR=50, NW=45),
    "L7": dict(seed=3, L=7, K=256, NR=101, NW=77),
    "L7_poisoned": dict(seed=4, L=7, K=96, NR=29, NW=31, poisoned=True),
    "L7_long_keys": dict(seed=5, L=7, K=128, NR=45, NW=40, long_keys=True),
    "L5_one_txn": dict(seed=6, L=5, K=16, NR=1, NW=1),
    # K6 sorts tiles of 1,024 endpoints in a CTA's shared memory and
    # merges them in rounds that double the runs: M = 2 NR + 2 NW one
    # below and one above a tile and one below, at and one above eight (the
    # third round), at the widths the encoder gives (L = 2 to 17, key_bytes
    # up to 64)
    "L2": dict(seed=7, L=2, K=64, NR=37, NW=23),
    "L17": dict(seed=8, L=17, K=64, NR=40, NW=41),
    "L3_tile_minus_one": dict(seed=9, L=3, K=64, NR=256, NW=255),
    "L3_tile_plus_one": dict(seed=10, L=3, K=64, NR=256, NW=257),
    "L5_eight_tiles_minus_one": dict(seed=11, L=5, K=64, NR=2048, NW=2047),
    "L5_eight_tiles": dict(seed=12, L=5, K=64, NR=2048, NW=2048),
    "L5_eight_tiles_plus_one": dict(seed=13, L=5, K=64, NR=2049, NW=2048),
    "L7_eight_tiles_minus_one": dict(seed=14, L=7, K=64, NR=2048, NW=2047),
    "L7_eight_tiles_plus_one": dict(seed=15, L=7, K=64, NR=2049, NW=2048),
    "L17_eight_tiles": dict(seed=16, L=17, K=64, NR=2048, NW=2048),
    "L7_all_equal_keys": dict(seed=17, L=7, K=64, NR=700, NW=600,
                              all_equal=True),
    "L5_all_state_keys": dict(seed=18, L=5, K=256, NR=300, NW=200,
                              all_state_keys=True),
}


def port(arrays):
    bkeys, bval, rb, re, wb, we = arrays
    t = [torch.from_numpy(tkeys.to_signed_limbs(a).copy())
         for a in (bkeys, rb, re, wb, we)]
    return t[0], torch.from_numpy(bval.copy()), t[1], t[2], t[3], t[4]


def port_out_to_jax(out):
    """The port's outputs in the JAX layout (uint32 sorted keys)."""
    skeys, *rest = (o.numpy() for o in out)
    return (tkeys.from_signed_limbs(skeys), *rest)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_phase_equals_the_jax_sort_and_ranks(case):
    arrays = make_case(**CASES[case])
    got = port_out_to_jax(ref.sort_and_rank(*port(arrays)))
    names = ("skeys", "scls", "sval", "sidx", "spos", "cum_state", "qranks")
    for name, g, w in zip(names, got, jax_phase0(*arrays, stable=True)):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    # the unstable sort of the JAX step orders ties differently, but not
    # the keys, classes, values or state counts
    for name, g, w in zip(names, got, jax_phase0(*arrays, stable=False)):
        if name in ("skeys", "scls", "sval", "cum_state", "qranks"):
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_are_numpys_dense_ranks_of_the_endpoint_keys(case):
    arrays = make_case(**CASES[case])
    ekeys = np.concatenate(arrays[2:], axis=1)
    _u, dense = np.unique(ekeys, axis=1, return_inverse=True)
    qranks = ref.sort_and_rank(*port(arrays))[6]
    assert qranks.dtype == torch.int32
    np.testing.assert_array_equal(qranks.numpy(), dense.reshape(-1))


@pytest.mark.parametrize("case", list(CASES))
def test_the_three_parts_equal_the_phase(case):
    args = port(make_case(**CASES[case]))
    want = ref.sort_and_rank(*args)
    got = ref.sort_and_rank_parts(*args)
    assert len(got) == len(want) == 7
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # K6's order is the phase's order restricted to the endpoints
    K = args[0].shape[1]
    ekeys, eidx = ref.endpoint_sort(*args[2:])
    sidx = want[3]
    np.testing.assert_array_equal(eidx.numpy(),
                                  sidx[sidx >= K].numpy() - K)


def test_cpu_wrappers_run_the_plain_versions_and_count_no_launch():
    kernels.reset_launches()
    args = port(make_case(**CASES["L7"]))
    want = ref.sort_and_rank(*args)
    for g, w in zip(kernels.PHASES.sort_and_rank(*args), want):
        assert torch.equal(g, w)
    ekeys, eidx = kernels.endpoint_sort(*args[2:])
    for g, w in zip((ekeys, eidx), ref.endpoint_sort(*args[2:])):
        assert torch.equal(g, w)
    assert torch.equal(kernels.endpoint_ranks(ekeys, eidx), want[6])
    NR = args[2].shape[1]
    for g, w in zip(kernels.state_merge(*args[:2], ekeys, eidx, NR), want):
        assert torch.equal(g, w)
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    assert kernels.PHASES.sort_and_rank is kernels.sort_and_rank
    assert ref.PLAIN.sort_and_rank is ref.sort_and_rank
