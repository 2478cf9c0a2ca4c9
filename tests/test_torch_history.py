"""K1's and K2's plain versions against the JAX package, on the inputs
that the kernels' partitions stress.

`ref.history_check` is held to the JAX step's phases 1-2: the same numpy
state and batch go through the jitted JAX `conflict_step(...,
ablate="only_hist")` (statuses from the history verdicts alone; the merge
is skipped) and through the port's plain step with an intra-batch phase
that commits exactly the eligible set, on the CPU. The statuses and the
`eligible`, `committed` and `overflow` info fields must be EQUAL; the
tolerance is zero, the outputs are integers. Two JAX programs are
compiled here, one per layout: a pooled batch at T=33 whose reads are
shuffled (the JAX step folds with `.at[rtxn].max`, so any order is valid
input) and a strided batch at T=2,048 with 4 read slots a txn, some of them
padding. Both cover txns without reads and snapshots below the floor. The
data varies by seed, the shapes do not.

`ref.build_table` is held to JAX `_build_table` at table widths on and off
K1's 1,024-column tile.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import conflict as jconf
from foundationdb_tpu.ops.batch import TxnConflictInfo
from foundationdb_tpu.utils import keys as jkeys
from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.utils import keys as tkeys

CPU = torch.device("cpu")
WINDOW = 5_000_000
OLDEST = 10_000
VERSION = 20_000
POOLED = jconf.ConflictShapes(capacity=512, txns=33, reads=132, writes=66)
STRIDED = jconf.ConflictShapes(capacity=1024, txns=2048, reads=8192,
                               writes=2048, strided=True)
INFO = ("overflow", "committed", "eligible")


@functools.lru_cache(maxsize=None)
def jax_only_hist(shapes):
    return jax.jit(functools.partial(jconf.conflict_step, shapes=shapes,
                                     max_write_life=WINDOW,
                                     ablate="only_hist"))


def make_space(rng, n):
    return sorted({rng.integers(97, 123, rng.integers(1, 7)).astype(np.uint8)
                   .tobytes() for _ in range(n)})


def make_state(rng, shapes, space):
    """A JAX-layout state (numpy) of about K/2 boundaries drawn from
    `space`, segment versions in [OLDEST, VERSION] or NEG."""
    K, L = shapes.capacity, shapes.limbs
    chosen = sorted(space[i] for i in rng.choice(len(space), K // 2 - 1,
                                                 replace=False))
    bkeys = np.full((L, K), 0xFFFFFFFF, dtype=np.uint32)
    bkeys[:, 0] = 0
    bkeys[:, 1:len(chosen) + 1] = np.stack(
        [jkeys.encode_key(k) for k in chosen], axis=1)
    nb = len(chosen) + 1
    bval = np.full(K, ref.NEG, dtype=np.int32)
    bval[:nb] = rng.integers(OLDEST, VERSION, nb)
    bval[:nb][rng.random(nb) < 0.2] = ref.NEG
    return {"bkeys": bkeys, "bval": bval, "nb": np.int32(nb),
            "oldest": np.int32(OLDEST),
            "table": np.asarray(jconf._build_table(jnp.asarray(bval))),
            "poisoned": np.bool_(False)}


def rand_range(rng, space):
    a = space[rng.integers(len(space))]
    kind = rng.integers(10)
    if kind < 5:
        return (a, a + b"\x00")  # point
    b = space[rng.integers(len(space))]
    if kind == 5:
        return (max(a, b), min(a, b))  # inverted (or empty)
    return (min(a, b), max(a, b) + b"\x00")


def make_batch(rng, shapes, space, shuffle):
    """A numpy batch from the JAX encoder: T - 2 txns (the last two slots
    are invalid), a quarter of them without reads, snapshots from 0 (below
    the floor) to VERSION. With `shuffle` the pooled read columns are put
    in a random order."""
    per = shapes.reads // shapes.txns
    txns = []
    for _ in range(shapes.txns - 2):
        n_reads = 0 if rng.random() < 0.25 else int(rng.integers(1, per + 1))
        txns.append(TxnConflictInfo(
            int(rng.integers(0, VERSION)),
            [rand_range(rng, space) for _ in range(n_reads)],
            [rand_range(rng, space)
             for _ in range(rng.integers(0, shapes.writes // shapes.txns + 1))]))
    enc = jconf.BatchEncoder(shapes)
    batch = {k: np.array(v) for k, v in
             enc.encode_batch(txns, VERSION + 1000).items()}
    if shuffle:
        p = rng.permutation(shapes.reads)
        for k in ("rb", "re"):
            batch[k] = np.ascontiguousarray(batch[k][:, p])
        batch["rtxn"] = np.ascontiguousarray(batch["rtxn"][p])
    return batch


def only_hist_phases(seen):
    """The plain phases, with the history verdicts kept in `seen` and an
    intra-batch phase that commits exactly the eligible set (the JAX
    step's `only_hist` ablation)."""
    def history_check(*a):
        seen["verdicts"] = ref.history_check(*a)
        return seen["verdicts"]

    def intra_sandwich(g, *_a, **_kw):
        return g, g, torch.ones((), dtype=torch.bool)
    return type(ref.PLAIN)(**dict(vars(ref.PLAIN), history_check=history_check,
                                  intra_sandwich=intra_sandwich))


def check_against_jax(shapes, seed, shuffle):
    rng = np.random.default_rng(seed)
    space = make_space(rng, 3 * shapes.capacity)
    state = make_state(rng, shapes, space)
    batch = make_batch(rng, shapes, space, shuffle)
    _jstate, jst, jinfo = jax_only_hist(shapes)(
        {k: jnp.asarray(v) for k, v in state.items()}, batch)
    seen = {}
    _tstate, tst, tinfo = ref.conflict_step(
        ref.state_from_numpy(state, CPU), ref.batch_from_numpy(batch, CPU),
        max_write_life=WINDOW, strided=shapes.strided,
        phases=only_hist_phases(seen))
    where = f"seed {seed}"
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst),
                                  err_msg=f"statuses {where}")
    for k in INFO:
        np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                      err_msg=f"info[{k}] {where}")
    # the inputs reach every case of the fold
    too_old, g0 = (v.numpy() for v in seen["verdicts"])
    T = shapes.txns
    if shapes.strided:
        owner = ref.strided_owners(torch.from_numpy(
            tkeys.to_signed_limbs(batch["rb"])), T).numpy()
    else:
        owner = batch["rtxn"]
    has_reads = np.zeros(T + 1, bool)
    has_reads[owner] = True
    valid = batch["txn_valid"]
    assert (valid & ~has_reads[:T]).any()  # valid txns without reads
    assert too_old.any() and g0.any()
    assert (valid & has_reads[:T] & ~too_old & ~g0).any()  # history hits
    assert (owner == T).any()  # padding read slots
    return owner


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_history_check_equals_jax_pooled_shuffled_reads(seed):
    owner = check_against_jax(POOLED, seed, shuffle=True)
    assert (np.diff(owner) < 0).any()  # rtxn is not sorted


@pytest.mark.parametrize("seed", [1, 2])
def test_history_check_equals_jax_strided(seed):
    check_against_jax(STRIDED, seed, shuffle=False)


@pytest.mark.parametrize("K", [1, 2, 1023, 1024, 1025, 2047, 2048, 2049,
                               4097, 16387])
def test_build_table_equals_jax(K):
    rng = np.random.default_rng(K)
    vals = rng.integers(ref.NEG, 1 << 30, K).astype(np.int32)
    vals[rng.random(K) < 0.1] = ref.NEG
    want = np.asarray(jconf._build_table(jnp.asarray(vals)))
    got = ref.build_table(torch.from_numpy(vals)).numpy()
    assert got.shape == want.shape == (ref.table_levels(K), K)
    np.testing.assert_array_equal(got, want)
