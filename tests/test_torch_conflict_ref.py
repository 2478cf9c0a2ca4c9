"""The port's plain PyTorch conflict step against the JAX `conflict_step`.

Seeded numpy trajectories of batches at K=1024, T=64, 4 reads and 4 writes a
transaction go through the jitted JAX step on the CPU and through
foundationdb_tpu_torch.ops.conflict_ref on the CPU. The JAX state is carried
over with `state_from_numpy` before each step, the same encoded batch feeds
both, and after every step the new state (bkeys, bval, nb, oldest, table,
poisoned), the statuses and every `info` field must be EQUAL. Outputs are
compared, never sort permutations (`lax.sort` is unstable).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from foundationdb_tpu.ops import conflict as jconf
from foundationdb_tpu.ops.batch import TxnConflictInfo
from foundationdb_tpu.utils import keys as jkeys
from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.utils import keys as tkeys
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS

CPU = torch.device("cpu")
SHAPES = jconf.ConflictShapes(capacity=1024, txns=64, reads=256, writes=256)
# the default MVCC window: the JAX program compiled here is the one every
# port test file shares (one cold compile per process)
WINDOW = 5_000_000
STEP = 500_000  # mean version advance a batch: the floor clamps within a run


@pytest.fixture(autouse=True)
def _reset_port_knobs():
    TKNOBS.reset()
    yield
    TKNOBS.reset()


def rand_bytes(rng, lo, hi, n):
    """n random bytes in [lo, hi)."""
    return rng.integers(lo, hi, n).astype(np.uint8).tobytes()


def jax_step():
    return jconf._compiled_step(SHAPES, WINDOW)


def to_np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def assert_state_equal(jstate, tstate, where):
    want = to_np(jstate)
    got = ref.state_to_numpy(tstate)
    for k in ("bkeys", "bval", "nb", "oldest", "table", "poisoned"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} {where}")


def make_space(rng, n_keys, long_frac=0.0):
    """Sorted distinct keys of 1-12 bytes; a `long_frac` share are >24-byte
    keys sharing a 24-byte prefix (they collapse onto one encoded key)."""
    keys = set()
    prefix = b"P" * 24
    while len(keys) < n_keys:
        if rng.random() < long_frac:
            keys.add(prefix + rand_bytes(rng, 97, 100, rng.integers(1, 4)))
        else:
            keys.add(rand_bytes(rng, 97, 123, rng.integers(1, 12)))
    return sorted(keys)


def rand_range(rng, space):
    a = space[rng.integers(len(space))]
    kind = rng.integers(10)
    if kind < 5:
        return (a, a + b"\x00")  # point
    b = space[rng.integers(len(space))]
    if kind == 5:
        return (max(a, b), min(a, b))  # inverted (or empty when a == b)
    if kind == 6:
        return (a, a)  # empty
    return (min(a, b), max(a, b) + b"\x00")


def rand_batch(rng, space, version, n_txns, dense=False):
    txns = []
    for _ in range(n_txns):
        snap = max(0, version - int(rng.integers(0, 8 * STEP)))
        if dense:  # blind point writes: every one adds boundaries
            keys = [space[i] for i in rng.integers(0, len(space), 4)]
            txns.append(TxnConflictInfo(snap, [], [(k, k + b"\x00")
                                                   for k in keys]))
            continue
        reads = [rand_range(rng, space) for _ in range(rng.integers(0, 5))]
        writes = [rand_range(rng, space) for _ in range(rng.integers(0, 5))]
        txns.append(TxnConflictInfo(snap, reads, writes))
    return txns


def encode(txns, version):
    """One pooled-layout numpy batch from the JAX encoder (copied out of its
    reusable ring slot)."""
    enc = jconf.BatchEncoder(SHAPES)
    return {k: np.array(v) for k, v in enc.encode_batch(txns, version).items()}


def run_trajectory(seed, n_keys, steps, long_frac=0.0, rebase_at=(),
                   chunk_every=0, dense=False):
    rng = np.random.default_rng(seed)
    space = make_space(rng, n_keys, long_frac)
    step = jax_step()
    jstate = jconf.init_state(SHAPES)
    tstate = ref.state_from_numpy(to_np(jstate), CPU)
    version = STEP
    saw = {"poison": False, "conflict": False, "floor_held": False}
    for i in range(steps):
        if i in rebase_at:
            jstate = jconf.rebase_state(jstate, jnp.int32(3 * STEP))
            tstate = ref.rebase_state(tstate, 3 * STEP)
            version -= 3 * STEP
            assert_state_equal(jstate, tstate, f"after rebase {i}")
        version += STEP // 20 if dense else int(rng.integers(STEP // 4,
                                                              3 * STEP))
        n_txns = SHAPES.txns if dense else int(rng.integers(1, SHAPES.txns + 1))
        batch = encode(rand_batch(rng, space, version, n_txns, dense), version)
        if chunk_every and i % chunk_every:
            # a non-final chunk of a logical batch: the floor must not move
            batch["advance_floor"] = np.bool_(False)
            saw["floor_held"] = True
        tstate = ref.state_from_numpy(to_np(jstate), CPU)
        jstate, jst, jinfo = step(jstate, batch)
        tstate, tst, tinfo = ref.conflict_step(
            tstate, ref.batch_from_numpy(batch, CPU), max_write_life=WINDOW)
        where = f"seed {seed} step {i}"
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst),
                                      err_msg=f"statuses {where}")
        for k in ("overflow", "boundaries", "committed", "converged",
                  "eligible"):
            np.testing.assert_array_equal(
                tinfo[k].numpy(), np.asarray(jinfo[k]),
                err_msg=f"info[{k}] {where}")
        assert_state_equal(jstate, tstate, where)
        saw["poison"] |= bool(tinfo["overflow"])
        saw["conflict"] |= bool((tst == 0).any())
    return saw


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_step_parity_random_trajectories(seed):
    saw = run_trajectory(seed, n_keys=300, steps=10, chunk_every=3)
    assert saw["conflict"] and saw["floor_held"]


def test_step_parity_overflow_poisons():
    # 64 txns x 4 writes over a wide keyspace add hundreds of boundaries a
    # step: K=1024 overflows within the window, and the poison sticks
    saw = run_trajectory(7, n_keys=20000, steps=6, dense=True)
    assert saw["poison"]


def test_step_parity_rebase_and_long_keys():
    saw = run_trajectory(11, n_keys=200, steps=8, long_frac=0.3,
                         rebase_at=(3, 6))
    assert saw["conflict"]


def test_table_and_range_max_match_jax():
    rng = np.random.default_rng(5)
    for K in (1, 2, 5, 1024, 1500):
        vals = rng.integers(-(1 << 30), 1 << 20, K).astype(np.int32)
        want = np.array(jconf._build_table(jnp.asarray(vals)))
        got = ref.build_table(torch.from_numpy(vals)).numpy()
        np.testing.assert_array_equal(got, want)
        i0 = rng.integers(0, K, 500).astype(np.int32)
        i1 = np.minimum(i0 + rng.integers(1, K + 1, 500), K).astype(np.int32)
        np.testing.assert_array_equal(
            ref.range_max(torch.from_numpy(want), torch.from_numpy(i0),
                          torch.from_numpy(i1)).numpy(),
            np.asarray(jconf._range_max(jnp.asarray(want), jnp.asarray(i0),
                                        jnp.asarray(i1))))


@pytest.mark.parametrize("round_up", [False, True])
def test_bulk_key_encoder_matches_jax(round_up):
    rng = np.random.default_rng(3)
    keys = [b"", b"\x00", b"\xff" * 30, b"a" * 24, b"a" * 25, b"a" * 23]
    keys += [rand_bytes(rng, 0, 256, rng.integers(0, 40))
             for _ in range(300)]
    for key_bytes in (24, 8, 64):
        want = np.stack([jkeys.encode_key(k, round_up=round_up,
                                          key_bytes=key_bytes)
                         for k in keys], axis=1)
        got = tkeys.encode_keys_bulk(keys, key_bytes, round_up=round_up)
        np.testing.assert_array_equal(got, want)
        one = [tkeys.encode_key(k, round_up=round_up, key_bytes=key_bytes)
               for k in keys]
        np.testing.assert_array_equal(np.stack(one, axis=1), want)
