"""The port's sharded engine (foundationdb_tpu_torch.parallel) against the
JAX package's (foundationdb_tpu.parallel.sharded_conflict).

Every field is an integer, so equality is exact: the cuts, the clipped
ranges, the sharded step (each shard's state, the statuses and all five
`info` fields) on a mesh of W forced host devices against the port's
shards sharing the CPU, the engines' decisions, rebases and rebalances.
The port is also held to the clipped-oracle model (W oracles fed
shard-clipped ranges, min-combined) and to the no-false-commit rule, in
the engine and behind the Resolver role in the port's simulator. The JAX
side keeps to test_sharded.py's shape, so each mesh width compiles once.
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import conflict as jconf
from foundationdb_tpu.parallel import sharded_conflict as jsh
from foundationdb_tpu.utils import keys as jkeys
from foundationdb_tpu.utils.knobs import KNOBS as JKNOBS
from foundationdb_tpu_torch import bench
from foundationdb_tpu_torch.core import eventloop as t_eventloop
from foundationdb_tpu_torch.core import sim as t_sim
from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops import kernels
from foundationdb_tpu_torch.ops.batch import (COMMITTED, CONFLICT,
                                              TxnConflictInfo,
                                              validate_conflict_config)
from foundationdb_tpu_torch.ops.conflict import ConflictShapes
from foundationdb_tpu_torch.ops.conflict_oracle import OracleConflictSet
from foundationdb_tpu_torch.parallel import sharded_conflict as tsh
from foundationdb_tpu_torch.server import interfaces as t_interfaces
from foundationdb_tpu_torch.server import resolver as t_resolver
from foundationdb_tpu_torch.utils import keys as tkeys
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS
from foundationdb_tpu_torch.utils.rng import DeterministicRandom

CPU = torch.device("cpu")
SMALL = dict(capacity=256, txns=16, reads_per_txn=4, writes_per_txn=4)
T = SMALL["txns"]
JSHAPES = jconf.ConflictShapes(capacity=256, txns=T, reads=4 * T,
                               writes=4 * T)
TSHAPES = ConflictShapes(capacity=256, txns=T, reads=4 * T, writes=4 * T)
WINDOW = 5_000_000
ROUNDS = T // 2 + 1  # the engines' full sandwich rounds
STATE_FIELDS = ("bkeys", "bval", "nb", "oldest", "table", "poisoned", "lo",
                "hi")
INFO_FIELDS = ("overflow", "boundaries", "committed", "converged",
               "eligible")


@pytest.fixture(autouse=True)
def _reset_port_knobs():
    TKNOBS.reset()
    yield
    TKNOBS.reset()


def _random_batches(seed, n_batches, txns_per_batch, key_space=200, max_len=3):
    """test_sharded.py's trajectory (copied: tests do not import across
    files)."""
    rng = DeterministicRandom(seed)

    def rkey():
        n = rng.randint(1, max_len + 1)
        return bytes(rng.randint(0, key_space) % 256 for _ in range(n))

    def rrange():
        a, b = sorted([rkey(), rkey()])
        if a == b:
            b = a + b"\x00"
        return (a, b)

    batches = []
    version = 100
    for _ in range(n_batches):
        txns = []
        for _ in range(txns_per_batch):
            snap = version - rng.randint(0, 50)
            txns.append(TxnConflictInfo(
                read_snapshot=snap,
                read_ranges=[rrange() for _ in range(rng.randint(0, 3))],
                write_ranges=[rrange() for _ in range(rng.randint(0, 3))],
            ))
        batches.append((txns, version))
        version += rng.randint(1, 30)
    return batches


def _clip(rng_pair, lo, hi):
    b, e = rng_pair
    b2, e2 = max(b, lo), min(e, hi) if hi is not None else e
    return (b2, e2) if b2 < e2 else None


def _sharded_oracle_detect(oracles, cuts, txns, version):
    """The clipped-oracle model (test_sharded.py): W oracles fed the
    shard-clipped ranges (empty ones dropped), min-combined."""
    n = len(oracles)
    verdicts = []
    for d in range(n):
        lo = cuts[d]
        hi = cuts[d + 1] if d + 1 < n else None
        sub = [TxnConflictInfo(
            read_snapshot=t.read_snapshot,
            read_ranges=[r for r in (_clip(p, lo, hi) for p in t.read_ranges)
                         if r],
            write_ranges=[w for w in (_clip(p, lo, hi)
                                      for p in t.write_ranges) if w])
            for t in txns]
        verdicts.append(oracles[d].detect(sub, version))
    return [min(v[t] for v in verdicts) for t in range(len(txns))]


class _SafetyTracker:
    """No-false-commit checker over the engine's own decisions (copied from
    test_sharded.py): every committed txn had no overlapping committed
    write above its snapshot."""

    def __init__(self):
        self.writes: list[tuple[bytes, bytes, int]] = []

    def check_and_apply(self, txns, statuses, version):
        for t, s in zip(txns, statuses):
            if s != COMMITTED:
                continue
            for rb, re in t.read_ranges:
                for wb, we, wv in self.writes:
                    if wv > t.read_snapshot and rb < we and wb < re:
                        raise AssertionError(
                            f"false commit: read [{rb!r},{re!r}) snap "
                            f"{t.read_snapshot} vs write [{wb!r},{we!r})@{wv}")
        for t, s in zip(txns, statuses):
            if s == COMMITTED:
                for wb, we in t.write_ranges:
                    self.writes.append((wb, we, version))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _assert_states_equal(jstate, tstate, where):
    want = _np(jstate)
    got = ref.sharded_state_to_numpy(tstate)
    for k in STATE_FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} {where}")


def _engines(W, **kw):
    """The JAX engine on a W-device mesh and the port's on W CPU shards,
    plain phases (the kernels' wrappers run them on the CPU)."""
    j = jsh.ShardedDeviceConflictSet(mesh=jsh.make_resolver_mesh(W), **SMALL,
                                     **kw)
    t = tsh.ShardedDeviceConflictSet(devices=["cpu"] * W, **SMALL, **kw)
    return j, t


def _set_both(**kw):
    JKNOBS.overrides(**kw)
    TKNOBS.overrides(**kw)


# ---------------------------------------------------------------------------
# cuts and clipping
# ---------------------------------------------------------------------------

OWNED = [(b"", None), (b"a", b"m"), (b"user", None), (b"\x10\x00", b"\x20"),
         (b"\x00\x00\x00\x01", b"\x00\x00\x00\x03")]  # the last too narrow


@pytest.mark.parametrize("W", range(1, 9))
def test_cuts_equal_jax(W):
    assert tsh.shard_cut_bytes(W) == jsh.shard_cut_bytes(W)
    for begin, end in OWNED:
        assert (tsh.shard_cut_bytes_range(W, begin, end)
                == jsh.shard_cut_bytes_range(W, begin, end))
    got = tsh.shard_cut_keys(W)
    assert got.dtype == np.int32 and got.shape == (W + 1, tkeys.NUM_LIMBS)
    np.testing.assert_array_equal(
        got, tkeys.to_signed_limbs(jsh.shard_cut_keys(W)))
    assert (got[W] == ref.PAD_LIMB).all()  # the sentinel is the padding key


def _clip_inputs(rng, W, n=96):
    """uint32 (L, n) endpoint arrays drawn from the cut keys (the sentinel
    among them), keys one step below and above each cut, random keys and
    padding: ties at lo and hi, ranges below, above and across a cut."""
    cuts = jsh.shard_cut_keys(W)
    pool = [cuts[d] for d in range(W + 1)]
    for d in range(1, W):
        for delta in (-1, 1):
            k = cuts[d].copy()
            k[0] = np.uint32(int(k[0]) + delta)
            pool.append(k)
    pool += [jkeys.encode_key(bytes(rng.integers(0, 256, rng.integers(0, 8))
                                    .astype(np.uint8))) for _ in range(24)]
    pool = np.stack(pool, axis=1).astype(np.uint32)
    return [pool[:, rng.integers(0, pool.shape[1], n)] for _ in range(4)]


@pytest.mark.parametrize("W", [1, 2, 4, 8])
def test_clip_ranges_equal_jax(W):
    rng = np.random.default_rng(W)
    rb, re, wb, we = _clip_inputs(rng, W)
    cuts = jsh.shard_cut_keys(W)
    lo, hi = cuts[:W], cuts[1:]
    signed = [torch.from_numpy(tkeys.to_signed_limbs(x))
              for x in (rb, re, wb, we, lo, hi)]
    got = ref.clip_ranges(*signed)
    kernels.reset_launches()
    for g, k in zip(got, kernels.clip_ranges(*signed)):  # plain on the CPU
        assert torch.equal(g, k)
    assert kernels.LAUNCHES["shard_clip"] == 0
    for d in range(W):
        for (b, e), (gb, ge) in (((rb, re), got[:2]), ((wb, we), got[2:])):
            jb, je = jsh._clip_ranges(b, e, lo[d], hi[d])
            np.testing.assert_array_equal(
                tkeys.from_signed_limbs(gb[d].numpy()), np.asarray(jb))
            np.testing.assert_array_equal(
                tkeys.from_signed_limbs(ge[d].numpy()), np.asarray(je))
        assert got[0][d].is_contiguous()


@pytest.mark.parametrize("W", [1, 3, 8])
def test_shard_combine_is_the_proxy_rule(W):
    rng = np.random.default_rng(10 + W)
    n = 40
    st = [torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
          for _ in range(W)]
    el = [torch.from_numpy(rng.random(n) < 0.8) for _ in range(W)]
    ov = [torch.tensor(bool(rng.random() < 0.2)) for _ in range(W)]
    bd = [torch.tensor(int(rng.integers(0, 500)), dtype=torch.int32)
          for _ in range(W)]
    cv = [torch.tensor(bool(rng.random() < 0.9)) for _ in range(W)]
    valid = torch.from_numpy(rng.random(n) < 0.7)
    statuses, info, row = kernels.shard_combine(st, el, ov, bd, cv, valid)
    want = np.min(np.stack([s.numpy() for s in st]), axis=0)
    # the readback row the engine's chunk built from the combine's outputs
    # before K11 wrote it (four casts and a cat)
    np.testing.assert_array_equal(row.numpy(), torch.cat([
        statuses.to(torch.int32), info["eligible"].to(torch.int32),
        info["overflow"].to(torch.int32).reshape(1),
        info["converged"].to(torch.int32).reshape(1)]).numpy())
    assert row.dtype == torch.int32 and row.shape == (2 * n + 2,)
    assert statuses.data_ptr() == row.data_ptr()  # a view of its head
    np.testing.assert_array_equal(statuses.numpy(), want)
    assert statuses.dtype == torch.int32 and list(info) == list(INFO_FIELDS)
    assert int(info["committed"]) == int(((want == 2) & valid.numpy()).sum())
    assert bool(info["overflow"]) == any(bool(o) for o in ov)
    assert bool(info["converged"]) == all(bool(c) for c in cv)
    assert int(info["boundaries"]) == max(int(b) for b in bd)
    np.testing.assert_array_equal(
        info["eligible"].numpy(), np.all(np.stack([e.numpy() for e in el]), 0))
    assert kernels.LAUNCHES["shard_combine"] == 0


# ---------------------------------------------------------------------------
# the step and the engine against JAX
# ---------------------------------------------------------------------------

def _cut_heavy_batches(seed, W, n_batches):
    """Pooled batches whose ranges begin and end at the cuts, inside one
    shard, or across several; some inverted or empty."""
    rng = np.random.default_rng(seed)
    cuts = [c for c in jsh.shard_cut_bytes(W)[1:]]
    pool = cuts + [c + b"\x00" for c in cuts] + [
        bytes(rng.integers(0, 256, rng.integers(1, 5)).astype(np.uint8))
        for _ in range(60)]

    def rrange():
        a, b = (pool[i] for i in rng.integers(0, len(pool), 2))
        kind = rng.integers(6)
        if kind == 0:
            return (max(a, b), min(a, b))  # inverted or empty
        if kind == 1:
            return (a, a + b"\x00")
        return (min(a, b), max(a, b) + b"\x00")

    out, version = [], 1000
    for _ in range(n_batches):
        version += int(rng.integers(1, 5)) * 100
        out.append(([TxnConflictInfo(
            version - int(rng.integers(0, 600)),
            [rrange() for _ in range(rng.integers(0, 4))],
            [rrange() for _ in range(rng.integers(0, 4))])
            for _ in range(int(rng.integers(1, T + 1)))], version))
    return out


@pytest.mark.parametrize("W", [1, 2, 4, 8])
def test_sharded_step_equals_jax(W):
    mesh = jsh.make_resolver_mesh(W)
    jstep = jsh.sharded_conflict_step(mesh, JSHAPES, WINDOW, "scan", ROUNDS)
    tstep = tsh.sharded_conflict_step([CPU] * W, TSHAPES, WINDOW, "scan",
                                      ROUNDS, phases=ref.PLAIN)
    jstate = jsh.init_sharded_state(JSHAPES, W, mesh=mesh)
    tstate = ref.sharded_state_from_numpy(_np(jstate), [CPU] * W)
    _assert_states_equal(jstate, tstate, "initial")
    enc = jconf.BatchEncoder(JSHAPES)
    saw_conflict = False
    for i, (txns, version) in enumerate(_cut_heavy_batches(W, W, 10)):
        nb = {k: np.array(v) for k, v in enc.encode_batch(txns, version).items()}
        jstate, jst, jinfo = jstep(jstate, nb)
        tstate, tst, tinfo = tstep(tstate, ref.batch_from_numpy(nb, CPU))
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst),
                                      err_msg=f"statuses, batch {i}")
        assert sorted(tinfo) == sorted(jinfo)
        for k in INFO_FIELDS:
            np.testing.assert_array_equal(tinfo[k].numpy(),
                                          np.asarray(jinfo[k]),
                                          err_msg=f"info {k}, batch {i}")
        _assert_states_equal(jstate, tstate, f"after batch {i}")
        saw_conflict |= bool((tst.numpy()[:len(txns)] == CONFLICT).any())
    assert saw_conflict


@pytest.mark.parametrize("W,seed", [(1, 1), (2, 2), (4, 7), (8, 3)])
def test_engine_equals_jax_through_rebase_and_clear(W, seed):
    j, t = _engines(W)
    batches = _random_batches(seed, n_batches=12, txns_per_batch=10)
    jump = (1 << 29) + 12_345  # past the rebase threshold: both rebase
    batches = batches[:6] + [(txns, v + jump) for txns, v in batches[6:]]
    for i, (txns, version) in enumerate(batches):
        assert t.detect(txns, version) == j.detect(txns, version), i
    assert t.base_version == j.base_version > 0
    assert t.oldest_version == j.oldest_version
    _assert_states_equal(j._state, t._state, "after the jump")
    v0 = batches[-1][1] + 10
    j.clear(oldest_version=v0)
    t.clear(oldest_version=v0)
    for txns, version in _random_batches(seed + 50, 3, 10):
        assert t.detect(txns, version + v0) == j.detect(txns, version + v0)
    _assert_states_equal(j._state, t._state, "after clear")


def _buffer_ptrs(state):
    return ([{k: v.data_ptr() for k, v in sh.items()}
             for sh in state["shards"]],
            state["lo"].data_ptr(), state["hi"].data_ptr())


# the re-cut of each width: new cuts inside the test keys' first byte
RECUTS = {1: [b""], 2: [b"", b"\x60"], 4: [b"", b"\x20", b"\x60", b"\x90"]}


@pytest.mark.parametrize("W,seed", [(1, 4), (2, 5), (4, 6)])
def test_sharded_program_equals_the_step_and_jax_through_rebase_recut_clear(
        W, seed):
    """The engine runs every chunk through its `ShardedStepGraph` (eagerly
    on the CPU) over fixed buffers. Each chunk's row, info and state equal
    the functional `_sharded_step` from a copy of the state before it; the
    engine's decisions and state equal the JAX engine's through a version
    jump (every shard rebases), a re-cut and a clear; the buffers never
    move."""
    j, t = _engines(W)
    prog = t._program
    assert not t.graphed and not prog.graphed
    ptrs = _buffer_ptrs(t._state)
    assert prog.state is t._state
    run, checked = prog.run, [0]

    def run_checked():
        before = tsh.clone_sharded_state(prog.state)
        batch = {k: v.clone() for k, v in prog.batch.items()}
        want_state, want_st, want_info = tsh._sharded_step(
            before, batch, **prog.step_kw)
        row, info = run()
        assert torch.equal(row[:T], want_st)
        assert row.shape == (2 * T + 2,) and row.dtype == torch.int32
        assert int(row[2 * T]) == int(want_info["overflow"])
        assert int(row[2 * T + 1]) == int(want_info["converged"])
        assert torch.equal(row[T:2 * T], want_info["eligible"].to(torch.int32))
        for k in INFO_FIELDS:
            assert torch.equal(info[k], want_info[k]), k
        got = ref.sharded_state_to_numpy(prog.state)
        for k, v in ref.sharded_state_to_numpy(want_state).items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        checked[0] += 1
        return row, info
    prog.run = run_checked
    batches = _random_batches(seed, n_batches=12, txns_per_batch=10)
    jump = (1 << 29) + 777  # past the rebase threshold: every shard rebases
    batches = batches[:5] + [(txns, v + jump) for txns, v in batches[5:]]
    for i, (txns, version) in enumerate(batches):
        if i == 8:
            for eng in (j, t):
                eng.rebalance_cuts(RECUTS[W], version)
            assert t.cut_bytes == j.cut_bytes == RECUTS[W]
        assert t.detect(txns, version) == j.detect(txns, version), i
    assert t.base_version == j.base_version > 0
    _assert_states_equal(j._state, t._state, "after the jump and the re-cut")
    v0 = batches[-1][1] + 10
    j.clear(oldest_version=v0)
    t.clear(oldest_version=v0)
    _assert_states_equal(j._state, t._state, "cleared")
    for txns, version in _random_batches(seed + 50, 3, 10):
        assert t.detect(txns, version + v0) == j.detect(txns, version + v0)
    _assert_states_equal(j._state, t._state, "after clear")
    assert checked[0] == 12 + 3
    assert _buffer_ptrs(t._state) == ptrs


def test_the_engine_graphs_a_chunk_where_every_shard_shares_a_card():
    """The one rule the engine and the bench share: a graph needs every
    shard on one CUDA card and the kernels' phases, however the caller
    named them."""
    c0, c1 = torch.device("cuda:0"), torch.device("cuda:1")
    assert tsh.graph_fits([c0] * 4, kernels.PHASES)
    assert not tsh.graph_fits([c0, c1], kernels.PHASES)
    assert not tsh.graph_fits([c0] * 2, ref.PLAIN)
    assert not tsh.graph_fits([CPU] * 2, kernels.PHASES)
    eng = tsh.ShardedDeviceConflictSet(devices=["cpu"] * 2, capacity=1024,
                                       txns=T, phases=kernels.PHASES)
    assert not eng.graphed and not eng._program.graphed


def test_sharded_program_refuses_a_graph_off_the_card():
    state = tsh.init_sharded_state(TSHAPES, [CPU] * 2)
    kw = dict(txns=T, reads=4 * T, writes=4 * T, max_write_life=WINDOW)
    with pytest.raises(FDBError) as ei:  # a CUDA graph of CPU shards
        tsh.ShardedStepGraph(state, **kw)
    assert ei.value.name == "invalid_option"
    with pytest.raises(FDBError) as ei:
        tsh.ShardedStepGraph(state, intra_mode="dense", graphed=False, **kw)
    assert ei.value.name == "invalid_option"


# ---------------------------------------------------------------------------
# resolutionBalancing against JAX
# ---------------------------------------------------------------------------

def _skewed_batches(seed, n_batches, first_byte=3, prefix=b""):
    """test_sharded.py's skewed load: every key begins with `first_byte`
    (all the load on one shard)."""
    rng = DeterministicRandom(seed)
    version, out = 100, []
    for _ in range(n_batches):
        txns = []
        for _ in range(8):
            a = prefix + bytes([first_byte]) + bytes(
                [rng.randint(0, 255) % 256 for _ in range(2)])
            b = a + b"\x00"
            txns.append(TxnConflictInfo(
                read_snapshot=version - rng.randint(0, 50),
                read_ranges=[(a, b)], write_ranges=[(a, b)]))
        version += 10
        out.append((txns, version))
    return out


@pytest.mark.parametrize("W", [4, 8])
def test_load_rebalance_equals_jax(W):
    _set_both(RESOLUTION_BALANCE_CHECK_BATCHES=4,
              RESOLUTION_BALANCE_MIN_SAMPLES=64)
    j, t = _engines(W)
    tracker = _SafetyTracker()
    for i, (txns, version) in enumerate(_skewed_batches(42, 24)):
        got = t.detect(txns, version)
        assert got == j.detect(txns, version), i
        tracker.check_and_apply(txns, got, version)
        assert t.cut_bytes == j.cut_bytes and t.rebalances == j.rebalances
    assert t.rebalances >= 1
    assert t.cut_bytes != tsh.shard_cut_bytes(W)
    _assert_states_equal(j._state, t._state, "after the rebalances")


def test_one_shared_prefix_declines_as_jax():
    """YCSB-style keys ("user" + hash) share their first 4 bytes: the load
    planner's quantiles land on one prefix, and both engines keep their
    cuts (no cut can split one 4-byte prefix)."""
    _set_both(RESOLUTION_BALANCE_CHECK_BATCHES=4,
              RESOLUTION_BALANCE_MIN_SAMPLES=64)
    j, t = _engines(4)
    for txns, version in _skewed_batches(5, 12, first_byte=7, prefix=b"user"):
        assert t.detect(txns, version) == j.detect(txns, version)
    assert t.rebalances == j.rebalances == 0
    assert t._load_counts.tolist() == j._load_counts.tolist()


def test_conflict_rebalance_equals_jax():
    j, t = _engines(4)
    before = list(t.cut_bytes)
    hot = [(b"\x01", b"\x02", 50.0), (b"\x02", b"\x03", 30.0),
           (b"\x03", b"\x04", 20.0), (b"\x90", b"\x91", 5.0)]
    txns = [TxnConflictInfo(0, [], [(b"\x01a", b"\x01b"), (b"\x95", b"\x96")])]
    assert t.detect(txns, 50) == j.detect(txns, 50)
    assert t.rebalance_from_conflicts(hot) is j.rebalance_from_conflicts(hot)
    assert t._pending_cuts == j._pending_cuts is not None
    assert t.cut_bytes == before  # scheduled, not applied
    txns = [TxnConflictInfo(40, [(b"\x01a", b"\x01b")],
                            [(b"\x02a", b"\x02b")])]
    assert t.detect(txns, 100) == j.detect(txns, 100)
    assert t.cut_bytes == j.cut_bytes != before and t.rebalances == 1
    _assert_states_equal(j._state, t._state, "after the re-cut")
    # mass on one prefix cannot be split: both decline
    one = [(b"\x05", b"\x05\x01", 100.0)]
    assert t.rebalance_from_conflicts(one) is j.rebalance_from_conflicts(
        one) is False


# ---------------------------------------------------------------------------
# safety (the port alone)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 7])
def test_sharded_matches_clipped_oracles(seed):
    """Exact parity with the clipped-oracle model at W=8, and no false
    commit against the single-device engine."""
    from foundationdb_tpu_torch.ops.conflict import DeviceConflictSet
    W = 8
    cuts = tsh.shard_cut_bytes(W)
    sharded = tsh.ShardedDeviceConflictSet(devices=["cpu"] * W, **SMALL)
    single = DeviceConflictSet(device="cpu", **SMALL)
    oracles = [OracleConflictSet() for _ in range(W)]
    for txns, version in _random_batches(seed, n_batches=12,
                                         txns_per_batch=10):
        got = sharded.detect(txns, version)
        assert got == _sharded_oracle_detect(oracles, cuts, txns, version)
        for g, b in zip(got, single.detect(txns, version)):
            if g == COMMITTED:
                assert b == COMMITTED


def test_safe_false_conflict_at_shard_cut():
    """A txn aborted on shard 0 still leaves its shard-1 write there, so a
    later txn of the batch reading it gets a conservative CONFLICT."""
    from foundationdb_tpu_torch.ops.conflict import DeviceConflictSet
    small = dict(capacity=64, txns=4, reads_per_txn=2, writes_per_txn=2)
    sharded = tsh.ShardedDeviceConflictSet(devices=["cpu"] * 8, **small)
    single = DeviceConflictSet(device="cpu", **small)
    seedw = [TxnConflictInfo(read_snapshot=0,
                             write_ranges=[(b"\x10", b"\x11")])]
    assert sharded.detect(seedw, 10) == single.detect(seedw, 10) == [COMMITTED]
    batch = [TxnConflictInfo(read_snapshot=5, read_ranges=[(b"\x10", b"\x11")],
                             write_ranges=[(b"\x30", b"\x31")]),
             TxnConflictInfo(read_snapshot=10,
                             read_ranges=[(b"\x30", b"\x31")])]
    assert single.detect(batch, 20) == [CONFLICT, COMMITTED]
    assert sharded.detect(batch, 20) == [CONFLICT, CONFLICT]


def test_write_to_the_top_of_the_keyspace_on_the_last_shard():
    """The last shard's hi is the all-ones sentinel, which equals the
    padding key: writes that end at the top of the keyspace (an end key
    longer than the key width) stay writes, and a later stale read of them
    conflicts."""
    cs = tsh.ShardedDeviceConflictSet(devices=["cpu"] * 4, **SMALL)
    top = b"\xff" * 30
    w = [TxnConflictInfo(0, [], [(b"\xf0", top)]),
         TxnConflictInfo(0, [], [(b"\x00", top)])]
    assert cs.detect(w, 10) == [COMMITTED, COMMITTED]
    for k in (b"\x01", b"\x80", b"\xf5", b"\xff" * 24):
        got = cs.detect([TxnConflictInfo(5, [(k, k + b"\x00")], [])], 20)
        assert got == [CONFLICT], k


def test_rebalance_stays_safe():
    TKNOBS.overrides(RESOLUTION_BALANCE_CHECK_BATCHES=4,
                     RESOLUTION_BALANCE_MIN_SAMPLES=64)
    cs = tsh.ShardedDeviceConflictSet(devices=["cpu"] * 8, **SMALL)
    tracker = _SafetyTracker()
    version = 0
    for txns, version in _skewed_batches(42, 40):
        tracker.check_and_apply(txns, cs.detect(txns, version), version)
    assert cs.rebalances >= 1
    assert cs.detect([TxnConflictInfo(version, [(b"\x03xx", b"\x03xy")])],
                     version + 10) == [COMMITTED]


# ---------------------------------------------------------------------------
# the Resolver role, the bench, validation
# ---------------------------------------------------------------------------

def test_resolver_sharded_backend_in_the_sim():
    """CONFLICT_BACKEND=sharded on 4 CPU shards behind the port's Resolver:
    replies equal the clipped-oracle model until the first re-cut and are
    never a false commit after; the balance loop re-cuts on the conflict
    mass (all of it on shard 1's keys) and CutRebalances counts it."""
    TKNOBS.overrides(CONFLICT_BACKEND="sharded", CONFLICT_DEVICE="cpu",
                     CONFLICT_NUM_SHARDS=4, CONFLICT_STATE_CAPACITY=1024,
                     CONFLICT_BATCH_TXNS=64, RESOLUTION_BALANCE_EPOCH_SECONDS=2.0)
    loop = t_eventloop.EventLoop()
    net = t_sim.SimNetwork(loop, DeterministicRandom(3))
    proc = net.new_process("resolver")
    proxy = net.new_process("proxy")
    resolver = t_resolver.Resolver(proc)
    cs = resolver.conflict_set
    assert cs.backend_label == "cpux4" and cs.n_shards == 4
    recuts = []
    apply = cs.rebalance_cuts

    def record(cuts, at_version):
        recuts.append(at_version)
        apply(cuts, at_version)
    cs.rebalance_cuts = record
    space = [b"k%03d" % i for i in range(60)]  # all on shard 1 (0x6b)
    rng = np.random.default_rng(4)
    stream, prev = [], 0
    for _ in range(14):
        version = prev + 1000
        stream.append((prev, version, [TxnConflictInfo(
            max(0, prev - 1000 * int(rng.integers(0, 3))),
            [(space[k], space[k] + b"\x00") for k in rng.integers(0, 60, 2)],
            [(space[k], space[k] + b"\x00") for k in rng.integers(0, 60, 2)])
            for _ in range(40)]))
        prev = version
    ep = t_sim.Endpoint("resolver", t_interfaces.Token.RESOLVER_RESOLVE)

    async def drive():
        out = []
        for prev, version, txns in stream:
            req = t_interfaces.ResolveTransactionBatchRequest(
                prev_version=prev, version=version, last_receive_version=prev,
                transactions=txns)
            out.append((await net.request(proxy, ep, req)).committed)
            await loop.delay(1.0)  # the balance loop's epochs pass
        return out
    replies = loop.run_future(proxy.spawn(drive(), "requests"),
                              max_time=600.0)
    assert recuts, "the balance loop never re-cut"
    assert resolver.counters.as_dict()["CutRebalances"] >= 1
    cuts = tsh.shard_cut_bytes(4)
    oracles = [OracleConflictSet() for _ in range(4)]
    tracker = _SafetyTracker()
    for (prev, version, txns), got in zip(stream, replies):
        if version < recuts[0]:
            assert got == _sharded_oracle_detect(oracles, cuts, txns, version)
        tracker.check_and_apply(txns, got, version)
    assert any(s == CONFLICT for r in replies for s in r)
    resolver.shutdown()


def test_spread_batches_equal_the_root_bench():
    import bench as root_bench
    want = root_bench._encode_spread_batches(3, seed=2, version0=100, T=32)
    got = bench._encode_spread_batches(3, seed=2, version0=100, T=32)
    for k, v in want.items():
        if k in ("rb", "re", "wb", "we"):
            v = tkeys.to_signed_limbs(v)
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_sharded_bench_at_width_1_equals_the_unsharded_step():
    detail: dict = {}
    out = bench.run_sharded_kernel(32, 4, 1, capacity=1024, devices=["cpu"],
                                   detail=detail)
    assert out["n_shards"] == 1 and out["batches"] == 4
    assert 0.0 < out["committed_frac"] <= 1.0
    state = ref.init_state(1024, tkeys.NUM_LIMBS, CPU)
    for i, b in enumerate([detail["warm"]] + detail["batches"]):
        state, st, _info = ref.conflict_step(
            state, b, max_write_life=WINDOW, intra_rounds=32 // 2 + 1,
            strided=True)
        if i:
            assert torch.equal(st, detail["statuses"][i - 1]), i
    got = ref.sharded_state_to_numpy(detail["state"])
    for k, v in ref.state_to_numpy(state).items():
        np.testing.assert_array_equal(got[k][0], v, err_msg=k)


def test_conflict_config_validation():
    validate_conflict_config("sharded", 0)
    validate_conflict_config("oracle", 8)
    for bad in ("skiplist", "", "SHARDED"):
        with pytest.raises(FDBError) as ei:
            validate_conflict_config(bad, 0)
        assert ei.value.name == "invalid_option"
    for bad_n in (-1, 2.5, "4", True):
        with pytest.raises(FDBError) as ei:
            validate_conflict_config("sharded", bad_n)
        assert ei.value.name == "invalid_option"
    TKNOBS.set("CONFLICT_NUM_SHARDS", -2)
    with pytest.raises(FDBError):
        t_resolver.new_conflict_set()


def test_cuda_shards_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tsh.make_resolver_mesh(2, "cuda"),
                 lambda: tsh.ShardedDeviceConflictSet(devices=["cuda"] * 2,
                                                      **SMALL)):
        with pytest.raises(FDBError) as ei:
            make()
        assert ei.value.name == "platform_error"


def test_num_shards_over_the_attached_cards_is_rejected(monkeypatch):
    TKNOBS.overrides(CONFLICT_BACKEND="sharded", CONFLICT_DEVICE="cuda",
                     CONFLICT_NUM_SHARDS=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(FDBError) as ei:
        t_resolver.new_conflict_set()
    assert ei.value.name == "invalid_option"
    assert [str(d) for d in tsh.make_resolver_mesh(0, "cuda")] == [
        "cuda:0", "cuda:1"]
    assert tsh.make_resolver_mesh(3, "cpu") == [CPU] * 3
