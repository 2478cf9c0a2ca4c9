"""The step's glue (`step_masks`, the first part of K2's phase
`masks_and_history`, and K13 `step_verdicts`), the fixed state buffers and
the step / scan programs of ops/step_graph.py, on the CPU.

- `step_masks` and `step_verdicts` (the plain versions the kernels are held
  to) against the JAX expressions they replace, `_combine_fn`'s readback
  row among them, on seeded numpy inputs.
- The step with `out=` (the state's fixed buffers, the counterpart of the
  JAX step's donated state) over trajectories that overflow and rebase
  equals the step into new tensors and the JAX step, and the buffers keep
  their addresses through steps, rebases and clears.
- The engine (`DeviceConflictSet(device="cpu")`), now writing its fixed
  buffers, against the oracle.
- The step and scan programs in their eager mode (the CPU's only mode):
  equal to the plain step and to the JAX scan, their launch accounting,
  and their refusals (an unknown evaluator or ablation, a graph on the
  CPU); both programs with the legacy evaluator against the eager step.
The card tests of the graphs and of K2/K13 are in test_torch_kernels.py,
which imports no JAX and so runs on the machine with the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import conflict as jconf
from foundationdb_tpu.ops.batch import TxnConflictInfo as JTxn
from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops import kernels
from foundationdb_tpu_torch.ops import step_graph as sg
from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
from foundationdb_tpu_torch.ops.conflict import DeviceConflictSet
from foundationdb_tpu_torch.ops.conflict_oracle import OracleConflictSet
from foundationdb_tpu_torch.utils import cudaenv
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS

CPU = torch.device("cpu")
WINDOW = 5_000_000
STEP = 500_000
INFO = ("overflow", "boundaries", "committed", "converged", "eligible")
SHAPES = {
    "pooled": jconf.ConflictShapes(capacity=256, txns=32, reads=96,
                                   writes=96),
    "strided": jconf.ConflictShapes(capacity=256, txns=32, reads=64,
                                    writes=64, strided=True)}
# the phases each step runs once, by the kernel each one launches
STEP_PHASES = {"sort_and_rank": "endpoint_sort",
               "masks_and_history": "masks_and_history",
               "intra_levels": "intra_levels",
               "intra_sandwich": "intra_sandwich",
               "merge_compact": "merge_compact", "build_table": "sparse_table",
               "step_verdicts": "step_verdicts"}


@pytest.fixture(autouse=True)
def _reset_port_knobs():
    TKNOBS.reset()
    yield
    TKNOBS.reset()


def to_np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def assert_state_equal(a: dict, b: dict, where):
    for k in ref._STATE_FIELDS:
        assert torch.equal(a[k].cpu(), b[k].cpu()), f"{k} {where}"


def assert_jax_state(jstate, tstate, where):
    got, want = ref.state_to_numpy(tstate), to_np(jstate)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} {where}")


def rand_range(rng, space):
    a = space[rng.integers(len(space))]
    kind = rng.integers(10)
    if kind < 5:
        return (a, a + b"\x00")
    if kind == 5:
        return (a, a)
    b = space[rng.integers(len(space))]
    if kind == 6:
        return (max(a, b), min(a, b))
    return (min(a, b), max(a, b) + b"\x00")


def rand_txns(rng, space, version, per_txn, n, dense=False, cls=JTxn):
    out = []
    for _ in range(n):
        snap = max(0, version - int(rng.integers(0, 16 * STEP)))
        if dense:  # blind point writes of fresh keys: the state fills up
            keys = [b"d%09d" % rng.integers(10 ** 9) for _ in range(per_txn)]
            out.append(cls(snap, [], [(k, k + b"\x00") for k in keys]))
            continue
        out.append(cls(snap, [rand_range(rng, space)
                              for _ in range(rng.integers(0, per_txn + 1))],
                       [rand_range(rng, space)
                        for _ in range(rng.integers(0, per_txn + 1))]))
    return out


def space_of(rng, n=80):
    return sorted({rng.integers(97, 112, rng.integers(1, 5)).astype(
        np.uint8).tobytes() for _ in range(n)})


def np_batches(shapes, seed, steps, dense_at=()):
    rng = np.random.default_rng(seed)
    space = space_of(rng)
    per_txn = shapes.reads // shapes.txns if shapes.strided else 3
    enc = jconf.BatchEncoder(shapes)
    out, version = [], STEP
    for i in range(steps):
        version += int(rng.integers(2 * STEP, 5 * STEP))
        txns = rand_txns(rng, space, version, per_txn,
                         shapes.txns if i in dense_at
                         else int(rng.integers(1, shapes.txns + 1)),
                         dense=i in dense_at)
        out.append({k: np.array(v)
                    for k, v in enc.encode_batch(txns, version).items()})
    return out


# ---------------------------------------------------------------------------
# the glue's plain versions (step_masks, K13) against the JAX expressions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["pooled", "strided"])
def test_step_masks_equal_the_jax_expressions(layout):
    shapes = SHAPES[layout]
    T, NR, NW, L = shapes.txns, shapes.reads, shapes.writes, shapes.limbs
    batch = np_batches(shapes, seed=3, steps=1)[0]
    rng = np.random.default_rng(4)
    ranks = {k: rng.integers(0, 6, n).astype(np.int32)
             for k, n in (("rbr", NR), ("rer", NR), ("wbr", NW), ("wer", NW))}
    # conflict.py:385-395 and 477-489, written out as the JAX step has them
    if shapes.strided:
        rvalid = batch["rb"][L - 1] != np.uint32(0xFFFFFFFF)
        wvalid = batch["wb"][L - 1] != np.uint32(0xFFFFFFFF)
        rtxn = jnp.where(rvalid, jnp.arange(NR) // (NR // T), T)
        wtxn = jnp.where(wvalid, jnp.arange(NW) // (NW // T), T)
    else:
        rtxn, wtxn = jnp.asarray(batch["rtxn"]), jnp.asarray(batch["wtxn"])
        rvalid, wvalid = rtxn < T, wtxn < T
    want = (rtxn, wtxn, jnp.minimum(wtxn, T - 1),
            rvalid & (ranks["rbr"] < ranks["rer"]),
            wvalid & (ranks["wbr"] < ranks["wer"]))
    tb = ref.batch_from_numpy(batch, CPU)
    got = ref.step_masks(tb["rb"], tb["wb"], tb["rtxn"], tb["wtxn"],
                         *(torch.from_numpy(ranks[k])
                           for k in ("rbr", "rer", "wbr", "wer")),
                         T, shapes.strided)
    for name, g, w in zip(("rtxn", "wtxn", "wtxn_c", "r_ok", "w_ok"), got,
                          want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert (got[0] == T).any() and (got[0] < T).any()  # padding and reads
    # K2's wrapper on CPU tensors is the plain version, the masks first,
    # no launch (the history part reads a fresh state's table)
    state = ref.init_state(shapes.capacity, L, CPU)
    spos, cum = ref.sort_and_rank(state["bkeys"], state["bval"], tb["rb"],
                                  tb["re"], tb["wb"], tb["we"])[4:6]
    before = dict(kernels.LAUNCHES)
    again = kernels.masks_and_history(
        state["table"], cum, spos, tb["rb"], tb["re"], tb["wb"], tb["rtxn"],
        tb["wtxn"], *(torch.from_numpy(ranks[k])
                      for k in ("rbr", "rer", "wbr", "wer")),
        tb["snapshot"], tb["txn_valid"], state["oldest"],
        strided=shapes.strided)
    assert len(again) == 7
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("seed,T,overflow,converged",
                         [(1, 64, False, True), (2, 33, True, False),
                          (3, 1, False, True)])
def test_step_verdicts_equal_the_jax_expressions(seed, T, overflow,
                                                 converged):
    rng = np.random.default_rng(seed)
    valid = rng.random(T) < 0.8
    eligible = valid & (rng.random(T) < 0.7)
    commit = eligible & (rng.random(T) < 0.7)
    too_old = valid & ~eligible & (rng.random(T) < 0.5)
    # conflict.py:545-553, info["committed"] and _combine_fn (:1190-1198)
    st = jnp.where(commit, jconf.COMMITTED,
                   jnp.where(too_old, jconf.TOO_OLD, jconf.CONFLICT))
    st = jnp.where(valid, st, jconf.COMMITTED).astype(jnp.int32)
    want_row = np.asarray(jconf._combine_fn()(st, eligible,
                                              np.bool_(overflow),
                                              np.bool_(converged)))
    M = 3
    scan_out = (torch.full((M, T), -1, dtype=torch.int8),
                torch.full((M,), -1, dtype=torch.int32),
                torch.zeros(M, dtype=torch.bool))
    args = [torch.from_numpy(a) for a in (commit, too_old, valid, eligible)]
    args += [torch.tensor(overflow), torch.tensor(converged)]
    statuses, committed, row = ref.step_verdicts(*args, scan_out=scan_out,
                                                 index=1)
    np.testing.assert_array_equal(row.numpy(), want_row)
    np.testing.assert_array_equal(statuses.numpy(), np.asarray(st))
    assert statuses.dtype == torch.int32 and row.dtype == torch.int32
    assert int(committed) == int(np.sum(commit))
    np.testing.assert_array_equal(scan_out[0][1].numpy(),
                                  np.asarray(st).astype(np.int8))
    assert int(scan_out[1][1]) == int(np.sum(commit))
    assert bool(scan_out[2][1]) == overflow
    # rows 0 and 2 are untouched
    assert (scan_out[0][0] == -1).all() and int(scan_out[1][2]) == -1


# ---------------------------------------------------------------------------
# the fixed state buffers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["pooled", "strided"])
def test_out_step_keeps_its_buffers_and_equals_the_fresh_and_jax_steps(
        layout):
    """Steps that fill the state until it overflows (sticky poison), a
    rebase and a clear: the step written into fixed buffers equals the step
    into new tensors and the JAX step, and the buffers never move."""
    shapes = SHAPES[layout]
    jstep = jconf._compiled_step(shapes, WINDOW)
    jstate = jconf.init_state(shapes)
    fresh = ref.state_from_numpy(to_np(jstate), CPU)
    fixed = ref.init_state(shapes.capacity, shapes.limbs, CPU)
    ptrs = {k: v.data_ptr() for k, v in fixed.items()}
    assert_state_equal(fixed, fresh, "init")
    saw_poison = False
    batches = np_batches(shapes, seed=11, steps=7, dense_at=(2, 3))
    for i, batch in enumerate(batches):
        where = f"{layout} step {i}"
        if i == 5:  # a rebase between steps, through the fixed buffers
            jstate = jconf.rebase_state(jstate, jnp.int32(3 * STEP))
            fresh = ref.rebase_state(fresh, 3 * STEP)
            assert ref.rebase_state(fixed, 3 * STEP, out=fixed) is fixed
            assert_jax_state(jstate, fixed, f"{where} rebase")
            for b in batches[5:]:
                for k in ("snapshot", "commit_version"):
                    b[k] = (b[k].astype(np.int64) - 3 * STEP).clip(
                        min=0).astype(np.int32)
        tb = ref.batch_from_numpy(batch, CPU)
        jstate, jst, jinfo = jstep(jstate, batch)
        fresh, fst, finfo = ref.conflict_step(
            fresh, tb, max_write_life=WINDOW, strided=shapes.strided)
        out, ost, oinfo = ref.conflict_step(
            fixed, tb, max_write_life=WINDOW, strided=shapes.strided,
            out=fixed)
        assert out is fixed
        assert {k: v.data_ptr() for k, v in fixed.items()} == ptrs, where
        assert_state_equal(fixed, fresh, where)
        assert_jax_state(jstate, fixed, where)
        np.testing.assert_array_equal(ost.numpy(), np.asarray(jst),
                                      err_msg=where)
        assert torch.equal(ost, fst)
        for k in INFO:
            np.testing.assert_array_equal(oinfo[k].numpy(),
                                          np.asarray(jinfo[k]),
                                          err_msg=f"info[{k}] {where}")
        np.testing.assert_array_equal(
            oinfo["readback"].numpy(),
            np.asarray(jconf._combine_fn()(jst, jinfo["eligible"],
                                           jinfo["overflow"],
                                           jinfo["converged"])))
        saw_poison |= bool(oinfo["overflow"])
    assert saw_poison, "the trajectory never overflowed"
    # clear: the fixed buffers refilled in place equal a new empty state
    assert ref.init_state(shapes.capacity, shapes.limbs, CPU,
                          out=fixed) is fixed
    assert {k: v.data_ptr() for k, v in fixed.items()} == ptrs
    assert_jax_state(jconf.init_state(shapes), fixed, "clear")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cpu_engine_on_fixed_buffers_matches_the_oracle(seed):
    """Chunked batches, a version jump past 2^29 (a rebase) and a clear:
    every decision equals the oracle's, and the engine's state buffers
    never move."""
    rng = np.random.default_rng(seed)
    space = space_of(rng, 60)
    cs = DeviceConflictSet(device="cpu", capacity=1024, txns=16,
                           reads_per_txn=3, writes_per_txn=3)
    oracle = OracleConflictSet()
    ptrs = {k: v.data_ptr() for k, v in cs._state.items()}
    version = 0
    for i in range(12):
        version += int(rng.integers(STEP, 3 * STEP))
        if i == 6:
            version += 1 << 29
        if i == 9:
            cs.clear(version)
            oracle = OracleConflictSet(oldest_version=version)
            version += STEP
        txns = rand_txns(rng, space, version, 3,
                         int(rng.integers(1, 40)), cls=TxnConflictInfo)
        assert cs.detect(txns, version) == oracle.detect(txns, version), i
        assert {k: v.data_ptr() for k, v in cs._state.items()} == ptrs
    assert cs.base_version > 0  # the jump rebased


# ---------------------------------------------------------------------------
# the step and scan programs, eagerly
# ---------------------------------------------------------------------------

def test_packed_batch_views_carry_bools_as_bytes():
    layout, size = sg.batch_layout(3, 5, 6, 4)
    assert size == 3 * 6 * 2 + 3 * 4 * 2 + 6 + 4 + 5 + 1 + 2 + 1
    host = np.zeros(size, np.int32)
    views = sg.batch_views(host, layout)
    views["txn_valid"][[0, 3]] = 1
    views["advance_floor"][...] = 1
    views["snapshot"][:] = np.arange(5)
    tv = sg.batch_views(torch.from_numpy(host), layout)
    assert tv["txn_valid"].dtype == torch.bool
    assert tv["txn_valid"].tolist() == [True, False, False, True, False]
    assert bool(tv["advance_floor"]) and tv["advance_floor"].shape == ()
    assert tv["snapshot"].tolist() == [0, 1, 2, 3, 4]
    assert tv["rb"].shape == (3, 6) and tv["we"].shape == (3, 4)
    dest = torch.empty(size, dtype=torch.int32)
    assert cudaenv.to_device(torch.from_numpy(host), CPU, out=dest) is dest
    assert torch.equal(dest, torch.from_numpy(host))


def test_step_program_eager_equals_the_step_and_the_jax_row():
    shapes = SHAPES["pooled"]
    cs = DeviceConflictSet(device="cpu", capacity=shapes.capacity,
                           txns=shapes.txns, reads_per_txn=3,
                           writes_per_txn=3)
    jstep = jconf._compiled_step(shapes, WINDOW)
    jstate = jconf.init_state(shapes)
    prog = sg.StepGraph(cs._state, txns=shapes.txns, reads=shapes.reads,
                        writes=shapes.writes, max_write_life=WINDOW,
                        graphed=False)
    rng = np.random.default_rng(5)
    space = space_of(rng)
    version = STEP
    for i in range(4):
        version += int(rng.integers(2 * STEP, 5 * STEP))
        txns = rand_txns(rng, space, version, 3, 32, cls=TxnConflictInfo)
        batch = cs.encoder.encode_batch(txns, version, dest=prog.buffer)
        row = prog.run()
        jtxns = [JTxn(t.read_snapshot, t.read_ranges, t.write_ranges)
                 for t in txns]
        jb = {k: np.array(v) for k, v in jconf.BatchEncoder(
            shapes).encode_batch(jtxns, version).items()}
        for k, v in ref.batch_from_numpy(jb, CPU).items():
            assert torch.equal(batch[k], v), (i, k)
        jstate, jst, jinfo = jstep(jstate, jb)
        np.testing.assert_array_equal(row.numpy(), np.asarray(
            jconf._combine_fn()(jst, jinfo["eligible"], jinfo["overflow"],
                                jinfo["converged"])), err_msg=f"step {i}")
        assert_jax_state(jstate, prog.state, f"step {i}")


@pytest.mark.parametrize("ablate", ["", "no_merge"])
def test_scan_program_eager_equals_the_jax_scan(ablate):
    shapes = SHAPES["strided"]
    batches = np_batches(shapes, seed=21, steps=4)
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    jstate = jconf.init_state(shapes)
    if ablate:
        import functools

        import jax
        from jax import lax

        def stepfn(st, b):
            st2, s, info = jconf.conflict_step(
                st, b, shapes=shapes, max_write_life=WINDOW, ablate=ablate)
            return st2, (s.astype(jnp.int8), info["committed"],
                         info["overflow"])
        scan = jax.jit(functools.partial(lax.scan, stepfn))
        jfinal, (jst, jcomm, jovf) = scan(jstate, stacked)
    else:
        jfinal, jst, jcomm, jovf = jconf._compiled_scan(shapes, WINDOW)(
            jstate, stacked)
    state = ref.init_state(shapes.capacity, shapes.limbs, CPU)
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    prog = sg.ScanGraph(state, steps=4, txns=shapes.txns, reads=shapes.reads,
                        writes=shapes.writes, max_write_life=WINDOW,
                        strided=True, ablate=ablate, graphed=False)
    st, comm, ovf = prog.run({k: ref._from_np(k, np.ascontiguousarray(v), CPU)
                              for k, v in stacked.items()})
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(comm.numpy(), np.asarray(jcomm))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(jovf))
    assert st.dtype == torch.int8 and comm.dtype == torch.int32
    assert_jax_state(jfinal, state, "final")
    assert {k: v.data_ptr() for k, v in state.items()} == ptrs


def counting_phases():
    """The plain phases, each adding one to its kernel's launch count as
    the wrappers do on the card."""
    def count(phase, fn):
        def wrapped(*a, **kw):
            kernels.LAUNCHES[STEP_PHASES[phase]] += 1
            return fn(*a, **kw)
        return wrapped
    return type(ref.PLAIN)(**{
        name: count(name, fn) if name in STEP_PHASES else fn
        for name, fn in vars(ref.PLAIN).items()})


@pytest.mark.parametrize("kind", ["step", "scan"])
def test_program_launch_accounting(kind):
    shapes = SHAPES["strided"]
    state = ref.init_state(shapes.capacity, shapes.limbs, CPU)
    kw = dict(txns=shapes.txns, reads=shapes.reads, writes=shapes.writes,
              max_write_life=WINDOW, strided=True, phases=counting_phases(),
              graphed=False)
    batches = np_batches(shapes, seed=8, steps=3)
    if kind == "step":
        prog, steps = sg.StepGraph(state, **kw), 1

        def run():
            return prog.run()
    else:
        prog, steps = sg.ScanGraph(state, steps=3, **kw), 3
        stacked = {k: ref._from_np(k, np.stack([b[k] for b in batches]), CPU)
                   for k in batches[0]}

        def run():
            return prog.run(stacked)
    want = {name: steps for name in STEP_PHASES.values()}
    for _ in range(2):
        before = dict(kernels.LAUNCHES)
        run()
        assert prog.launches == want
        assert {k: n - before[k] for k, n in kernels.LAUNCHES.items()
                if n != before[k]} == want


@pytest.mark.parametrize("kind", ["step", "scan"])
def test_programs_refuse_the_legacy_evaluator_and_a_cpu_graph(kind):
    shapes = SHAPES["pooled"]
    state = ref.init_state(shapes.capacity, shapes.limbs, CPU)
    kw = dict(txns=shapes.txns, reads=shapes.reads, writes=shapes.writes,
              max_write_life=WINDOW)
    if kind == "scan":
        kw["steps"] = 2
    cls = sg.StepGraph if kind == "step" else sg.ScanGraph
    # the legacy evaluator is a program's like the scan's (one launch of
    # K5); an evaluator that does not exist is refused
    with pytest.raises(FDBError) as ei:
        cls(state, intra_mode="dense", graphed=False, **kw)
    assert ei.value.name == "invalid_option"
    with pytest.raises(FDBError) as ei:
        cls(state, ablate="no_sort", graphed=False, **kw)
    assert ei.value.name == "invalid_option"
    with pytest.raises(FDBError) as ei:  # a CUDA graph of a CPU state
        cls(state, **kw)
    assert ei.value.name == "invalid_option"


@pytest.mark.parametrize("kind", ["step", "scan"])
def test_programs_with_the_legacy_evaluator_equal_the_eager_step(kind):
    """StepGraph and ScanGraph with intra_mode="legacy" (eagerly, as on the
    CPU) against `conflict_step` in that mode into new tensors and the JAX
    legacy step: readback rows or scan rows, and the state."""
    layout = "pooled" if kind == "step" else "strided"
    shapes = SHAPES[layout]
    T = shapes.txns
    batches = np_batches(shapes, seed=13, steps=4)
    jstep = jconf._compiled_step(shapes, WINDOW, "legacy", 0)
    jstate = jconf.init_state(shapes)
    fresh = ref.init_state(shapes.capacity, shapes.limbs, CPU)
    state = ref.init_state(shapes.capacity, shapes.limbs, CPU)
    kw = dict(txns=T, reads=shapes.reads, writes=shapes.writes,
              max_write_life=WINDOW, strided=shapes.strided,
              intra_mode="legacy", graphed=False)
    want_rows, conflicts = [], 0
    for b in batches:
        jstate, jst, jinfo = jstep(jstate, b)
        fresh, st, info = ref.conflict_step(
            fresh, ref.batch_from_numpy(b, CPU), max_write_life=WINDOW,
            intra_mode="legacy", strided=shapes.strided)
        np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
        want_rows.append((info["readback"], st, info["committed"],
                          info["overflow"]))
        conflicts += int((st == 0).sum())
    assert conflicts > 0
    if kind == "step":
        prog = sg.StepGraph(state, **kw)
        for i, b in enumerate(batches):
            for k, v in ref.batch_from_numpy(b, CPU).items():
                prog.batch[k].copy_(v)
            assert torch.equal(prog.run(), want_rows[i][0]), i
    else:
        prog = sg.ScanGraph(state, steps=len(batches), **kw)
        stacked = {k: ref._from_np(k, np.stack([b[k] for b in batches]), CPU)
                   for k in batches[0]}
        st, comm, ovf = prog.run(stacked)
        for i, (_row, s_i, c_i, o_i) in enumerate(want_rows):
            assert torch.equal(st[i], s_i.to(torch.int8)), i
            assert int(comm[i]) == int(c_i) and bool(ovf[i]) == bool(o_i)
    assert_state_equal(state, fresh, kind)
    assert_jax_state(jstate, state, kind)


def test_legacy_engine_runs_eagerly_and_matches_the_oracle():
    TKNOBS.set("CONFLICT_INTRA_MODE", "legacy")
    cs = DeviceConflictSet(device="cpu", capacity=512, txns=16,
                           reads_per_txn=2, writes_per_txn=2)
    assert cs._graph(cs.shapes) is None
    rng = np.random.default_rng(9)
    space = space_of(rng, 40)
    oracle = OracleConflictSet()
    version = 0
    for i in range(5):
        version += STEP
        txns = rand_txns(rng, space, version, 2, 20, cls=TxnConflictInfo)
        assert cs.detect(txns, version) == oracle.detect(txns, version), i
