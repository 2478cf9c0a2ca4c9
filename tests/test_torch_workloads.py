"""tests/test_workloads.py on both packages, seed for seed.

Each reference test runs `run_spec` with its workloads and faults; here the
same call runs on the port's harness and on the JAX harness, and the two
records must be equal exactly (the SpecResult, every attempt and DBInfo
with its virtual time, each workload's counters and faults, the final
contents; see test_torch_sim_tiers.py). The reference's own assertions
then hold on the port's run. test_torch_fault_cocktail.py holds the
fault-cocktail, redundancy, replication and restart tests the same way.
"""

from test_torch_sim_tiers import (  # noqa: F401 — the autouse fixture
    _knobs, both, set_knobs)

# the reference fixture's backend
ORACLE = dict(CONFLICT_BACKEND="oracle")


def spec(seed, build, **kw):
    """A go function: run_spec(seed, workloads=build(S), **kw) on the
    stack S, returning the SpecResult and the workloads."""
    def go(S):
        workloads = build(S) if build is not None else None
        return S.wl.run_spec(seed, workloads=workloads, **kw), workloads
    return go


def run_both(seed, build, **kw):
    port = both(spec(seed, build, **kw))
    result, workloads = port.result
    return result, workloads, port


# ---------------------------------------------------------------------------
# tests/test_workloads.py
# ---------------------------------------------------------------------------

def test_conflict_range_with_clogging():
    set_knobs(**ORACLE)
    _r, (w, _c), _p = run_both(61, lambda S: [
        S.wl.ConflictRangeWorkload(), S.wl.RandomCloggingWorkload()],
        duration=40.0, buggify=False)
    assert w.checked > 10 and w.conflicts > 0


def test_api_correctness_with_clogging():
    set_knobs(**ORACLE)
    _r, (w, _c), _p = run_both(62, lambda S: [
        S.wl.ApiCorrectnessWorkload(), S.wl.RandomCloggingWorkload()],
        duration=40.0, buggify=False)
    assert w.txns > 5


def test_write_during_read_with_clogging():
    set_knobs(**ORACLE)
    _r, (w, _c), _p = run_both(63, lambda S: [
        S.wl.WriteDuringReadWorkload(), S.wl.RandomCloggingWorkload()],
        duration=40.0, buggify=False)
    assert w.txns > 5


def test_atomic_ops_with_clogging_and_attrition():
    set_knobs(**ORACLE)
    _r, (w, _c, _a), port = run_both(64, lambda S: [
        S.wl.AtomicOpsWorkload(), S.wl.RandomCloggingWorkload(),
        S.wl.AttritionWorkload(interval=10.0)],
        duration=45.0, buggify=False)
    assert w.attempted > 10
    assert any(dict(e[1])["Type"].startswith("Attrition")
               for e in port.events)  # the attrition killed something


def test_random_move_keys_with_cycle_and_faults():
    set_knobs(**ORACLE)
    _r, (_cy, w, _c, _cc), _p = run_both(65, lambda S: [
        S.wl.CycleWorkload(), S.wl.RandomMoveKeysWorkload(interval=2.0),
        S.wl.RandomCloggingWorkload(), S.wl.ConsistencyCheckWorkload()],
        duration=45.0, buggify=False, n_replicas=2, n_storage_workers=4)
    assert w.moves > 0


def test_increment_with_clogging():
    set_knobs(**ORACLE)
    _r, (w, _c), _p = run_both(66, lambda S: [
        S.wl.IncrementWorkload(), S.wl.RandomCloggingWorkload()],
        duration=35.0, buggify=False)
    assert w.confirmed > 10


def test_selector_correctness_with_clogging():
    set_knobs(**ORACLE)
    run_both(67, lambda S: [S.wl.SelectorCorrectnessWorkload(),
                            S.wl.RandomCloggingWorkload()],
             duration=30.0, buggify=False)


def test_watches_with_clogging():
    set_knobs(**ORACLE)
    _r, (w, _c), _p = run_both(68, lambda S: [
        S.wl.WatchesWorkload(), S.wl.RandomCloggingWorkload()],
        duration=35.0, buggify=False)
    assert w.fired > 3


def test_versionstamp_workload():
    set_knobs(**ORACLE)
    _r, (w,), _p = run_both(69, lambda S: [S.wl.VersionStampWorkload()],
                            duration=25.0, buggify=False)
    assert len(w.stamps) > 5
