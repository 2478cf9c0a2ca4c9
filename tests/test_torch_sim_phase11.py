"""chip_smoke.py's phase 11 on the CPU, and its constant of expected
SpecResults held to the port's and the JAX package's CPU runs.

Phase 11 runs the port's randomized harness with the resolvers' engines on
the card and requires each device draw's SpecResult (rotations, epochs,
virtual end time) to equal SIM_EXPECTED. Here `sim_phase` runs on the CPU,
its engines on the plain versions, with every check it makes on the card
but those of graphs and launches: the spec's own checks, every recruited
resolver's batches against a fresh oracle, no poison, convergence, and
the expected SpecResult for a device draw. The same seed through the JAX
harness, at its own CPU knobs, must give the same SpecResult. The runs
are split over this file and test_torch_sim_expected.py (with 11b) to
keep each file short.
"""

import pytest
import torch

import chip_smoke
from foundationdb_tpu.testing import simulated_cluster as j_sc
from foundationdb_tpu_torch.testing import simulated_cluster as t_sc
from foundationdb_tpu_torch.utils import trace as t_trace
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS

CPU = torch.device("cpu")
DEVICE_RUNS = [key for key in chip_smoke.SIM_EXPECTED
               if (key[0], key[1]) in chip_smoke.SIM_RUNS]
HERE = [key for key in DEVICE_RUNS
        if key[0] in ("cycle", "zipfian-hotkey", "zipfian-read-hotspot")]


@pytest.fixture(autouse=True)
def _knobs():
    """The port's bank reset around each test, its engines on the CPU with
    one torch thread (the steps are small, the suite's workers share the
    cores); the conftest resets the JAX bank."""
    TKNOBS.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    t_trace.set_sink(None)
    TKNOBS.reset()


def port_and_jax(name, seed, knobs=()):
    """The run through chip_smoke's phase 11 on the CPU (which holds a
    device draw to SIM_EXPECTED itself), and through the JAX harness at
    its CPU knobs: (the port's run record, the JAX SpecResult)."""
    out = chip_smoke.sim_phase(CPU, runs=() if knobs else [(name, seed)],
                               wide=(name, seed, knobs) if knobs else None)
    (run,) = out["runs"]
    spec = j_sc.SPECS[name]
    if knobs:
        import dataclasses
        spec = dataclasses.replace(spec, knobs=spec.knobs + tuple(knobs))
    r = j_sc.run_randomized_spec(seed, spec=spec,
                                 allow_backends=chip_smoke.SIM_BACKENDS)
    return run, [r.result.rotations, r.result.epochs, r.result.elapsed]


def test_runs_cover_the_axes_the_phase_needs():
    """Ten fast specs, each on a seed whose draw fits it; among the draws a
    sharded one, redwood, ssd, two regions, double replication, and the
    legacy evaluator, the one-round sandwich, no encode ring and a
    16-bucket sketch buggified; every device draw has its expected
    SpecResult, 11b's too."""
    fast = {s.name for s in t_sc.FAST_SPECS}
    assert sorted(n for n, _s in chip_smoke.SIM_RUNS) == sorted(fast)
    draws = []
    for name, seed in chip_smoke.SIM_RUNS:
        d = t_sc.ClusterDraw.draw(seed,
                                  allow_backends=chip_smoke.SIM_BACKENDS)
        assert t_sc.SPECS[name].compatible(d), (name, seed)
        draws.append(d)
        if d.conflict_backend == "device":
            assert (name, seed) in chip_smoke.SIM_EXPECTED
    knobs = [dict(d.knobs) for d in draws]
    assert {"sharded", "device"} == {d.conflict_backend for d in draws}
    assert {"memory", "ssd", "redwood"} == {d.storage_engine for d in draws}
    assert {"single", "double", "two_region"} == {d.replication
                                                  for d in draws}
    assert any(k.get("CONFLICT_INTRA_MODE") == "legacy" for k in knobs)
    assert any(k.get("CONFLICT_INTRA_ROUNDS") == 1 for k in knobs)
    assert any(k.get("CONFLICT_ENCODE_RING") == 0 for k in knobs)
    assert any(k.get("HOTSPOT_MAX_BUCKETS") == 16 for k in knobs)
    name, seed, wide = chip_smoke.SIM_WIDE
    d = t_sc.ClusterDraw.draw(seed, allow_backends=chip_smoke.SIM_BACKENDS)
    assert name == "cycle" and d.replication == "double"
    assert d.conflict_backend == "device"
    assert dict(wide) == {"CONFLICT_STATE_CAPACITY": 65536,
                          "CONFLICT_BATCH_TXNS": 1024,
                          "CONFLICT_BATCH_READS_PER_TXN": 4,
                          "CONFLICT_BATCH_WRITES_PER_TXN": 4}
    assert (name, seed) in chip_smoke.SIM_EXPECTED


def test_chip_smoke_phase11_checks_pass_on_the_cpu_for_a_sharded_draw():
    """A sharded draw (two shards on the CPU): the spec's checks, every
    resolver batch against the oracle, no poison, every chunk converged.
    Sharded draws have no expected SpecResult (the card runs one shard)."""
    out = chip_smoke.sim_phase(CPU, runs=[("ryow", 7)], wide=None)
    (run,) = out["runs"]
    assert run["backend"] == "sharded" and run["expected"] is None
    assert run["mismatched_batches"] == 0 and run["resolved_batches"] > 0
    assert run["chunks"] == sum(r["chunks"] for r in run["resolvers"]) > 0
    assert run["unconverged_chunks"] == 0
    assert all(r["device"] == "cpu" for r in run["resolvers"])


@pytest.mark.parametrize("name,seed", HERE, ids=[f"{n}-{s}" for n, s in HERE])
def test_expected_spec_result_is_the_ports_and_the_jax_cpu_run(name, seed):
    run, jax = port_and_jax(name, seed)
    want = list(chip_smoke.SIM_EXPECTED[(name, seed)])
    assert run["expected"] == want and run["result"] == want
    assert jax == want
    assert run["mismatched_batches"] == 0 and run["resolved_batches"] > 0
