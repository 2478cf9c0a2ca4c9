"""The rest of chip_smoke.py's phase-11 device runs on the CPU: each
through `sim_phase` (its checks, and its SpecResult against SIM_EXPECTED)
and through the JAX harness, whose SpecResult must equal the constant too;
and 11b, the Cycle spec on a double-replication device draw with its
engine raised to the default width (K=65,536, T=1,024, 4 reads and 4
writes a txn). See test_torch_sim_phase11.py."""

import pytest

import chip_smoke
from test_torch_sim_phase11 import (  # noqa: F401 — the autouse fixture
    DEVICE_RUNS, HERE, _knobs, port_and_jax)

REST = [key for key in DEVICE_RUNS if key not in HERE]


@pytest.mark.parametrize("name,seed", REST, ids=[f"{n}-{s}" for n, s in REST])
def test_expected_spec_result_is_the_ports_and_the_jax_cpu_run(name, seed):
    run, jax = port_and_jax(name, seed)
    want = list(chip_smoke.SIM_EXPECTED[(name, seed)])
    assert run["expected"] == want and run["result"] == want
    assert jax == want
    assert run["mismatched_batches"] == 0 and run["resolved_batches"] > 0


def test_wide_cycle_spec_result_is_the_ports_and_the_jax_cpu_run():
    name, seed, knobs = chip_smoke.SIM_WIDE
    run, jax = port_and_jax(name, seed, knobs)
    want = list(chip_smoke.SIM_EXPECTED[(name, seed)])
    assert run["spec_knobs"] == [list(kv) for kv in knobs]
    assert run["expected"] == want and run["result"] == want
    assert jax == want
    assert run["mismatched_batches"] == 0 and run["resolved_batches"] > 0
    assert run["unconverged_chunks"] == 0
