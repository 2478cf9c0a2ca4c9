"""chip_smoke.py's phase 12 on the CPU, and its expected SpecResult.

Phase 12 drives backup and restore (12a), DR (12b) and the
backup-attrition spec (12c) with every cluster's resolvers on the card.
Here 12a and 12b run at a small size on the port's plain versions with
every check the phase makes but those of graphs, launches and device
memory: each restore equal to the source's rows at its version, the DR
destination equal to the source at the switchover, every resolver batch
equal to the oracle, no poison, and fdbcli's status and rows on a
restored cluster. 12c's spec and seed run through the phase's `sim_run`
(which holds the SpecResult to SIM_EXPECTED itself) and through the JAX
harness at its own CPU knobs, whose SpecResult must equal the constant
too.
"""

import dataclasses

import pytest
import torch

import chip_smoke
from foundationdb_tpu.testing import simulated_cluster as j_sc
from foundationdb_tpu_torch.utils import trace as t_trace
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS

CPU = torch.device("cpu")
SHAPE_KNOBS = dict(CONFLICT_STATE_CAPACITY=1024, CONFLICT_BATCH_TXNS=64,
                   CONFLICT_BATCH_READS_PER_TXN=4,
                   CONFLICT_BATCH_WRITES_PER_TXN=4)
SMALL = dict(n_keys=400, n_clients=8, n_attempts=4, knobs=SHAPE_KNOBS)


@pytest.fixture(autouse=True)
def _knobs():
    TKNOBS.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    t_trace.set_sink(None)
    TKNOBS.reset()


def test_chip_smoke_phase12_checks_pass_on_the_cpu():
    out = chip_smoke.backup_phase(CPU, 0, backup=dict(SMALL, chunks=4),
                                  dr=SMALL, sim=None)
    a, b = out["runs"]
    assert (a["phase"], b["phase"]) == ("12a", "12b")
    for run in (a, b):
        assert run["attempts"] == 32 and run["committed"] > 0
        assert run["mismatched_batches"] == 0 and run["resolved_batches"]
        assert not any(r["poisoned"] for r in run["resolvers"])
        assert all(r["backend"] == "cpu" for r in run["resolvers"])
    # the source's two resolvers, the restore's one, the fdbcli cluster's
    assert len(a["resolvers"]) == 4
    assert a["snapshot_chunks"] == 4 and a["log_rows_drained"] > 0
    assert a["restores"]["end"]["equal"] and a["restores"]["pit"]["equal"]
    assert a["restores"]["end"]["rows"] == a["rows_at_end"]
    assert a["pit_version"] < a["end_version"]
    assert a["fdbcli"]["getrange_lines"] == chip_smoke.BACKUP_CLI_ROWS + 1
    assert len(b["resolvers"]) == 3
    assert b["equal"] and b["rows"] >= 400
    assert b["primary"] == {"source": b"remote", "destination": b"primary"}
    assert out["launches"] == {k: 0 for k in out["launches"]}


def test_backup_sim_spec_result_is_the_ports_and_the_jax_cpu_run():
    name, seed, knobs = chip_smoke.BACKUP_SIM
    want = list(chip_smoke.SIM_EXPECTED[(name, seed)])
    t_trace.set_sink(lambda _fields: None)
    run, bad = chip_smoke.sim_run(CPU, name, seed, knobs, want)
    assert not bad
    assert run["backend"] == "device" and run["evaluator"] == "scan"
    assert run["result"] == want
    assert run["mismatched_batches"] == 0 and run["resolved_batches"] > 0
    assert run["unconverged_chunks"] == 0
    spec = j_sc.SPECS[name]
    spec = dataclasses.replace(spec, knobs=spec.knobs + tuple(knobs))
    r = j_sc.run_randomized_spec(seed, spec=spec,
                                 allow_backends=chip_smoke.SIM_BACKENDS)
    assert [r.result.rotations, r.result.epochs, r.result.elapsed] == want
