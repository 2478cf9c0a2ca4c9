"""Tiny cells end to end on the CPU with the port's plain phases: sound
runs come out correct verdict for verdict, and the control and every
fault a cell can have come out not correct. The `cuda` tests do the same
on the card (`python -m pytest -m cuda kvbench/` there)."""

import numpy as np
import pytest

from foundationdb_tpu_torch.ops.step_graph import batch_views
from kvbench import harness
from kvbench import reference
from kvbench.conftest import CELLS, SEED, TINY


def run(cell, ablate="", device="cpu", traced=False):
    bench = harness.load_benchmark()
    return harness.run_cell(bench, cell, SEED, 0.5, traced, device=device,
                            overrides=TINY[cell], ablate=ablate)


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_cell_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "counts", "checks"]
    assert r["checks"]["wrong_batches"]["value"] == 0
    assert r["checks"]["unchecked_batches"]["value"] == 0
    assert r["counts"]["passes"] >= 3
    assert r["counts"]["rebases"] == r["counts"]["passes"] - 1
    listed = harness.metrics_of(harness.load_benchmark(), cell, False)
    assert set(r["metrics"]) == {m["name"] for m in listed}
    assert {"txns_per_s", "setup_s"} <= set(r["metrics"])
    assert r["attempted"] == r["counts"]["window_batches"] * \
        r["counts"]["txns_per_batch"]


@pytest.mark.parametrize("cell", CELLS)
def test_verdict_for_verdict_against_the_reference(cell):
    """Pass 0 through detect_async, then two passes of the encoded pool
    through the harness's pipeline, each after the engine's rebase by the
    pool's span, held to the reference's verdicts txn by txn."""
    c = harness.cell(harness.load_benchmark(), cell, TINY[cell])
    import torch
    with harness.engine_window(c["config"]["engine"]["max_write_life"]):
        s = harness.Setup(c["config"], c["traffic"], SEED,
                          torch.device("cpu"))
        pipe = harness.Pipeline(s)
        k = pipe.run_batches(0, s.P)
        s.encode_pool()
        pipe.run_batches(k, 2 * s.P)
        kept = [pipe.verdicts(key) for key in pipe.keys[s.P:]]
    assert pipe.rebases == 2
    out, loop = reference.pass_verdicts(s.stream, 3)
    for n in (1, 2):
        expect = reference.verdicts_of_pass(out, loop, n)
        got = np.array(kept[(n - 1) * s.P:n * s.P], np.int8)
        assert np.array_equal(got, expect)
    # every verdict kind occurs where the traffic makes it
    kinds = set(np.unique(expect).tolist())
    assert reference.COMMITTED in kinds and reference.CONFLICT in kinds


def test_a_traced_tiny_run_reports_the_host_spans():
    r = run("skiplisttest.2500", traced=True)
    assert r["correct"]
    # the device metrics need the card's trace: none is read on the CPU
    assert set(r["metrics"]) == {"host_us_per_batch"}


def _break(monkeypatch, fault):
    if fault == "answer_altered":
        readback = harness.cudaenv.to_host_async

        def altered(row):
            """The readback with its first verdict changed on its way."""
            host, event = readback(row)
            host = host.clone()
            host[0] = reference.CONFLICT if int(host[0]) else \
                reference.COMMITTED
            return host, event
        monkeypatch.setattr(harness.cudaenv, "to_host_async", altered)
    real = harness.Setup.encode_pool

    def broken(self):
        real(self)
        if fault == "half_the_batch_left_out":
            for view, (lay, _size) in zip(self.pool_views, self.layouts):
                batch_views(view.numpy(), lay)["txn_valid"][self.T // 2:] = 0
    monkeypatch.setattr(harness.Setup, "encode_pool", broken)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged",
                                   "half_the_batch_left_out",
                                   "answer_altered", "control"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    """A step that leaves its state unchanged (the step's `no_merge`), half
    of every batch left out, a verdict altered where it is produced, the
    host's too-old pass a batch off, and the control (the intra-batch
    check off, `no_intra`) each fail."""
    ablate = {"state_unchanged": "no_merge", "control": "no_intra"}
    _break(monkeypatch, fault)
    r = run(cell, ablate=ablate.get(fault, ""))
    assert not r["correct"]
    assert r["checks"]["wrong_batches"]["value"] > 0


@pytest.mark.parametrize("cell", ["skiplisttest.2500", "skiplisttest.16k"])
def test_a_too_old_pass_a_version_high_is_not_correct(monkeypatch, cell):
    """The host's too-old pass (detect_async_impl) with its MVCC floor one
    version above the window's oldest snapshot: the skiplisttest reads sit
    there, so their txns come out too old and the run not correct."""
    real = harness.conflict.DeviceConflictSet.detect_async

    def detect_async(self, txns, commit_version):
        self.oldest_version = commit_version - \
            harness.KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS + 1
        return real(self, txns, commit_version)
    monkeypatch.setattr(harness.conflict.DeviceConflictSet, "detect_async",
                        detect_async)
    r = run(cell)
    assert not r["correct"]
    assert r["counts"]["too_old_txns"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_cell_on_the_card(cuda_card, cell):
    r = run(cell, device="cuda", traced=True)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert {"step_device_ms", "device_idle_pct",
            "host_us_per_batch"} <= set(r["metrics"])
    assert 0 < r["metrics"]["step_roofline"]["value"] <= 100


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_on_the_card_is_not_correct(cuda_card, cell):
    r = run(cell, ablate="no_intra", device="cuda")
    assert not r["correct"]
