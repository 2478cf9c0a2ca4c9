"""kvbench/program_spans.py: the five host readings a batch from the
port's counters, and the traced slice's idle device time put down to the
port's spans, on hand-made counter deltas and a hand-made Chrome trace;
and a tiny cell run with the spans on, on the CPU."""

import json

import pytest

from kvbench import harness, program_spans, timeline
from kvbench.conftest import SEED, TINY

PORT = {"CudaTransfers.Put", "CudaGraphs.Replay", "CudaTransfers.Get"}


def program(**over):
    """Set-up and window deltas of the three collections: 10 batches in
    the window, 4 chunks in set-up."""
    window = {"CudaTransfers": {"DevicePuts": 10, "DevicePutSeconds": 2e-4,
                                "DeviceGets": 10, "DeviceGetSeconds": 3e-4},
              "CudaGraphs": {"GraphReplays": 10, "GraphReplaySeconds": 1e-4},
              "ConflictKernel": {"EncodedChunksC": 0, "EncodedChunksPy": 0,
                                 "EncodeSeconds": 0.0, "VerdictRows": 0,
                                 "VerdictSeconds": 0.0}}
    setup = {"ConflictKernel": {"EncodedChunksC": 3, "EncodedChunksPy": 1,
                                "EncodeSeconds": 6e-3, "VerdictRows": 4,
                                "VerdictSeconds": 2e-3}}
    out = {"setup": setup, "window": window}
    for key, value in over.items():
        phase, coll, name = key.split("__")
        out[phase][coll][name] = value
    return out


@pytest.mark.parametrize("name, expect", [
    ("copy_us_per_batch", 20.0), ("replay_us_per_batch", 10.0),
    ("readback_us_per_batch", 30.0), ("encode_us_per_batch", 1500.0),
    ("verdicts_us_per_batch", 500.0)])
def test_each_reading_is_its_seconds_over_its_count(name, expect):
    assert program_spans.reading(program(), name) == pytest.approx(expect)


@pytest.mark.parametrize("key, name", [
    ("window__CudaTransfers__DevicePuts", "copy_us_per_batch"),
    ("window__CudaGraphs__GraphReplays", "replay_us_per_batch"),
    ("window__CudaTransfers__DeviceGets", "readback_us_per_batch"),
    ("setup__ConflictKernel__VerdictRows", "verdicts_us_per_batch"),
    ("setup__ConflictKernel__EncodeSeconds", "encode_us_per_batch")])
def test_a_zero_count_or_no_seconds_reads_none(key, name):
    assert program_spans.reading(program(**{key: 0}), name) is None


def test_a_port_without_the_counters_reads_none():
    """A port that predates the spans has no CudaGraphs and no *Seconds
    counters."""
    old = {"setup": {"ConflictKernel": {"EncodedChunksC": 4,
                                        "EncodedChunksPy": 0}},
           "window": {"CudaTransfers": {"DevicePuts": 10, "DeviceGets": 10}}}
    assert program_spans.readings(old) == dict.fromkeys(
        program_spans.READINGS)


def test_deltas_and_sums_of_snapshots():
    a = {"CudaGraphs": {"GraphReplays": 5, "GraphCaptures": 1}}
    b = {"CudaGraphs": {"GraphReplays": 9, "GraphCaptures": 1},
         "CudaTransfers": {"DevicePuts": 3}}
    d = program_spans.delta(a, b)
    assert d == {"CudaGraphs": {"GraphReplays": 4, "GraphCaptures": 0},
                 "CudaTransfers": {"DevicePuts": 3}}
    assert program_spans.add(d, d)["CudaGraphs"]["GraphReplays"] == 8
    assert {"ConflictKernel", "CudaTransfers", "CudaGraphs"} <= set(
        program_spans.snapshot())


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace(tmp_path):
    """The window [100, 300) us: kernels at [100, 120), [150, 160) and
    [250, 260); the harness's dispatch [100, 200) holds the port's Put
    [120, 135) and Replay [135, 150) (a Get nested in the Replay at
    [140, 145)); its wait [200, 245); nothing from 245 on but a Get at
    [270, 280) outside any harness range."""
    u = "user_annotation"
    events = [
        _x(u, timeline.WINDOW, 100.0, 200.0),
        _x(u, "kvbench.dispatch", 100.0, 100.0),
        _x(u, "CudaTransfers.Put", 120.0, 15.0),
        _x(u, "CudaGraphs.Replay", 135.0, 15.0),
        _x(u, "CudaTransfers.Get", 140.0, 5.0),
        _x(u, "kvbench.wait", 200.0, 45.0),
        _x(u, "CudaTransfers.Get", 270.0, 10.0),
        _x(u, "ConflictKernel.Unlisted", 205.0, 10.0),
        _x("kernel", "k1", 100.0, 20.0),
        _x("kernel", "k2", 150.0, 10.0),
        _x("kernel", "k1", 250.0, 10.0),
        _x("cpu_op", "aten::copy_", 120.0, 5.0),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return events, timeline.load(path)


def test_idle_goes_to_the_innermost_port_span_then_the_harness(tmp_path):
    events, tl = _trace(tmp_path)
    got = dict(program_spans.idle_by_span(events, tl, PORT))
    # gaps: [120, 150), [160, 250), [260, 300)
    assert got == {"CudaTransfers.Put": pytest.approx(15e-6),
                   "CudaGraphs.Replay": pytest.approx(10e-6),
                   "CudaTransfers.Get": pytest.approx(15e-6),
                   "kvbench.dispatch": pytest.approx(40e-6),
                   "kvbench.wait": pytest.approx(45e-6),
                   "host": pytest.approx(35e-6)}
    assert sum(got.values()) == pytest.approx(tl.window_s() - tl.busy_s())
    assert [n for n, _v in program_spans.idle_by_span(
        events, tl, PORT, top=2)] == ["kvbench.wait", "kvbench.dispatch"]


def test_the_longest_gaps_and_the_breakdown_read_as_before(tmp_path):
    events, tl = _trace(tmp_path)
    assert program_spans.longest_gaps(events, tl, PORT) == [
        ["kvbench.wait", pytest.approx(90e-6)],
        ["host", pytest.approx(40e-6)],
        ["CudaTransfers.Put", pytest.approx(30e-6)]]
    # the harness's own breakdown names each gap by its ranges alone
    assert tl.breakdown()["idle_gaps"] == [
        ["kvbench.wait", pytest.approx(90e-6)],
        ["host", pytest.approx(40e-6)],
        ["kvbench.dispatch", pytest.approx(30e-6)]]


def test_a_tiny_cell_with_the_spans_on():
    cell = "skiplisttest.2500"
    r = program_spans.run(harness.load_benchmark(), cell, SEED, 0.2,
                          device="cpu", overrides=TINY[cell], windows=2)
    got = r["readings"]
    assert got["encode_us_per_batch"] > 0
    assert got["verdicts_us_per_batch"] > 0
    # the CPU has no copy, no replay and no readback
    for name in ("copy_us_per_batch", "replay_us_per_batch",
                 "readback_us_per_batch"):
        assert got[name] is None
    assert r["counts"]["graph_captures_setup"] == 0
    assert r["counts"]["graph_captures_window"] == 0
    assert len(r["host_us_per_batch"]["off"]) == 1
    assert len(r["host_us_per_batch"]["on"]) == 1
    assert sum(v for _n, v in r["idle_by_span"]) == pytest.approx(
        r["idle_s"], rel=1e-6)
    from foundationdb_tpu_torch.utils import trace
    assert not trace.spans_enabled()
    assert trace.SPAN_NAMES == program_spans.trace.SPAN_NAMES
