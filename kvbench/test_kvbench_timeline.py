"""The reduction of a profiler trace to busy time, idle gaps and the
breakdown, on a hand-made Chrome trace."""

import json

import pytest

from kvbench import timeline


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_gaps_and_breakdown(tmp_path):
    events = [
        _x("user_annotation", timeline.WINDOW, 100.0, 100.0),
        _x("user_annotation", "kvbench.dispatch", 100.0, 30.0),
        _x("user_annotation", "kvbench.wait", 150.0, 40.0),
        _x("kernel", "k1", 90.0, 30.0),     # clipped to [100, 120)
        _x("kernel", "k2", 125.0, 10.0),
        _x("gpu_memcpy", "Memcpy HtoD", 130.0, 10.0),  # overlaps k2
        _x("kernel", "k1", 160.0, 20.0),
        _x("kernel", "k3", 250.0, 5.0),     # outside the window
        _x("cpu_op", "aten::copy_", 100.0, 5.0),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tl = timeline.load(path)
    assert tl.window_s() == pytest.approx(100e-6)
    assert tl.kernels() == 3
    assert tl.kernel_counts() == {"k1": (2, pytest.approx(40e-6)),
                                  "k2": (1, pytest.approx(10e-6))}
    assert tl.busy_s() == pytest.approx(55e-6)  # [100,120) [125,140) [160,180)
    assert tl.gaps() == [(120.0, 125.0), (140.0, 160.0), (180.0, 200.0)]
    b = tl.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(40e-6)]
    assert [g[0] for g in b["idle_gaps"]] == ["kvbench.wait", "kvbench.wait",
                                             "kvbench.dispatch"]


def test_a_step_counts_launches_the_trace_missed(tmp_path):
    # 4 steps: "a" traced 3 times of 4 (10 us each), "b" twice a step
    # (8 launches of 5 us), "rebase" once in the 4 steps (20 us)
    events = [_x("user_annotation", timeline.WINDOW, 0.0, 1000.0)]
    at = 0.0
    for name, n, dur in (("a", 3, 10.0), ("b", 8, 5.0), ("rebase", 1, 20.0)):
        for _ in range(n):
            events.append(_x("kernel", name, at, dur))
            at += dur + 1.0
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tl = timeline.load(path)
    assert tl.step_kernel_s(4) == pytest.approx((10 + 2 * 5 + 20 / 4) * 1e-6)
    assert tl.coverage(4) == pytest.approx(12 / (4 + 8 + 1))


def test_a_trace_without_the_window_is_refused(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [_x("kernel", "k", 0, 1)]}))
    with pytest.raises(ValueError):
        timeline.load(path)
