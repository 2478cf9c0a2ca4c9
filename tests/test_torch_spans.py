"""The spans of the port's device path (utils/trace.py `span`,
`enable_spans`) and the counters they and the engine keep.

- Off (the default), a span tests one flag: it reads no clock, adds no
  seconds and opens no torch.profiler range, while the counts count.
- On, each span adds its seconds to its counter and, while a profiler
  records, opens the range of its name: the encode and the verdicts of a
  `DeviceConflictSet` on the CPU, the exact host pass inside the verdicts.
- `ReadbackWaitSeconds` times the drain alone, not the verdicts.
- The resolver's metrics carry every new counter.

The `cuda` test counts a graphed StepGraph's replays and its capture on
the card. This file imports nothing of JAX, so it runs there too
(`python -m pytest --noconftest -m cuda tests/test_torch_spans.py`).
"""

import json
import time

import pytest
import torch

from foundationdb_tpu_torch.ops import conflict
from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops import kernels, step_graph
from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
from foundationdb_tpu_torch.utils import cudaenv, trace
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS
from foundationdb_tpu_torch.utils.stats import CounterCollection

SECONDS = {"ConflictKernel": ("EncodeSeconds", "VerdictSeconds",
                              "HostPassSeconds"),
           "CudaTransfers": ("DevicePutSeconds", "DeviceGetSeconds"),
           "CudaGraphs": ("GraphReplaySeconds",)}
COLLECTIONS = {"ConflictKernel": conflict.kernel_metrics,
               "CudaTransfers": cudaenv.transfer_metrics,
               "CudaGraphs": step_graph.graph_metrics}


@pytest.fixture(autouse=True)
def _reset():
    TKNOBS.reset()
    trace.enable_spans(False)
    yield
    trace.enable_spans(False)
    TKNOBS.reset()


def snap() -> dict:
    return {name: c.as_dict() for name, c in COLLECTIONS.items()}


def moved(before: dict, after: dict) -> dict:
    return {f"{c}.{k}": after[c][k] - before[c][k]
            for c in after for k in after[c] if after[c][k] != before[c][k]}


def p(k):
    return (k, k + b"\x00")


def engine():
    return conflict.DeviceConflictSet(device="cpu", capacity=1024, txns=32,
                                      reads_per_txn=2, writes_per_txn=2)


def batch(n=12):
    return [TxnConflictInfo(0, [p(b"r%d" % i)], [p(b"w%d" % i)])
            for i in range(n)]


def long_chain():
    """Each txn reads what the one before it wrote: one sandwich round
    leaves it unconverged (tests/test_torch_conflict.py)."""
    txns = [TxnConflictInfo(0, [], [p(b"k0")])]
    txns += [TxnConflictInfo(0, [p(b"k%d" % (i - 1))], [p(b"k%d" % i)])
             for i in range(1, 20)]
    return txns


def detect(cs, txns, version, profile_to=None):
    """detect_async + drain_and_collect, under a CPU profiler whose Chrome
    trace is written to `profile_to`: the trace's user ranges as (name,
    start, end), or None without a profiler."""
    if profile_to is None:
        (got, err), = conflict.drain_and_collect(
            [cs.detect_async(txns, version)])
        assert err is None
        return None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        (got, err), = conflict.drain_and_collect(
            [cs.detect_async(txns, version)])
    assert err is None
    prof.export_chrome_trace(str(profile_to))
    events = json.loads(profile_to.read_text())["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_a_span_off_reads_no_clock_and_on_adds_its_seconds(monkeypatch):
    secs = CounterCollection("Probe").counter("Seconds")
    calls = []

    @trace.span("ConflictKernel.Encode", secs)
    def work(x, y=1):
        return x + y

    clock = time.perf_counter
    monkeypatch.setattr(time, "perf_counter",
                        lambda: calls.append(1) or clock())
    assert work(1, y=2) == 3 and calls == [] and secs.value == 0
    trace.enable_spans(True)
    assert trace.spans_enabled()
    assert work(1) == 2 and len(calls) == 2 and secs.value > 0
    with pytest.raises(ValueError):
        trace.span("ConflictKernel.Unknown", secs)


def test_threads_lose_no_span_seconds(monkeypatch):
    """The verdicts run in up to four worker threads at once: 16 threads
    of spanned calls, each reading half a second on a clock of its own
    thread, add up to every call's half second."""
    import sys
    import threading
    secs = CounterCollection("Probe").counter("Seconds")
    local = threading.local()

    def clock():
        local.t = getattr(local, "t", 0.0) + 0.5
        return local.t

    @trace.span("ConflictKernel.Verdicts", secs)
    def work():
        pass

    def loop():
        for _ in range(2000):
            work()

    monkeypatch.setattr(time, "perf_counter", clock)
    trace.enable_spans(True)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=loop) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert secs.value == pytest.approx(16 * 2000 * 0.5)


def test_spans_off_move_no_seconds_and_open_no_range(tmp_path):
    cs = engine()
    detect(cs, batch(), 100)  # the first call's one-off work
    before = snap()
    ranges = detect(cs, batch(), 200, profile_to=tmp_path / "t.json")
    got = moved(before, snap())
    for coll, names in SECONDS.items():
        for name in names:
            assert f"{coll}.{name}" not in got
    assert got["ConflictKernel.VerdictRows"] == 1
    assert got.get("ConflictKernel.EncodedChunksC", 0) + \
        got.get("ConflictKernel.EncodedChunksPy", 0) == 1
    assert not {n for n, _s, _e in ranges} & set(trace.SPAN_NAMES)


def test_spans_on_count_their_seconds_and_open_their_ranges(tmp_path):
    cs = engine()
    trace.enable_spans(True)
    before = snap()
    ranges = detect(cs, batch(), 100, profile_to=tmp_path / "t.json")
    got = moved(before, snap())
    encoded = got.get("ConflictKernel.EncodedChunksC", 0) + \
        got.get("ConflictKernel.EncodedChunksPy", 0)
    assert encoded == 1 and got["ConflictKernel.EncodeSeconds"] > 0
    assert got["ConflictKernel.VerdictRows"] == 1
    assert got["ConflictKernel.VerdictSeconds"] > 0
    # the CPU has no copy, no readback and no graph: nothing to time
    for name in ("CudaTransfers.DevicePutSeconds",
                 "CudaTransfers.DeviceGetSeconds",
                 "CudaGraphs.GraphReplaySeconds", "CudaGraphs.GraphReplays"):
        assert name not in got
    names = [n for n, _s, _e in ranges]
    assert names.count("ConflictKernel.Encode") == 1
    assert names.count("ConflictKernel.Verdicts") == 1
    # off again: the same run moves no seconds
    trace.enable_spans(False)
    before = snap()
    detect(cs, batch(), 200)
    assert "ConflictKernel.EncodeSeconds" not in moved(before, snap())


def test_the_host_pass_nests_inside_the_verdicts(tmp_path):
    TKNOBS.set("CONFLICT_INTRA_ROUNDS", 1)
    cs = engine()
    trace.enable_spans(True)
    before = snap()
    ranges = detect(cs, long_chain(), 100, profile_to=tmp_path / "t.json")
    got = moved(before, snap())
    assert got["ConflictKernel.UnconvergedChunks"] == 1
    assert got["ConflictKernel.HostPassSeconds"] > 0
    assert got["ConflictKernel.VerdictSeconds"] >= \
        got["ConflictKernel.HostPassSeconds"]
    host = [r for r in ranges if r[0] == "ConflictKernel.HostPass"]
    outer = [r for r in ranges if r[0] == "ConflictKernel.Verdicts"]
    assert len(host) == 1 and len(outer) == 1
    assert outer[0][1] <= host[0][1] and host[0][2] <= outer[0][2]


def test_readback_wait_leaves_out_the_verdicts(monkeypatch):
    """A verdict loop made 50 ms slower moves VerdictSeconds and the
    collect's timing, and not ReadbackWaitSeconds."""
    TKNOBS.set("CONFLICT_INTRA_ROUNDS", 1)
    slow = conflict._exact_intra_host

    def slow_pass(*args):
        time.sleep(0.05)
        return slow(*args)

    monkeypatch.setattr(conflict, "_exact_intra_host", slow_pass)
    cs = engine()
    trace.enable_spans(True)
    before = snap()
    timing = {}
    (_got, err), = conflict.drain_and_collect(
        [cs.detect_async(long_chain(), 100)], timing)
    assert err is None
    got = moved(before, snap())
    assert got["ConflictKernel.ReadbackWaits"] == 1
    assert got.get("ConflictKernel.ReadbackWaitSeconds", 0.0) < 0.05
    assert got["ConflictKernel.ReadbackWaitSeconds"] == pytest.approx(
        timing["drain_seconds"])
    assert got["ConflictKernel.VerdictSeconds"] >= 0.05
    assert timing["collect_seconds"] >= 0.05


def test_the_resolvers_metrics_carry_the_new_counters():
    from foundationdb_tpu_torch.core import eventloop, sim
    from foundationdb_tpu_torch.server import interfaces, resolver
    from foundationdb_tpu_torch.utils import rng
    TKNOBS.set("CONFLICT_DEVICE", "cpu")
    loop = eventloop.EventLoop()
    net = sim.SimNetwork(loop, rng.DeterministicRandom(2))
    proc = net.new_process("r")
    client = net.new_process("c")
    resolver.Resolver(proc)
    snap_ = loop.run_future(net.request(client, sim.Endpoint(
        "r", interfaces.Token.RESOLVER_METRICS), None))
    for name, coll in COLLECTIONS.items():
        assert set(coll.as_dict()) <= set(snap_), name
    assert {"GraphReplays", "GraphCaptures", "GraphCaptureSeconds",
            "DevicePutSeconds", "EncodeSeconds", "VerdictRows",
            "VerdictSeconds", "HostPassSeconds"} <= set(snap_)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_a_graphed_step_counts_its_replays_and_one_capture(cuda):
    state = ref.init_state(1024, 5, cuda, oldest=0, phases=kernels.PHASES)
    graph = step_graph.StepGraph(state, txns=64, reads=256, writes=256,
                                 max_write_life=5_000_000)
    before = step_graph.graph_metrics.as_dict()
    for _ in range(3):
        graph.run()
    torch.cuda.synchronize(cuda)
    after = step_graph.graph_metrics.as_dict()
    assert after["GraphReplays"] - before["GraphReplays"] == 3
    assert after["GraphCaptures"] - before["GraphCaptures"] == 1
    assert after["GraphCaptureSeconds"] > before["GraphCaptureSeconds"]
    # spans off: a replay's seconds stay
    assert after["GraphReplaySeconds"] == before["GraphReplaySeconds"]
    trace.enable_spans(True)
    graph.run()
    torch.cuda.synchronize(cuda)
    last = step_graph.graph_metrics.as_dict()
    assert last["GraphReplays"] - after["GraphReplays"] == 1
    assert last["GraphCaptures"] == after["GraphCaptures"]
    assert last["GraphReplaySeconds"] > after["GraphReplaySeconds"]
