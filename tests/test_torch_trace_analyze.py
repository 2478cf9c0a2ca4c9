"""The port's commit-path spans and trace_analyze against the JAX package's.

tests/test_trace_spans.py's eleven tests on the port's utils/trace.py and
tools/trace_analyze.py: span record shape, the buffer's auto-dump, pairing,
stitching and ranking, FIFO pairing, the well-formedness checks, the
queueing ratio, torn trace files, the simulated commit path's span stream
(well formed, stitched, under suppression; deterministic) and the status
JSON's role counters. Then the port SimCluster's span stream equals the
JAX SimCluster's record for record for the same seed (oracle backend), the
rolling trace file rolls, and chip_smoke.py's phase 13 runs at a small
size on the CPU.
"""

from __future__ import annotations

import json

import pytest

from foundationdb_tpu.tools import trace_analyze as J_TA
from foundationdb_tpu.utils import trace as J_T
from foundationdb_tpu_torch.tools import trace_analyze as TA
from foundationdb_tpu_torch.utils import trace as T
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS


@pytest.fixture(autouse=True)
def _clean_trace():
    TKNOBS.reset()
    T.g_trace_batch._events.clear()
    yield
    T.set_sink(None)
    T.disable_suppression()
    T.g_trace_batch._events.clear()
    TKNOBS.reset()


# ------------------------------------------------------------- primitives

def test_span_record_shape_and_explicit_time():
    tb = T.TraceBatch()
    tb.span_begin("CommitSpan", "b0.1", "Proxy.Resolve", at=12.5)
    tb.span_end("CommitSpan", "b0.1", "Proxy.Resolve", at=12.75)
    begin, end = tb._events
    assert begin == {"Type": "CommitSpan", "Time": 12.5, "ID": "b0.1",
                     "Span": "Proxy.Resolve", "Phase": "Begin"}
    assert end["Phase"] == "End" and end["Time"] == 12.75
    # without `at`, the clock set with set_clock stamps the record
    T.set_clock(lambda: 3.25)
    try:
        tb.span_begin("CommitSpan", "b0.2", "Proxy.Resolve")
    finally:
        T.set_clock(__import__("time").time)
    assert tb._events[-1]["Time"] == 3.25


def test_span_buffer_auto_dumps_at_capacity():
    got: list[dict] = []
    T.set_sink(got.append)
    tb = T.TraceBatch(max_buffer=4)
    for i in range(4):
        tb.span_begin("CommitSpan", f"x{i}", "Stage")
    assert tb._events == [] and len(got) == 4


# --------------------------------------------------------- trace_analyze

def _mk(ident, span, t0, t1):
    return [{"Type": "CommitSpan", "Time": t0, "ID": ident, "Span": span,
             "Phase": "Begin"},
            {"Type": "CommitSpan", "Time": t1, "ID": ident, "Span": span,
             "Phase": "End"}]


def test_analyze_pairs_stitches_and_ranks():
    events = (_mk("c1", "Client.Commit", 0.0, 0.05)
              + [{"Type": "CommitAttach", "Time": 0.01, "ID": "c1",
                  "To": "b0.7"}]
              + _mk("b0.7", "Proxy.Resolve", 0.01, 0.02)
              + [{"Type": "CommitAttach", "Time": 0.02, "ID": "b0.7",
                  "To": "v900"}]
              + _mk("v900", "TLog.Commit", 0.02, 0.04)
              + _mk("c2", "Client.Commit", 0.0, 0.01))
    rep = TA.analyze(events)
    assert rep["spans"] == 4 and rep["unmatched"] == 0
    assert rep["flows"] == 2
    flows = TA.transaction_timelines(events)
    big = max(flows.values(), key=len)
    assert [s["Span"] for s in big] == ["Client.Commit", "Proxy.Resolve",
                                       "TLog.Commit"]
    st = rep["stages"]["Client.Commit"]
    assert st["n"] == 2 and st["p50"] == 0.01 and st["p99"] == 0.05
    assert rep == J_TA.analyze(events)


def test_analyze_fifo_pairing_for_concurrent_same_stage_spans():
    events = [
        {"Type": "CommitSpan", "Time": 0.0, "ID": "v1",
         "Span": "Resolver.ReadbackWait", "Phase": "Begin"},
        {"Type": "CommitSpan", "Time": 0.1, "ID": "v1",
         "Span": "Resolver.ReadbackWait", "Phase": "Begin"},
        {"Type": "CommitSpan", "Time": 0.2, "ID": "v1",
         "Span": "Resolver.ReadbackWait", "Phase": "End"},
        {"Type": "CommitSpan", "Time": 0.4, "ID": "v1",
         "Span": "Resolver.ReadbackWait", "Phase": "End"},
    ]
    spans, unmatched = TA.pair_spans(events)
    assert not unmatched
    assert sorted(round(s["Duration"], 6) for s in spans) == [0.2, 0.3]


def test_check_well_formed_catches_violations():
    good = _mk("a", "S", 0.0, 1.0)
    assert TA.check_well_formed(good) == []
    assert TA.check_well_formed(good[:1])
    assert TA.check_well_formed(good[1:])
    backwards = _mk("b", "S", 5.0, 1.0)
    assert any("ends before" in p for p in TA.check_well_formed(backwards))
    dangling = good + [{"Type": "CommitAttach", "Time": 0.0, "ID": "ghost1",
                        "To": "ghost2"}]
    assert any("dangling attach" in p for p in TA.check_well_formed(dangling))
    for events in (good, good[:1], good[1:], backwards, dangling):
        assert TA.check_well_formed(events) == J_TA.check_well_formed(events)


def test_check_well_formed_queue_delay_vs_version_fetch():
    ok = (_mk("b0.1", "Proxy.QueueDelay", 0.0, 1.0)
          + _mk("b0.1", "Proxy.GetCommitVersion", 1.0, 1.5))
    assert TA.check_well_formed(ok) == []
    bad = (_mk("b0.2", "Proxy.QueueDelay", 0.0, 1.2)
           + _mk("b0.2", "Proxy.GetCommitVersion", 1.0, 1.5))
    assert any("queue delay overlaps" in p
               for p in TA.check_well_formed(bad))


def test_queueing_ratio_rollup():
    events = (_mk("c1", "Client.Commit", 0.0, 0.09)
              + _mk("b0.1", "Proxy.GetCommitVersion", 0.0, 0.01)
              + _mk("b0.1", "Proxy.Resolve", 0.01, 0.02)
              + _mk("b0.1", "Proxy.TLogPush", 0.02, 0.04))
    rep = TA.analyze(events)
    assert rep["queueing_ratio"] == pytest.approx(2.25)
    rep2 = TA.analyze(events + _mk("b0.1", "Proxy.QueueDelay", 0.0, 5.0))
    assert rep2["queueing_ratio"] == pytest.approx(2.25)
    assert TA.analyze(events[2:])["queueing_ratio"] is None


def test_load_events_skips_torn_lines(tmp_path):
    p = tmp_path / "trace.jsonl"
    p.write_text('{"Type": "CommitSpan", "ID": "x"}\n'
                 "\n"
                 '{"Type": "Commit')
    events = TA.load_events([str(p)])
    assert len(events) == 1 and events[0]["ID"] == "x"


# ------------------------------------------------- simulated commit path

EXPECTED_STAGES = {
    "Client.GRV", "Client.Commit", "Proxy.BatchAssembly",
    "Proxy.QueueDelay", "Proxy.GetCommitVersion", "Proxy.Resolve",
    "Proxy.TLogPush", "Proxy.Reply", "Resolver.Dispatch", "TLog.Commit",
}


def _run_workload(seed: int, jax: bool = False) -> list[dict]:
    """A small commit workload on a fresh SimCluster of the port (or of
    the JAX package) with a capture sink; returns every record that
    reached the sink."""
    if jax:
        from foundationdb_tpu.server.cluster import SimCluster
        from foundationdb_tpu.utils.knobs import KNOBS
        trace = J_T
    else:
        from foundationdb_tpu_torch.server.cluster import SimCluster
        KNOBS, trace = TKNOBS, T

    got: list[dict] = []
    KNOBS.set("CONFLICT_BACKEND", "oracle")
    # spans an earlier test of this worker left buffered are not this run's
    trace.g_trace_batch._events.clear()
    try:
        trace.set_sink(got.append)
        trace.enable_suppression()
        c = SimCluster(seed=seed, n_proxies=2, n_resolvers=1, n_tlogs=1,
                       n_storage=1)
        db = c.database()

        async def client(cid: int):
            for i in range(6):
                tr = db.create_transaction()
                await tr.get(b"s%d.%d" % (cid, i))
                tr.set(b"s%d.%d" % (cid, i), b"v")
                await tr.commit()
        c.run_all([client(i) for i in range(3)], max_time=600.0)
        trace.g_trace_batch.dump()
        trace.flush_suppressed()
    finally:
        trace.set_sink(None)
        trace.disable_suppression()
        KNOBS.reset()
    return got


def _batch_records(events):
    return [dict(e) for e in events
            if e.get("Type") in ("CommitSpan", "CommitAttach", "CommitDebug")]


def test_sim_span_stream_well_formed_and_stitched():
    got = _run_workload(seed=11)
    seen_stages = {e["Span"] for e in got if "Span" in e}
    assert EXPECTED_STAGES <= seen_stages, seen_stages
    assert TA.check_well_formed(got) == []
    uf = TA.stitch(got)
    commit_ids = {e["ID"] for e in got
                  if e.get("Span") == "Client.Commit" and e["ID"].startswith("c")}
    version_ids = {e["ID"] for e in got if e.get("Span") == "TLog.Commit"}
    assert commit_ids and version_ids
    version_roots = {uf.find(v) for v in version_ids}
    stitched = [cid for cid in commit_ids if uf.find(cid) in version_roots]
    assert stitched, "no client commit id stitched through to a version"
    assert not [e for e in got if e["Type"] == "TraceEventsSuppressed"]
    rep = TA.analyze(got)
    assert rep["unmatched"] == 0
    for stage in EXPECTED_STAGES:
        assert rep["stages"][stage]["n"] >= 1


def test_sim_span_stream_deterministic():
    a = _batch_records(_run_workload(seed=23))
    b = _batch_records(_run_workload(seed=23))
    assert a == b
    c = _batch_records(_run_workload(seed=24))
    assert [e.get("Span") for e in a] != [e.get("Span") for e in c] or a != c


def test_status_carries_all_six_role_counters():
    from foundationdb_tpu_torch.server.cluster import RecoverableCluster

    TKNOBS.set("CONFLICT_BACKEND", "oracle")
    c = RecoverableCluster(seed=5)
    db = c.database()

    async def work():
        await db.refresh(max_wait=300.0)
        for i in range(8):
            async def fn(tr, i=i):
                await tr.get(b"st%d" % i)
                tr.set(b"st%d" % i, b"v")
            await db.transact(fn, max_retries=50)
        return await db.get_status()
    status = c.run(c.loop.spawn(work()), max_time=60_000.0)

    by_kind: dict[str, list[dict]] = {}
    for entry in status["cluster"]["roles"]:
        by_kind.setdefault(entry["role"], []).append(entry)
    for kind in ("master", "proxy", "resolver", "log", "storage",
                 "ratekeeper", "cluster_controller"):
        assert kind in by_kind, f"missing {kind}: {sorted(by_kind)}"
        assert any("counters" in e for e in by_kind[kind]), kind
    master = next(e["counters"] for e in by_kind["master"] if "counters" in e)
    assert master["VersionRequests"] >= 8
    resolver = next(e["counters"] for e in by_kind["resolver"]
                    if "counters" in e)
    assert resolver["TxnResolved"] >= 8
    assert resolver["Backend"] == "oracle"
    log = next(e["counters"] for e in by_kind["log"] if "counters" in e)
    assert log["Commits"] >= 8 and log["BytesIn"] > 0
    assert sum(e["counters"]["MutationsApplied"]
               for e in by_kind["storage"] if "counters" in e) >= 8
    rk = next(e["counters"] for e in by_kind["ratekeeper"] if "counters" in e)
    assert rk["TPS"] > 0
    workload = status["cluster"]["workload"]
    assert workload["transactions_committed"] >= 8
    assert workload["mutation_bytes"] > 0
    assert workload["commit_batches"] >= 1


# ------------------------------------------------------- across packages

@pytest.mark.parametrize("seed", [11, 23])
def test_span_stream_equals_the_jax_simclusters(seed):
    """Same seed, oracle backend: the port SimCluster's span, attach and
    debug records equal the JAX SimCluster's record for record, virtual
    times included, and the analyses of the two streams are equal."""
    port = _run_workload(seed)
    jax = _run_workload(seed, jax=True)
    assert _batch_records(port) == _batch_records(jax)
    assert TA.analyze(_batch_records(port)) == J_TA.analyze(
        _batch_records(jax))


def test_suppression_and_rolling_file_match_the_jax_trace(tmp_path):
    """Per-type suppression drops and reports the same events in both
    packages; the rolling file rolls at its size and keeps `keep` rolls."""
    def suppressed(trace):
        got: list[dict] = []
        trace.set_sink(got.append)
        trace.set_clock(lambda: 100.0)
        trace.enable_suppression(limit=3, interval=5.0)
        try:
            for i in range(7):
                trace.TraceEvent("Chatty", "x").detail("I", i).log()
            trace.TraceEvent("Boom", "x", trace.SevError).detail(
                "I", 0).log()
            trace.set_min_severity(trace.SevWarn)
            trace.TraceEvent("Quiet", "x").log()
            trace.set_min_severity(trace.SevInfo)
            trace.flush_suppressed()
        finally:
            import time
            trace.set_clock(time.time)
            trace.disable_suppression()
            trace.set_sink(None)
        return got
    got = suppressed(T)
    assert got == suppressed(J_T)
    assert [e["Type"] for e in got].count("Chatty") == 3
    assert got[-1] == {"Type": "TraceEventsSuppressed", "Time": 100.0,
                       "OfType": "Chatty", "Dropped": 4}

    path = tmp_path / "t" / "trace.jsonl"
    rt = T.RollingTraceFile(str(path), roll_bytes=200, keep=2)
    for i in range(40):
        rt.write({"Type": "Line", "I": i})
    rt.close()
    rolled = sorted(p.name for p in path.parent.iterdir())
    assert rolled == ["trace.jsonl", "trace.jsonl.1", "trace.jsonl.2"]
    events = TA.load_events([str(path) + ".2", str(path) + ".1", str(path)])
    assert [e["I"] for e in events] == list(range(40 - len(events), 40))


def test_chip_smoke_phase13_checks_pass_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 13 at a small size on the port's plain
    versions: 13a's roles over TCP in this process (every batch equal to
    the oracle, every acknowledged write read back, two readbacks in
    flight at once), 13b's two server processes (Cycle, fdbbackup, the
    resolvers' metrics, SIGTERM exits 0, the restart, well-formed traces)."""
    import torch

    import chip_smoke
    from test_torch_transport import SHAPE_KNOBS, free_addr

    monkeypatch.setattr(chip_smoke, "net_addresses",
                        lambda n: [free_addr() for _ in range(n)])
    monkeypatch.setattr(chip_smoke, "NET_READY_S", 120.0)
    monkeypatch.setattr(chip_smoke, "NET_STOP_S", 20.0)
    out = chip_smoke.net_phase(
        torch.device("cpu"), 1,
        inprocess=dict(n_clients=8, n_attempts=3, n_keys=300,
                       knobs=SHAPE_KNOBS),
        processes=dict(n_nodes=60, n_rotators=8, n_txns=3,
                       knobs=SHAPE_KNOBS))
    a, b = out["13a"], out["13b"]
    assert a["attempts"] == 24 and a["committed"] >= 1
    assert a["read_back_mismatches"] == {"client": 0, "storage": 0}
    assert a["mismatched_batches"] == 0 and a["resolved_batches"] > 0
    assert a["readbacks"] == a["drain_groups"] >= 2
    assert a["max_readbacks_in_flight"] >= 2
    assert b["committed"] == 24
    assert b["ring_whole"] and b["ring_whole_after_restart"]
    assert [t["problems"] for t in b["trace"]] == [[], []]
    assert all(m["Backend"] == "cpu" for m in b["resolver_metrics"])
    assert json.dumps(out, default=str)
