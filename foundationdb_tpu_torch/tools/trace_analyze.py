"""trace_analyze: reconstruct per-transaction commit timelines from spans.

Reads the JSON-lines trace files the roles emit (TraceBatch span records,
utils/trace.py) and answers "where does a commit spend its time": for every
pipeline stage — client GRV, proxy batch assembly, commit-version fetch,
resolve (kernel dispatch vs device readback wait), tlog push, reply — it
pairs Begin/End records, stitches idents across roles through the
CommitAttach records (client debug_id -> proxy batch -> commit version), and
prints per-stage count / p50 / p99 residency.

    python -m foundationdb_tpu_torch.tools.trace_analyze trace*.jsonl
    python -m foundationdb_tpu_torch.tools.trace_analyze --json trace*.jsonl

The same parsing doubles as the simulation tier's well-formedness check
(`check_well_formed`): every Begin must have a matching End, and attaches
must resolve to idents that actually appear in the stream.
"""

from __future__ import annotations

import argparse
import json
import sys


def load_events(paths) -> list[dict]:
    """All records from the given JSON-lines trace files, in file order.
    Bad lines are skipped (a process killed mid-write leaves a torn tail)."""
    events: list[dict] = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict):
                    events.append(rec)
    return events


class _UnionFind:
    """Ident stitching: CommitAttach(a -> b) means a and b name the same
    transaction flow; the component representative groups every span that
    belongs to one commit across client/proxy/resolver/tlog idents."""

    def __init__(self):
        self.parent: dict[str, str] = {}

    def find(self, x: str) -> str:
        self.parent.setdefault(x, x)
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:  # path compression
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: str, b: str):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def pair_spans(events) -> tuple[list[dict], list[dict]]:
    """Match Begin/End records by (ID, Span), FIFO within a key (concurrent
    same-stage spans on one ident nest in emission order). Returns
    (completed spans with Start/End/Duration, unmatched records)."""
    open_spans: dict[tuple[str, str], list[dict]] = {}
    done: list[dict] = []
    unmatched: list[dict] = []
    for ev in events:
        if "Span" not in ev or "Phase" not in ev:
            continue
        key = (str(ev.get("ID")), ev["Span"])
        if ev["Phase"] == "Begin":
            open_spans.setdefault(key, []).append(ev)
        elif ev["Phase"] == "End":
            stack = open_spans.get(key)
            if not stack:
                unmatched.append(ev)
                continue
            begin = stack.pop(0)
            done.append({"ID": key[0], "Span": key[1],
                         "Start": begin.get("Time", 0.0),
                         "End": ev.get("Time", 0.0),
                         "Duration": round(ev.get("Time", 0.0)
                                           - begin.get("Time", 0.0), 6)})
    for stack in open_spans.values():
        unmatched.extend(stack)
    return done, unmatched


def stitch(events) -> _UnionFind:
    uf = _UnionFind()
    for ev in events:
        if ev.get("Type") == "CommitAttach" and "To" in ev:
            uf.union(str(ev.get("ID")), str(ev["To"]))
    return uf


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample."""
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


# the commit path's server-side stages, in pipeline order; their p50 sum is
# the denominator of queueing_ratio (Proxy.QueueDelay is deliberately NOT a
# member — it IS the queueing being measured)
SERVER_STAGES = ("Proxy.BatchAssembly", "Proxy.GetCommitVersion",
                 "Proxy.Resolve", "Proxy.TLogPush", "Proxy.Reply")


def queueing_ratio(stages: dict) -> float | None:
    """Client.Commit p50 over the summed p50s of the server-side commit
    stages: ~1 means end-to-end latency is explained by work, large values
    mean the commit spent its life waiting in queues (BENCH_r08 was ~9x).
    None when the trace carries no client or no server commit spans."""
    client = stages.get("Client.Commit")
    server = sum(stages[s]["p50"] for s in SERVER_STAGES if s in stages)
    if not client or server <= 0.0:
        return None
    return round(client["p50"] / server, 2)


def readback_overlap_ratio(spans) -> float | None:
    """How much of the device→host verdict readback hides under subsequent
    dispatches. Per batch (ident): the D2H copy is in flight from the end
    of its Resolver.Dispatch until its Resolver.ReadbackWait begins —
    hidden time, the resolver was dispatching other batches — while the
    ReadbackWait span itself is the exposed stall. hidden/(hidden+exposed)
    over all batches: 1.0 = readback fully overlapped with dispatch, 0.0 =
    every copy is a synchronous stall (CONFLICT_READBACK_OVERLAP=False).
    None when the trace carries no readback spans (oracle backend)."""
    dispatch_end: dict[str, float] = {}
    for s in spans:
        if s["Span"] == "Resolver.Dispatch":
            prev = dispatch_end.get(s["ID"])
            dispatch_end[s["ID"]] = s["End"] if prev is None \
                else min(prev, s["End"])
    hidden = exposed = 0.0
    seen = False
    for s in spans:
        if s["Span"] != "Resolver.ReadbackWait":
            continue
        seen = True
        exposed += s["Duration"]
        de = dispatch_end.get(s["ID"])
        if de is not None:
            hidden += max(0.0, s["Start"] - de)
    if not seen or hidden + exposed <= 0.0:
        return None
    return round(hidden / (hidden + exposed), 4)


def stage_stats(spans) -> dict:
    """Per-stage residency: {span_name: {n, p50, p99, total}} seconds."""
    by_stage: dict[str, list[float]] = {}
    for s in spans:
        by_stage.setdefault(s["Span"], []).append(s["Duration"])
    out = {}
    for stage, durs in sorted(by_stage.items()):
        durs.sort()
        out[stage] = {"n": len(durs),
                      "p50": round(_percentile(durs, 0.50), 6),
                      "p99": round(_percentile(durs, 0.99), 6),
                      "total": round(sum(durs), 6)}
    return out


def transaction_timelines(events) -> dict[str, list[dict]]:
    """Spans grouped by stitched transaction flow, each sorted by start
    time — the per-commit waterfall."""
    spans, _ = pair_spans(events)
    uf = stitch(events)
    flows: dict[str, list[dict]] = {}
    for s in spans:
        flows.setdefault(uf.find(s["ID"]), []).append(s)
    for timeline in flows.values():
        timeline.sort(key=lambda s: (s["Start"], s["Span"]))
    return flows


def check_well_formed(events) -> list[str]:
    """Span-stream invariants; returns human-readable violations (empty ==
    well formed). Used by the sim-tier smoke test."""
    problems: list[str] = []
    spans, unmatched = pair_spans(events)
    for ev in unmatched:
        problems.append(f"unbalanced span: {ev.get('Phase')} "
                        f"{ev.get('Span')} id={ev.get('ID')}")
    for s in spans:
        if s["End"] < s["Start"]:
            problems.append(f"span ends before it starts: {s['Span']} "
                            f"id={s['ID']}")
    # Proxy.QueueDelay covers arrival -> batch dispatch: on any ident that
    # also carries the batch's GetCommitVersion span, the queue delay must
    # have ENDED by the time the version fetch starts (equal timestamps ok)
    gcv_start: dict[str, float] = {}
    for s in spans:
        if s["Span"] == "Proxy.GetCommitVersion":
            prev = gcv_start.get(s["ID"])
            gcv_start[s["ID"]] = s["Start"] if prev is None \
                else min(prev, s["Start"])
    for s in spans:
        if s["Span"] != "Proxy.QueueDelay":
            continue
        start = gcv_start.get(s["ID"])
        if start is not None and s["End"] > start + 1e-6:
            problems.append(f"queue delay overlaps version fetch: "
                            f"id={s['ID']}")
    ids_with_spans = {s["ID"] for s in spans}
    for ev in events:
        if ev.get("Type") != "CommitAttach" or "To" not in ev:
            continue
        # an attach whose BOTH ends name idents no span ever used is dead
        # weight — something emitted bookkeeping for a flow that never ran
        if (str(ev.get("ID")) not in ids_with_spans
                and str(ev["To"]) not in ids_with_spans):
            problems.append(f"dangling attach: {ev.get('ID')} -> {ev['To']}")
    return problems


_CONTENTION_KEYS = ("TxnCommitIn", "TxnCommitted", "TxnConflicts",
                    "TxnThrottled")


def contention_stats(events) -> dict:
    """Cluster-wide commit admission outcomes from the proxies' cumulative
    counter records: abort_rate = conflicts/commits-in, throttle_rate =
    throttled/commits-in. Counters are cumulative per process, so take the
    running max per ID and sum across IDs (a proxy that restarts re-counts
    from zero; max-then-sum keeps each process's largest completed view)."""
    per_id: dict[str, dict[str, int]] = {}
    for ev in events:
        if ev.get("Type") != "ProxyMetrics":
            continue
        d = per_id.setdefault(str(ev.get("ID")),
                              dict.fromkeys(_CONTENTION_KEYS, 0))
        for k in _CONTENTION_KEYS:
            v = ev.get(k)
            if isinstance(v, (int, float)):
                d[k] = max(d[k], v)
    tot = {k: sum(d[k] for d in per_id.values()) for k in _CONTENTION_KEYS}
    n = tot["TxnCommitIn"]
    return {
        "commits_in": n,
        "committed": tot["TxnCommitted"],
        "conflicts": tot["TxnConflicts"],
        "throttled": tot["TxnThrottled"],
        "abort_rate": round(tot["TxnConflicts"] / n, 4) if n else 0.0,
        "throttle_rate": round(tot["TxnThrottled"] / n, 4) if n else 0.0,
    }


_TRANSPORT_KEYS = ("TransportFramesIn", "TransportFramesOut",
                   "TransportBytesIn", "TransportBytesOut",
                   "TransportChecksumRejects",
                   "TransportNativeFastPathHits",
                   "TransportPySlowPathFalls")


def transport_stats(events) -> dict:
    """Cluster-wide wire-plane tallies from the periodic counter dumps.
    Transport counters are process-wide — every role co-hosted on one
    process repeats the same tallies under its own Metrics event, and the
    event ID is the process address — so take the running max per ID
    (dedupes co-hosted roles AND restarts) and sum across IDs.
    native_hit_rate = C fast-path serves / frames in."""
    per_id: dict[str, dict[str, int]] = {}
    for ev in events:
        if "TransportFramesIn" not in ev:
            continue
        d = per_id.setdefault(str(ev.get("ID")),
                              dict.fromkeys(_TRANSPORT_KEYS, 0))
        for k in _TRANSPORT_KEYS:
            v = ev.get(k)
            if isinstance(v, (int, float)):
                d[k] = max(d[k], v)
    tot = {k: sum(d[k] for d in per_id.values()) for k in _TRANSPORT_KEYS}
    frames = tot["TransportFramesIn"]
    return {
        "frames_in": frames,
        "frames_out": tot["TransportFramesOut"],
        "bytes_in": tot["TransportBytesIn"],
        "bytes_out": tot["TransportBytesOut"],
        "checksum_rejects": tot["TransportChecksumRejects"],
        "native_fast_path_hits": tot["TransportNativeFastPathHits"],
        "py_slow_path_falls": tot["TransportPySlowPathFalls"],
        "native_hit_rate": (round(tot["TransportNativeFastPathHits"]
                                  / frames, 4) if frames else 0.0),
    }


def analyze(events) -> dict:
    spans, unmatched = pair_spans(events)
    flows = transaction_timelines(events)
    stages = stage_stats(spans)
    return {
        "events": len(events),
        "spans": len(spans),
        "unmatched": len(unmatched),
        "flows": len(flows),
        "stages": stages,
        "queueing_ratio": queueing_ratio(stages),
        "readback_overlap_ratio": readback_overlap_ratio(spans),
        "contention": contention_stats(events),
        "transport": transport_stats(events),
    }


def format_report(report: dict) -> str:
    lines = [f"events={report['events']} spans={report['spans']} "
             f"flows={report['flows']} unmatched={report['unmatched']}",
             f"{'stage':<28} {'n':>7} {'p50 (s)':>10} {'p99 (s)':>10} "
             f"{'total (s)':>10}"]
    for stage, st in report["stages"].items():
        lines.append(f"{stage:<28} {st['n']:>7} {st['p50']:>10.6f} "
                     f"{st['p99']:>10.6f} {st['total']:>10.3f}")
    qr = report.get("queueing_ratio")
    if qr is not None:
        lines.append(f"queueing_ratio (Client.Commit p50 / server stages "
                     f"p50 sum): {qr:.2f}")
    ror = report.get("readback_overlap_ratio")
    if ror is not None:
        lines.append(f"readback_overlap_ratio (hidden under dispatch / "
                     f"total readback): {ror:.4f}")
    con = report.get("contention")
    if con and con["commits_in"]:
        lines.append(
            f"contention: commits_in={con['commits_in']} "
            f"committed={con['committed']} "
            f"abort_rate={con['abort_rate']:.4f} "
            f"throttle_rate={con['throttle_rate']:.4f}")
    tp = report.get("transport")
    if tp and tp["frames_in"]:
        lines.append(
            f"transport: frames_in={tp['frames_in']} "
            f"frames_out={tp['frames_out']} "
            f"checksum_rejects={tp['checksum_rejects']} "
            f"native_hit_rate={tp['native_hit_rate']:.4f} "
            f"slow_falls={tp['py_slow_path_falls']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="trace_analyze",
        description="per-stage commit latency from span trace files")
    ap.add_argument("paths", nargs="+", help="JSON-lines trace files")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of a table")
    args = ap.parse_args(argv)
    events = load_events(args.paths)
    report = analyze(events)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(format_report(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
