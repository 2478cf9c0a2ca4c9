"""The port's own spans and counters over one run of a cell, on the card:

    python3 -m kvbench.program_spans --workload <cell> --seeds 1,2,... \\
        --seconds 5 [--out spans.jsonl]

The port (foundationdb_tpu_torch) times its device path onto counters of
its CounterCollections while its spans are on (`utils/trace.py`
`enable_spans`) and names them as torch.profiler ranges. The benchmark's
own runs (`kvbench.run`) leave the spans off. This tool runs a cell as
they do, from the harness's parts (set-up and pass 0, the encoded pool,
the window, the traced slice), with the spans on, and prints one JSON line
a seed:

- `readings`: five host readings a batch, in us, from the counters'
  deltas (`readings`): the copy's enqueue, the graph's replay and the
  readback's enqueue over the windows with the spans on; the encode and
  the verdicts (`DetectHandle.result`'s loop) over set-up, whose pass 0
  runs the whole program path;
- `host_us_per_batch`, `txns_per_s`: the harness's dispatch span and the
  rate of windows that take turns with the spans off and on, so the
  spans' cost when on is their difference in one process;
- `counts`: the graph captures of set-up and of the windows, the exact
  host pass's seconds and chunks;
- `idle_by_span`: the traced slice's idle device seconds by the innermost
  host range that covers them, the port's span before the harness's
  (`idle_by_span`), and `idle_s`, the slice's window less its busy time.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import importlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from foundationdb_tpu_torch.utils import trace
from kvbench import harness, timeline

# collection -> module attribute of the port that holds it
COLLECTIONS = {
    "ConflictKernel": ("foundationdb_tpu_torch.ops.conflict",
                       "kernel_metrics"),
    "CudaTransfers": ("foundationdb_tpu_torch.utils.cudaenv",
                      "transfer_metrics"),
    "CudaGraphs": ("foundationdb_tpu_torch.ops.step_graph", "graph_metrics"),
}

# reading -> (phase, collection, seconds counter, count counters)
READINGS = {
    "copy_us_per_batch": ("window", "CudaTransfers", "DevicePutSeconds",
                          ("DevicePuts",)),
    "replay_us_per_batch": ("window", "CudaGraphs", "GraphReplaySeconds",
                            ("GraphReplays",)),
    "readback_us_per_batch": ("window", "CudaTransfers", "DeviceGetSeconds",
                              ("DeviceGets",)),
    "encode_us_per_batch": ("setup", "ConflictKernel", "EncodeSeconds",
                            ("EncodedChunksC", "EncodedChunksPy")),
    "verdicts_us_per_batch": ("setup", "ConflictKernel", "VerdictSeconds",
                              ("VerdictRows",)),
}
HOST = "host"


def snapshot() -> dict:
    """{collection: {counter: value}} of the port's collections; one that
    the port does not have is left out."""
    out = {}
    for name, (module, attr) in COLLECTIONS.items():
        coll = getattr(importlib.import_module(module), attr, None)
        if coll is not None:
            out[name] = coll.as_dict()
    return out


def delta(before: dict, after: dict) -> dict:
    return {c: {k: v - before.get(c, {}).get(k, 0) for k, v in kv.items()}
            for c, kv in after.items()}


def add(a: dict, b: dict) -> dict:
    return {c: {k: a.get(c, {}).get(k, 0) + v for k, v in kv.items()}
            for c, kv in b.items()}


def reading(program: dict, name: str):
    """Reading `name` of READINGS from `program` ({phase: delta}): its
    seconds over its count, in us; None where the count is 0, where no
    seconds were taken (the spans off) or where the port lacks the
    counters."""
    phase, coll, secs, counts = READINGS[name]
    got = program.get(phase, {}).get(coll, {})
    if secs not in got or any(c not in got for c in counts):
        return None
    n = sum(got[c] for c in counts)
    return got[secs] / n * 1e6 if n and got[secs] else None


def readings(program: dict) -> dict:
    return {name: reading(program, name) for name in READINGS}


def _ranges(events: list, names) -> tuple:
    """(name, start, end) of the user ranges that `names(name)` keeps,
    sorted by start; their starts; and the longest one's length."""
    out = sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("ph") == "X" and "dur" in e
                  and e.get("cat") == "user_annotation" and names(e["name"])),
                 key=lambda r: r[1])
    return (out, [s for _n, s, _e in out],
            max((e - s for _n, s, e in out), default=0.0))


def _innermost(ranges: tuple, lo: float, hi: float):
    """The innermost range (the latest to start) of `ranges` that covers
    all of [lo, hi), or None."""
    spans, starts, longest = ranges
    i = bisect.bisect_right(starts, lo)
    best = None
    for n, s, e in reversed(spans[bisect.bisect_left(starts, lo - longest):i]):
        if e >= hi and (best is None or s > best[1]):
            best = (n, s)
    return None if best is None else best[0]


def attribute(events: list, gaps: list, port_names) -> list:
    """Each gap (start, end) in us split where a range begins or ends, each
    piece named by the innermost of the port's ranges (names in
    `port_names`) that covers it, else the innermost of the harness's
    `kvbench.*` ranges, else HOST: a list of (name, us) a gap."""
    port = _ranges(events, lambda n: n in port_names)
    bench = _ranges(events, lambda n: n.startswith("kvbench.")
                    and n != timeline.WINDOW)
    edges = sorted({t for spans, _s, _l in (port, bench)
                    for _n, s, e in spans for t in (s, e)})
    out = []
    for lo, hi in gaps:
        cuts = [lo] + edges[bisect.bisect_right(edges, lo):
                            bisect.bisect_left(edges, hi)] + [hi]
        pieces = []
        for a, b in zip(cuts, cuts[1:]):
            if b > a:
                name = (_innermost(port, a, b) or _innermost(bench, a, b)
                        or HOST)
                pieces.append((name, b - a))
        out.append(pieces)
    return out


def idle_by_span(events: list, tl: timeline.Timeline, port_names,
                 top: int = timeline.TOP) -> list:
    """[[name, idle seconds]] of the slice by `attribute`, the largest
    `top`, the largest first."""
    total: dict = {}
    for pieces in attribute(events, tl.gaps(), port_names):
        for name, us in pieces:
            total[name] = total.get(name, 0.0) + us / 1e6
    return [[n, v] for n, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def longest_gaps(events: list, tl: timeline.Timeline, port_names,
                 top: int = 5) -> list:
    """[[name, seconds]] of the `top` longest idle gaps, each named by what
    holds the most of it (`attribute`)."""
    gaps = sorted(tl.gaps(), key=lambda g: g[0] - g[1])[:top]
    out = []
    for (lo, hi), pieces in zip(gaps, attribute(events, gaps, port_names)):
        held: dict = {}
        for name, us in pieces:
            held[name] = held.get(name, 0.0) + us
        out.append([max(held, key=held.get), (hi - lo) / 1e6])
    return out


def run(bench: dict, name: str, seed: int, seconds: float, *,
        device: str = "cuda", overrides=None, windows: int = 4) -> dict:
    """One run of cell `name` with the spans on, as the docstring above
    sets out; `windows` windows of `seconds` each, the spans off in the
    first and in every other one after it."""
    c = harness.cell(bench, name, overrides)
    with harness.engine_window(int(c["config"]["engine"]["max_write_life"])):
        trace.enable_spans(True)
        try:
            return _run(c, seed, seconds, torch.device(device), windows)
        finally:
            trace.enable_spans(False)


def _run(c, seed, seconds, dev, windows) -> dict:
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    p0 = snapshot()
    gc.disable()
    try:
        s = harness.Setup(c["config"], c["traffic"], seed, dev)
        pipe = harness.Pipeline(s)
        k = pipe.run_batches(0, s.P)
        s.encode_pool()
        pipe.next_pass()
        s.sync()
        gc.collect()
        gc.freeze()
    finally:
        gc.enable()
    p1 = snapshot()
    on_delta: dict = {}
    host = {"off": [], "on": []}
    rate = {"off": [], "on": []}
    for i in range(windows):
        on = i % 2 == 1
        trace.enable_spans(on)
        pipe.spans = {"dispatch_s": []}
        first = len(pipe.ks)
        before = snapshot()
        k, window_s = pipe.run_for(k, seconds)
        after = snapshot()
        if on:
            on_delta = add(on_delta, delta(before, after))
        key = "on" if on else "off"
        host[key].append(float(np.mean(pipe.spans["dispatch_s"])) * 1e6)
        rate[key].append((len(pipe.ks) - first) * s.T / window_s)
    pipe.spans = None
    trace.enable_spans(True)
    p2 = snapshot()
    setup = delta(p0, p1)
    out = {"readings": readings({"setup": setup, "window": on_delta}),
           "host_us_per_batch": host, "txns_per_s": rate,
           "on_cost_us": float(np.mean(host["on"]) - np.mean(host["off"])),
           "counts": {
               "graph_captures_setup": setup.get("CudaGraphs", {}).get(
                   "GraphCaptures"),
               "graph_captures_window": delta(p1, p2).get(
                   "CudaGraphs", {}).get("GraphCaptures"),
               "host_pass_s": setup["ConflictKernel"].get("HostPassSeconds"),
               "unconverged": setup["ConflictKernel"]["UnconvergedChunks"],
               "window_batches": len(pipe.ks) - s.P}}
    n_active = int(c["traffic"].get("trace_batches", 500))
    with tempfile.TemporaryDirectory(prefix="kvbench-spans-") as tmp:
        path = Path(tmp) / "trace.json"
        harness.profiled_slice(pipe, k, max(n_active // 4, 8), n_active,
                               path)
        events = json.loads(path.read_text())["traceEvents"]
        tl = timeline.load(path)
    names = set(trace.SPAN_NAMES)
    out["idle_by_span"] = idle_by_span(events, tl, names)
    out["idle_s"] = tl.window_s() - tl.busy_s()
    out["longest_gaps"] = longest_gaps(events, tl, names)
    out["idle_gaps"] = tl.breakdown()["idle_gaps"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kvbench.program_spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kvbench.program_spans: no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    bench = harness.load_benchmark()
    for seed in (int(x) for x in args.seeds.split(",") if x):
        r = run(bench, args.workload, seed, args.seconds)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "kind": torch.cuda.get_device_name(), **r})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
