"""kvbench's harness: one run of one cell, from set-up to the result line.

A cell of BENCHMARK.json names a configuration (kvbench/configs/<name>.json)
and a traffic mix (kvbench/traffic/<name>.json, drawn by the kinds that
kvbench/gen.py finds by name); every metric is read by
kvbench/metrics/<name>.py. The harness finds them all by name, so a cell,
a mix, a kind or a metric is added with files and BENCHMARK.json entries
alone.

The system under test is the resolver engine of `foundationdb_tpu_torch`,
a `DeviceConflictSet`, on its device path: the encode is left out. A run:

1. loads the kernel library and the C extension (built into
   foundationdb_tpu_torch/_build/ by the first run of a checkout);
2. draws the cell's stream, a pool of P batches, from the seed
   (kvbench/gen.py);
3. builds the engine (its fixed state) and runs pass 0, the pool once
   through `detect_async` and `drain_and_collect` with four batches in
   flight: the whole program path, the encode and the host's too-old pass
   with it. The too-old verdicts it took stay the pool's skip lists;
4. encodes the pool with the port's `BatchEncoder` (its C pass) into pinned
   host memory, each batch into its shape bucket (`plan_chunk`);
5. rebases the engine by the pool's span: pass p replays the pool p spans
   up, so at each pass the engine rebases by the span (`rebase_state`, the
   operation of its `_maybe_rebase`) and the encoded offsets stand
   unchanged;
6. measures for `seconds`, replaying the pool: a batch is what
   `dispatch_chunk` does after its encode (`_maybe_rebase`, one copy of
   the pinned buffer into the bucket's `StepGraph` buffer, one replay,
   one asynchronous readback of the row), four batches in flight
   (COMMIT_PIPELINE_DEPTH) as a closed loop, each waited for on its
   readback's event and kept by its row's CRC-32;
7. with tracing, replays a slice more under torch.profiler;
8. turns each distinct row into verdicts with the port's
   `DetectHandle.result`, frees the program's state and holds every
   batch's verdicts, pass 0's too, to the plain reference
   (kvbench/reference.py).

The per-txn work of the host (the encode, `DetectHandle.result`) is left
out of the window: it paces the loop where it runs there, and the host's
pace differs between processes on a shared machine far more than the
card's.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import sys
import tempfile
import time
import zlib
from collections import deque
from pathlib import Path

import numpy as np
import torch

from foundationdb_tpu_torch import native
from foundationdb_tpu_torch.ops import conflict
from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops import kernels
from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
from foundationdb_tpu_torch.ops.step_graph import (StepGraph, batch_layout,
                                                   batch_views)
from foundationdb_tpu_torch.utils import cudaenv
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS
from kvbench import gen, reference, timeline

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "foundationdb_tpu")
CHECK_LIMITS = {"wrong_batches": 0, "unchecked_batches": 0,
                "failed_batches": 0}
MAX_REFERENCE_PASSES = 32  # the passes loop after a few (reference.py)


def log(msg: str):
    print(f"[kvbench] {msg}", file=sys.stderr, flush=True)


def load_benchmark(checkout: Path = CHECKOUT) -> dict:
    return json.loads((checkout / "BENCHMARK.json").read_text())


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def cell(bench: dict, name: str, overrides: dict | None = None) -> dict:
    """The workload entry, its configuration and its traffic, by name.
    `overrides` ({"config": {...}, "traffic": {...}}) are merged in (the
    CPU tests shrink a cell so)."""
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = json.loads((ROOT.parent / conf["file"]).read_text())
    traffic = json.loads(
        (ROOT / "traffic" / f"{work['traffic']}.json").read_text())
    over = overrides or {}
    return {"workload": work, "config": _merge(config, over.get("config", {})),
            "traffic": _merge(traffic, over.get("traffic", {}))}


def metrics_of(bench: dict, cell_name: str, traced: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with tracing its per-layer ones."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def reader(name: str):
    """kvbench/metrics/<name>.py, whose `read(ctx)` returns the metric's
    value, or None where it finds nothing to read."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "kvbench_metric_" + "".join(c if c.isalnum() else "_" for c in name),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    the name before the first dot compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class AblatedConflictSet(conflict.DeviceConflictSet):
    """The control: the engine with one of its step's ablations switched
    on (`conflict_ref.ABLATE_MODES`), in its graphs and its eager step."""

    def __init__(self, *args, ablate: str, **kw):
        super().__init__(*args, **kw)
        self.ablate = ablate

    def _graph(self, shapes):
        if self.device.type != "cuda":
            return None
        key = (shapes.reads, shapes.writes)
        if key not in self._graphs:
            self._graphs[key] = StepGraph(
                self._state, txns=shapes.txns, reads=shapes.reads,
                writes=shapes.writes,
                max_write_life=KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
                intra_rounds=self._intra_rounds, strided=shapes.strided,
                intra_mode=self._intra_mode, ablate=self.ablate)
        return self._graphs[key]

    def _step(self, batch):
        _s, _st, info = ref.conflict_step(
            self._state, batch,
            max_write_life=KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
            intra_rounds=self._intra_rounds, intra_mode=self._intra_mode,
            strided=self.shapes.strided, phases=kernels.PHASES,
            ablate=self.ablate, out=self._state)
        return info["readback"]


def unconverged_chunks() -> int:
    return conflict.kernel_metrics.as_dict()["UnconvergedChunks"]


# ---------------------------------------------------------------------------
# the engine and the pool
# ---------------------------------------------------------------------------

class Setup:
    """The engine (a DeviceConflictSet) and the stream's pool, its txns as
    the port's TxnConflictInfo lists; `encode_pool` adds the pool encoded
    into pinned memory."""

    def __init__(self, config: dict, traffic: dict, seed: int, dev, *,
                 ablate: str = ""):
        self.dev = dev
        if dev.type == "cuda":
            t0 = time.perf_counter()
            kernels.library()
            log(f"kernel library {kernels.BUILD_INFO.get('library')} "
                f"(built here: {not kernels.BUILD_INFO.get('cached')}, "
                f"{time.perf_counter() - t0:.3f} s)")
        if not native.available():
            if dev.type == "cuda":
                raise RuntimeError(f"the port's C extension did not build: "
                                   f"{native.build_error()}")
            log("the C extension is not built: the numpy encode runs")

        eng = config["engine"]
        self.W = int(eng["max_write_life"])
        if KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS != self.W:
            raise ValueError(f"the engine's window is "
                             f"{KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS}, "
                             f"the configuration's {self.W}")
        t0 = time.perf_counter()
        stream = self.stream = gen.make_stream(config, traffic, seed)
        self.P, self.T = stream.batches, stream.txns
        self.span = stream.span
        self.depth = int(traffic["pipeline_depth"])
        self.txns = [self.txns_of(j) for j in range(self.P)]
        log(f"stream of {self.P} batches, {len(stream.keys)} keys, drawn in "
            f"{time.perf_counter() - t0:.3f} s")
        self.nr, self.nw = stream.rb.shape[2], stream.wb.shape[2]
        kw = dict(capacity=int(eng["capacity"]), txns=self.T,
                  reads_per_txn=self.nr, writes_per_txn=self.nw,
                  oldest_version=-self.W, key_bytes=int(eng["key_bytes"]),
                  device=dev, strided=eng["layout"] == "strided")
        self.engine = AblatedConflictSet(**kw, ablate=ablate) if ablate \
            else conflict.DeviceConflictSet(**kw)
        self.L = self.engine.shapes.limbs
        self.base = self.engine.base_version  # the pool's encoding base
        # pass 0 fills these: the host's too-old verdicts of each batch
        self.too_old: list = [None] * self.P
        self.pool_views = self.buckets = self.batch_bytes = None

    def txns_of(self, j: int) -> list:
        """Batch j of the pool as the port's TxnConflictInfo list."""
        s = self.stream
        return list(map(TxnConflictInfo, s.snapshot[j].tolist(),
                        self._ranges(s.rb[j], s.re[j]),
                        self._ranges(s.wb[j], s.we[j])))

    def _ranges(self, begin: np.ndarray, end: np.ndarray) -> list:
        """Each txn's list of (begin, end) byte-key pairs."""
        kb, n = self.stream.keys, begin.shape[1]
        pairs = list(zip(map(kb.__getitem__, begin.ravel().tolist()),
                         map(kb.__getitem__, end.ravel().tolist())))
        return [pairs[t:t + n] for t in range(0, len(pairs), n)]

    def encode_pool(self):
        """The pool in one pinned buffer, batch j encoded by the port's
        BatchEncoder at the engine's pass-0 base, skipping the txns that
        pass 0 found too old, in the shape bucket of what it keeps."""
        e = self.engine
        encoder = conflict.BatchEncoder(e.shapes, torch.device("cpu"),
                                        base_version=self.base)
        self.buckets = []
        for old in self.too_old:
            kept = self.T - sum(old)
            self.buckets.append(e.plan_chunk(kept * self.nr, kept * self.nw))
        self.layouts = [batch_layout(self.L, self.T, b.reads, b.writes)
                        for b in self.buckets]
        sizes = [size for _lay, size in self.layouts]
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        self.pool = cudaenv.host_buffer(int(offsets[-1]), torch.int32,
                                        self.dev)
        self.pool_views = [self.pool[int(offsets[j]):int(offsets[j + 1])]
                           for j in range(self.P)]
        self.batch_bytes = [4 * s for s in sizes]
        t0 = time.perf_counter()
        for j in range(self.P):
            encoder.encode_batch(self.txns[j], int(self.stream.versions[j]),
                                 skip=self.too_old[j], shapes=self.buckets[j],
                                 advance_floor=True, dest=self.pool_views[j])
        log(f"encoded {self.P} batches of {self.T} txns "
            f"({offsets[-1] * 4 / 2**20:.1f} MiB pinned) in "
            f"{time.perf_counter() - t0:.3f} s")

    def live_boundaries(self) -> int:
        return int(self.engine._state["nb"].item())

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

class Pipeline:
    """The closed loop: at most `depth` batches in flight; batch k is pool
    batch k % P of pass k // P. Pass 0 goes through `detect_async` and
    `drain_and_collect`. Later passes replay the encoded pool; the window
    waits for each batch's readback row and keeps it by its CRC-32. A pool
    batch's rows repeat from pass to pass, so only the distinct ones are
    kept, and `verdict_digests` turns each into its txns' verdicts with
    the port's `DetectHandle` after the window. Records every batch's
    resolve time (from its dispatch to its row, or pass 0's verdicts, on
    the host); with `spans` a dict of lists, the host seconds of each
    batch's dispatch."""

    def __init__(self, setup: Setup):
        self.s = setup
        self.inflight = deque()
        self.ks, self.lat, self.keys = [], [], []
        self.rows = {}  # (pool batch, the row's CRC-32) -> the row
        self.spans = None
        self.annotate = False
        self.passes = 1  # the pass whose rebase has run
        self.rebases = 0
        self.decode_s = 0.0

    def _range(self, name: str):
        if self.annotate:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def next_pass(self):
        """The engine rebased, as `_maybe_rebase` rebases it, to the base
        at which the pool was encoded moved up by the passes' spans, so
        the encoded pool stands for the next pass."""
        e = self.s.engine
        delta = self.s.base + self.passes * self.s.span - e.base_version
        with self._range("kvbench.rebase"):
            ref.rebase_state(e._state, delta, phases=kernels.PHASES,
                             out=e._state)
            e.encoder.base_version += delta
        self.passes += 1
        self.rebases += 1

    def submit(self, k: int):
        s, e = self.s, self.s.engine
        p, i = divmod(k, s.P)
        commit = p * s.span + int(s.stream.versions[i])
        if p == 0:
            t0 = time.perf_counter()
            handle = e.detect_async(s.txns[i], commit)
            (_sub, s.too_old[i], _row, _rb), = handle._chunks
            self.inflight.append((k, t0, handle, None))
            return
        if p == self.passes:
            self.next_pass()
        base = e.base_version
        e._maybe_rebase(commit)
        if e.base_version != base:
            raise ValueError(
                f"the engine rebased inside pass {p}: a pass of "
                f"{s.span} versions reaches its rebase threshold, and the "
                f"encoded pool no longer stands")
        graph = e._graph(s.buckets[i])
        with self._range("kvbench.dispatch"):
            t0 = time.perf_counter()
            if graph is None:  # the CPU: the eager step
                row = e._step(batch_views(s.pool_views[i], s.layouts[i][0]))
            else:
                cudaenv.to_device(s.pool_views[i], s.dev, out=graph.buffer)
                row = graph.run()
            host, event = cudaenv.to_host_async(row)
            if self.spans is not None:
                self.spans["dispatch_s"].append(time.perf_counter() - t0)
        self.inflight.append((k, t0, host, event))

    def finish(self):
        k, t0, host, event = self.inflight.popleft()
        with self._range("kvbench.wait"):
            if isinstance(host, conflict.DetectHandle):
                (statuses, err), = conflict.drain_and_collect([host])
                key = ("verdicts", None if err else zlib.crc32(bytes(
                    statuses)))
            else:
                if event is not None:
                    event.synchronize()
                key = (k % self.s.P, zlib.crc32(host.numpy()))
                if key not in self.rows:
                    # on the CPU the row is the eager step's own tensor
                    self.rows[key] = host if event is not None else \
                        host.clone()
        self.keys.append(key)
        self.ks.append(k)
        self.lat.append(time.perf_counter() - t0)

    def verdicts(self, key) -> list[int]:
        """The verdicts of a kept row (key (pool batch, CRC-32)), by the
        port's `DetectHandle.result`."""
        s, i = self.s, key[0]
        return conflict.DetectHandle(
            [[s.txns[i], s.too_old[i], self.rows[key].numpy(), None]],
            host_fallback=s.engine.host_fallback).result()

    def verdict_digests(self) -> list:
        """The CRC-32 of each batch's verdicts, None where the program
        reported an error: a replayed batch's row turned into verdicts
        once for each distinct row."""
        got = {}
        t0 = time.perf_counter()
        for key in self.rows:
            try:
                got[key] = zlib.crc32(bytes(self.verdicts(key)))
            except FDBError as err:
                got[key] = None
                log(f"pool batch {key[0]}: {err}")
        self.decode_s = (time.perf_counter() - t0) / max(len(self.rows), 1)
        return [key[1] if key[0] == "verdicts" else got[key]
                for key in self.keys]

    def drain(self):
        while self.inflight:
            self.finish()

    def run_batches(self, k: int, n: int) -> int:
        for kk in range(k, k + n):
            if len(self.inflight) >= self.s.depth:
                self.finish()
            self.submit(kk)
        self.drain()
        return k + n

    def run_for(self, k: int, seconds: float) -> tuple[int, float]:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            if len(self.inflight) >= self.s.depth:
                self.finish()
            self.submit(k)
            k += 1
        self.drain()
        return k, time.perf_counter() - t0


def profiled_slice(pipe: Pipeline, k: int, n_warm: int, n_active: int,
                   path: Path) -> tuple[int, dict]:
    """`n_warm` batches under the profiler's warm-up, then `n_active`
    batches traced inside the range "kvbench.window", the device idle
    before and after both. Returns the next k and what the step's bytes
    need: the live boundaries (mean of before and after) and the steps."""
    from torch.profiler import ProfilerActivity, profile, schedule
    s = pipe.s
    s.sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))
                 ) as prof:
        k = pipe.run_batches(k, n_warm)
        s.sync()
        prof.step()
        nb0 = s.live_boundaries()
        first = len(pipe.ks)
        pipe.annotate = True
        with torch.profiler.record_function(timeline.WINDOW):
            k = pipe.run_batches(k, n_active)
            s.sync()
        pipe.annotate = False
        nb1 = s.live_boundaries()
        batch_bytes = [s.batch_bytes[kk % s.P] for kk in pipe.ks[first:]]
        prof.step()
    return k, {"steps": n_active, "live_boundaries": (nb0 + nb1) / 2,
               "batch_bytes": float(np.mean(batch_bytes)),
               "row_bytes": 4 * (2 * s.T + 2), "limbs": s.L, "txns": s.T}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def log_tail(pipe: Pipeline, first: int, n: int, gc0: list):
    """Where the window's slowest batches stood: the resolve times'
    percentiles, the share of the slowest 1% that came within `depth`
    batches of a pass's start (its rebase), and the collector's runs."""
    lat = np.asarray(pipe.lat[first:first + n])
    ks = np.asarray(pipe.ks[first:first + n])
    if not len(lat):
        return
    q = np.percentile(lat, [50, 90, 99, 99.9, 100]) * 1e3
    slow = ks[lat >= np.percentile(lat, 99)]
    near = np.mean(slow % pipe.s.P <= pipe.s.depth) if len(slow) else 0.0
    gcs = [g["collections"] - c for g, c in zip(gc.get_stats(), gc0)]
    log(f"resolve ms p50 {q[0]:.4f} p90 {q[1]:.4f} p99 {q[2]:.4f} "
        f"p99.9 {q[3]:.4f} max {q[4]:.4f}; of the slowest 1%, "
        f"{100 * near:.1f}% within {pipe.s.depth} batches of a pass's "
        f"start; collections by generation {gcs}")


@contextlib.contextmanager
def engine_window(versions: int):
    """The engine's MVCC window knob set to the configuration's for the
    run, and put back after."""
    before = KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS
    KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS = versions
    try:
        yield
    finally:
        KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS = before


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             traced: bool, *, device: str = "cuda", overrides=None,
             ablate: str = "", t_start: float | None = None) -> dict:
    """One run of cell `name`: the result object (the contract's keys, the
    compared numbers last under "checks"). `device="cpu"` runs the plain
    phases eagerly (the CPU tests); `ablate` runs the program with one of
    its step's ablations switched on (the control)."""
    c = cell(bench, name, overrides)
    with engine_window(int(c["config"]["engine"]["max_write_life"])):
        return _run(bench, c, name, seed, seconds, traced, device, ablate,
                    time.perf_counter() if t_start is None else t_start)


def _run(bench, c, name, seed, seconds, traced, device, ablate, t_start):
    log(f"{name}, seed {seed}: set-up begins "
        f"{time.perf_counter() - t_start:.3f} s after the process")
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(dev)
    unconverged0 = unconverged_chunks()
    # the set-up makes millions of objects that live to the end: the
    # collector would walk them again and again
    gc.disable()
    try:
        s = Setup(c["config"], c["traffic"], seed, dev, ablate=ablate)
        pipe = Pipeline(s)
        t0 = time.perf_counter()
        k = pipe.run_batches(0, s.P)  # pass 0: the MVCC window fills
        log(f"pass 0 through detect_async in {time.perf_counter() - t0:.3f} "
            f"s; {sum(map(sum, s.too_old))} txns too old")
        s.encode_pool()
        pipe.next_pass()
        s.sync()
        gc.collect()
        gc.freeze()
    finally:
        gc.enable()
    nb, K = s.live_boundaries(), s.engine.shapes.capacity
    log(f"live boundaries {nb} of {K} ({100 * nb / K:.1f}%)")
    setup_s = time.perf_counter() - t_start

    first = len(pipe.ks)
    pipe.spans = {"dispatch_s": []} if traced else None
    gc0 = [g["collections"] for g in gc.get_stats()]
    k, window_s = pipe.run_for(k, seconds)
    window_batches = len(pipe.ks) - first
    log_tail(pipe, first, window_batches, gc0)
    spans = {n: np.asarray(v) for n, v in (pipe.spans or {}).items()}
    pipe.spans = None
    step, tl = None, None
    if traced:
        n_active = int(c["traffic"].get("trace_batches", 500))
        with tempfile.TemporaryDirectory(prefix="kvbench-") as tmp:
            path = Path(tmp) / "trace.json"
            k, step = profiled_slice(pipe, k, max(n_active // 4, 8),
                                     n_active, path)
            if dev.type == "cuda":
                tl = timeline.load(path)
                log(f"trace: {tl.kernels()} kernel launches of "
                    f"{len(tl.kernel_counts())} kernels over "
                    f"{step['steps']} steps, coverage "
                    f"{tl.coverage(step['steps']):.4f}")
    lat = np.asarray(pipe.lat[first:first + window_batches])
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
        "count": 1, "memory_peak_bytes": int(
            torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0}
    digest = pipe.verdict_digests()
    log(f"verdicts: {len(pipe.rows)} distinct rows of {len(pipe.ks) - s.P} "
        f"replayed batches through DetectHandle.result, "
        f"{pipe.decode_s * 1e6:.1f} us a row")
    failed = digest.count(None)
    counts = {"batches": len(pipe.ks), "window_batches": window_batches,
              "passes": k // s.P + (k % s.P > 0), "rebases": pipe.rebases,
              "unconverged": unconverged_chunks() - unconverged0,
              "too_old_txns": sum(map(sum, s.too_old)),
              "distinct_rows": len(pipe.rows),
              "verdicts_us_a_row": pipe.decode_s * 1e6,
              "live_boundaries": nb, "txns_per_batch": s.T}

    # free the program's state, then the reference
    stream, P, T, ks = s.stream, s.P, s.T, pipe.ks
    del s, pipe
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out, loop_from = reference.pass_verdicts(
        stream, min(counts["passes"], MAX_REFERENCE_PASSES), log=log)
    expect = {}
    for n in sorted({kk // P for kk in ks}):
        verdicts = reference.verdicts_of_pass(out, loop_from, n)
        if verdicts is not None:
            expect[n] = reference.digests(verdicts)
    checked = [(kk, d) for kk, d in zip(ks, digest) if kk // P in expect]
    wrong = [kk for kk, d in checked if d != expect[kk // P][kk % P]]
    log(f"reference: {len(out)} passes in {time.perf_counter() - t0:.3f} s "
        f"(loop from pass {loop_from}); {len(checked)} of {len(ks)} "
        f"batches checked, {len(wrong)} wrong; first wrong {wrong[:8]}")

    ctx = {"window": {"txns": window_batches * T, "seconds": window_s,
                      "latencies_s": lat, "batches": window_batches},
           "setup_s": setup_s, "spans": spans, "trace": tl, "step": step,
           "device_kind": kind}
    metrics = {}
    for m in metrics_of(bench, name, traced):
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {"wrong_batches": len(wrong),
              "unchecked_batches": len(ks) - len(checked),
              "failed_batches": failed}
    result = {
        "correct": all(v <= CHECK_LIMITS[n] for n, v in checks.items()),
        "attempted": window_batches * T, "failed": failed * T,
        "metrics": metrics, "device": device_info}
    if tl is not None:
        device_info["busy_s"] = tl.busy_s()
        device_info["window_s"] = tl.window_s()
        result["breakdown"] = tl.breakdown()
    result["counts"] = counts
    result["checks"] = {n: {"value": v, "limit": CHECK_LIMITS[n]}
                        for n, v in checks.items()}
    return result


def check_lines(result: dict) -> list[str]:
    """Each compared number beside its limit, one line each."""
    return [f"check {n}: {c['value']} (limit {c['limit']})"
            for n, c in result["checks"].items()]


def json_line(result: dict) -> str:
    """The result as its JSON line (NaN refused: JSON has no NaN)."""
    for m in result["metrics"].values():
        if not math.isfinite(m["value"]):
            raise ValueError(f"metric value {m['value']} is not finite")
    return json.dumps(result)
