"""The port's kernel bench: resolver conflict detection on the card.

Counterpart of the kernel bench of the repository's bench.py (the
constants, `_encode_batches`, `measure_cpu_baseline`, `run_kernel` and
`run_kernel_ab`, bench.py:42-135, 171-292). It runs the reference's
skipListTest shape (fdbserver/SkipList.cpp:1412-1502): batches of
transactions with one read range and one write range each over a
20M-key space (span 1-10), 16-byte keys ('.' x 12 then a 4-byte big-endian
integer), the strided layout, a 2^18-slot state and a history window of
about 8 batches. All batches are encoded and staged on the card before the
clock starts; the timed region runs `conflict_scan` over chunks of batches
with the step's kernels and syncs once at the end. On the card each chunk
is one replay of the scan's CUDA graph (ops/step_graph.py, the
`_compiled_scan` counterpart), captured during the warm-up chunk, outside
the clock, as JAX compiles there; the state stays in fixed buffers. The
run fails if the state ever overflowed.

`run_ablate` is the counterpart of scripts/profile_kernel.py: the full scan
and the JAX step's six ablations (`ablate`), each through its own graph
from the same warmed state, in ms/step.

The yardstick is measured at bench time: a C implementation of the
SkipList algorithm (native/skiplist_baseline.c) is compiled with the host's
`cc` and run on the same workload shape. Without a compiler its entry is
{"error": ...}: the yardstick is missing, nothing else changes.

`run_sharded_kernel` (bench.py:295-400) times the sharded engine's step
(parallel/sharded_conflict.py) the same way, a batch a dispatch, on keys
spread over the first limb so that every shard gets traffic: each batch is
one replay of the sharded chunk's CUDA graph (`ShardedStepGraph`: K10, the
W shard steps, K11) from a packed batch buffer, or the same chunk run
eagerly (`graphed=False`). On one card its W shards share the card: W = 4
is then about four steps a batch, which measures the cost of sharding, not
its scaling.

`run_e2e` and `main` are the counterparts of bench.py:138-168 and
510-540: with no flag, the bench runs the end-to-end driver first
(bench_e2e.py, one subprocess for each of the oracle and device backends,
before this process touches the card; FDB_TPU_BENCH_E2E=0 skips it), then
the kernel bench at T=16,384 and T=32,768, and prints one JSON line; it
exits 1 if either backend's e2e entry holds an error.

There is no CPU fallback: `run_kernel`, `run_kernel_ab`,
`run_sharded_kernel` and `run_e2e` run on CUDA unless the caller passes
device="cpu" (or CPU devices; the tests do, at small sizes), and raise
platform_error (or, for `run_e2e`, report the device run's error) where
there is no card. So bench.py's `probe_accelerator` and
`run_kernel_watchdogged`, which exist only to choose a CPU fallback, have
no counterpart here; `run_devices_sweep` waits for four cards.

Usage, from the repository root on a machine with the card:

  python -m foundationdb_tpu_torch.bench
  python -m foundationdb_tpu_torch.bench --kernel T n_batches chunk [capacity]
  python -m foundationdb_tpu_torch.bench --ab T [n_batches] [capacity]
  python -m foundationdb_tpu_torch.bench --sharded-kernel T n_batches W [capacity]
  python -m foundationdb_tpu_torch.bench --ablate T n_batches [capacity]

Each prints one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops import kernels
from foundationdb_tpu_torch.ops.conflict import ConflictShapes
from foundationdb_tpu_torch.ops.step_graph import (ScanGraph, batch_layout,
                                                   batch_views)
from foundationdb_tpu_torch.parallel.sharded_conflict import (
    ShardedStepGraph, clone_sharded_state, graph_fits, init_sharded_state,
    make_resolver_mesh)
from foundationdb_tpu_torch.utils import cudaenv
from foundationdb_tpu_torch.utils import keys as keylib
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS

BASELINE_FLOOR_TXNS_PER_SEC = 1.0e6
TXNS_PER_BATCH = 16384
N_BATCHES = 200
CHUNK = 100  # batches per conflict_scan call
KEYSPACE = 20_000_000  # reference: randomInt(0, 20000000)
MAX_SPAN = 10  # reference: key + 1 + randomInt(0, 10)
CAPACITY = 1 << 18
KEY_BYTES = 16  # reference setK keys (SkipList.cpp:913)
LIMBS = KEY_BYTES // 4 + 1
WINDOW = 5_000_000  # MAX_WRITE_TRANSACTION_LIFE_VERSIONS (Knobs.cpp:30-34)
VERSION_STEP = WINDOW // 8  # ~8 batches of history in the window
DOT = 0x2E2E2E2E  # '....'

_BASELINE_SRC = Path(__file__).resolve().parent / "native" / "skiplist_baseline.c"


def measure_cpu_baseline(txns_per_batch: int) -> dict:
    """Compile and run the C SkipList baseline on this host (same workload
    shape and batch size, ~125k-txn history window). Returns its JSON line
    ({"txns_per_sec": ...}) or {"error": str}. The executable is built in
    the package's build directory and removed after the run."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = kernels.BUILD_DIR / f"skiplist_baseline_{os.getpid()}"
    try:
        proc = subprocess.run(
            [os.environ.get("CC", "cc"), "-O3", "-march=native", "-o",
             str(exe), str(_BASELINE_SRC)],
            capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            return {"error": proc.stderr[-500:]}
        n_batches = max(10, 1_250_000 // txns_per_batch)
        proc = subprocess.run([str(exe), str(txns_per_batch), str(n_batches)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            return {"error": proc.stderr[-500:]}
        return json.loads(proc.stdout.strip())
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        return {"error": f"{type(e).__name__}: {e}"}
    finally:
        exe.unlink(missing_ok=True)


def _encode_batches(n_batches: int, seed: int, version0: int,
                    T: int = TXNS_PER_BATCH) -> dict:
    """`n_batches` stacked strided batches (numpy, leading batch axis) of T
    txns, with the same random draws as bench.py's `_encode_batches` and the
    reference's setK keys (SkipList.cpp:909-922); key limbs are the port's
    signed limbs (utils/keys.py)."""
    rng = np.random.RandomState(seed)

    def keys_to_limbs(v):  # v: (n, T) ints in [0, KEYSPACE + MAX_SPAN]
        out = np.zeros((v.shape[0], LIMBS, T), dtype=np.uint32)
        out[:, :3, :] = DOT
        out[:, 3, :] = v.astype(np.uint32)  # big-endian int, bytes 12..16
        out[:, LIMBS - 1, :] = KEY_BYTES  # every setK key is 16 bytes
        return keylib.to_signed_limbs(out)

    n = n_batches
    rlo = rng.randint(0, KEYSPACE, size=(n, T)).astype(np.int64)
    rspan = 1 + rng.randint(0, MAX_SPAN, size=(n, T)).astype(np.int64)
    wlo = rng.randint(0, KEYSPACE, size=(n, T)).astype(np.int64)
    wspan = 1 + rng.randint(0, MAX_SPAN, size=(n, T)).astype(np.int64)
    versions = version0 + VERSION_STEP * np.arange(1, n + 1, dtype=np.int64)
    # max staleness, as the reference's (read_snapshot i, detect at i+50):
    # every committed write in the window conflicts
    snapshots = (versions - WINDOW).astype(np.int32)
    owners = np.broadcast_to(np.arange(T, dtype=np.int32), (n, T)).copy()
    return {
        "rb": keys_to_limbs(rlo),
        "re": keys_to_limbs(rlo + rspan),
        "wb": keys_to_limbs(wlo),
        "we": keys_to_limbs(wlo + wspan),
        "rtxn": owners,
        "wtxn": owners.copy(),
        "snapshot": np.broadcast_to(snapshots[:, None], (n, T)).copy(),
        "txn_valid": np.ones((n, T), dtype=bool),
        "commit_version": versions.astype(np.int32),
        "advance_floor": np.ones(n, dtype=bool),
    }


def stage(batches: dict, device: torch.device) -> dict:
    """Stacked numpy batches -> tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batches.items()}


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _scan_program(state: dict, steps: int, T: int, graphed: bool, phases,
                  ablate: str = "", intra_mode: str = "scan") -> ScanGraph:
    return ScanGraph(state, steps=steps, txns=T, reads=T, writes=T,
                     max_write_life=KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
                     strided=True, ablate=ablate, intra_mode=intra_mode,
                     phases=phases, graphed=graphed)


def timed_scan(state: dict, warm: dict, chunks: list[dict], *,
               phases=kernels.PHASES, graphed: bool | None = None) -> dict:
    """The timed core of `run_kernel`: one warm-up `conflict_scan` over the
    `warm` chunk (fills the window with history), then the clock runs over
    one `conflict_scan` per staged chunk, with one host sync at the end.
    `state` is the fixed state buffers, overwritten in place. On the card
    (`graphed` None or True) each chunk is one replay of a scan graph of
    its length, every graph captured before the clock; `graphed=False`
    runs the same scans eagerly. Returns the seconds, the per-batch
    committed counts and overflow flags (numpy), the statuses of the warm
    chunk and of every timed chunk (on the device), and the states after
    the warm-up (a copy) and at the end."""
    dev = state["bval"].device
    graphed = dev.type == "cuda" if graphed is None else graphed
    T = warm["snapshot"].shape[1]
    programs = {}
    for ch in [warm, *chunks]:
        M = ch["snapshot"].shape[0]
        if M not in programs:
            programs[M] = _scan_program(state, M, T, graphed, phases)
            programs[M].capture()

    def scan(ch):
        st, comm, ovf = programs[ch["snapshot"].shape[0]].run(ch)
        return st.clone(), comm.clone(), ovf.clone()

    warm_st, _comm, warm_ovf = scan(warm)
    _sync(dev)
    after_warm = {k: v.clone() for k, v in state.items()}
    t0 = time.perf_counter()
    statuses, comms, ovfs = [], [], []
    for ch in chunks:
        st, comm, ovf = scan(ch)
        statuses.append(st)
        comms.append(comm)
        ovfs.append(ovf)
    committed = torch.cat(comms).cpu().numpy()  # the one sync
    seconds = time.perf_counter() - t0
    return {"seconds": seconds, "committed": committed,
            "overflow": torch.cat(ovfs).cpu().numpy(),
            "warm_overflow": warm_ovf.cpu().numpy(),
            "warm_statuses": warm_st, "statuses": statuses,
            "state_after_warm": after_warm, "state": state}


def run_kernel(T: int, n_batches: int, chunk: int,
               capacity: int | None = None, device=None,
               detail: dict | None = None) -> dict:
    """One timed kernel-bench measurement at T txns a batch: `n_batches`
    timed batches in chunks of `chunk`, after a warm-up chunk. Raises
    internal_error if the state overflowed. `detail`, if given, receives
    the inputs and `timed_scan`'s outputs."""
    dev = cudaenv.resolve_device("cuda" if device is None else device)
    K = capacity or CAPACITY
    warm_np = _encode_batches(chunk, seed=1, version0=WINDOW, T=T)
    main_np = _encode_batches(n_batches, seed=2,
                              version0=WINDOW + chunk * VERSION_STEP, T=T)
    warm = stage(warm_np, dev)
    chunks = [stage({k: v[c:c + chunk] for k, v in main_np.items()}, dev)
              for c in range(0, n_batches, chunk)]
    state = ref.init_state(K, LIMBS, dev, phases=kernels.PHASES)
    res = timed_scan(state, warm, chunks)
    if res["warm_overflow"].any() or res["overflow"].any():
        raise FDBError("internal_error",
                       "conflict state overflowed; the capacity is too small")
    total = n_batches * T
    txns_per_sec = total / res["seconds"]
    cpu = measure_cpu_baseline(T)
    cpu_measured = cpu.get("txns_per_sec", 0.0)
    baseline = max(cpu_measured, BASELINE_FLOOR_TXNS_PER_SEC)
    if detail is not None:
        detail.update(res, warm_np=warm_np, warm=warm, chunks=chunks)
    return {
        "value": txns_per_sec,
        "ms_per_step": 1e3 * res["seconds"] / n_batches,
        "vs_baseline": txns_per_sec / baseline,
        "vs_cpu_measured": (txns_per_sec / cpu_measured
                            if cpu_measured > 0 else None),
        "vs_floor_1e6": txns_per_sec / BASELINE_FLOOR_TXNS_PER_SEC,
        "baseline_source": ("cpu_measured"
                            if cpu_measured >= BASELINE_FLOOR_TXNS_PER_SEC
                            else "floor_1e6"),
        "committed_frac": int(res["committed"].sum()) / total,
        "batches": n_batches, "chunk": chunk, "txns_per_batch": T,
        "capacity": K, "device": str(dev),
        "graphed": dev.type == "cuda",
        "baseline_txns_per_sec": baseline,
        "baseline_cpu_measured": cpu,
    }


def run_kernel_ab(T: int, n_batches: int = 8, capacity: int | None = None,
                  device=None) -> dict:
    """The intra-batch evaluators side by side at one batch size: "scan"
    (per-level prefix scans, bounded sweeps) against "legacy" (every
    write/read pair, the fixpoint in one K5 launch), over the same staged
    batches and state trajectory, each step one replay of its evaluator's
    one-step scan graph on the card. Reports ms/step of each (the first
    step, which fills the window, is not timed) and whether the two gave
    equal statuses on every batch."""
    dev = cudaenv.resolve_device("cuda" if device is None else device)
    if n_batches < 2:
        raise ValueError("run_kernel_ab times n_batches - 1 steps: give >= 2")
    K = capacity or CAPACITY
    batches = stage(_encode_batches(n_batches, seed=3, version0=WINDOW, T=T),
                    dev)
    staged = [{k: v[i] for k, v in batches.items()} for i in range(n_batches)]
    out = {"txns_per_batch": T, "batches": n_batches, "device": str(dev)}
    statuses, graphs = {}, []
    for mode in ref.INTRA_MODES:
        state = ref.init_state(K, LIMBS, dev, phases=kernels.PHASES)
        # one step a dispatch: a one-step scan graph on the card
        prog = _scan_program(state, 1, T, dev.type == "cuda", kernels.PHASES,
                             intra_mode=mode)
        prog.capture()
        graphs.append(prog.graph is not None)

        def step(b):  # the graph's output: copied before the next
            return prog.run({k: v[None] for k, v in b.items()})[0][0].clone()
        sts = []
        for i, b in enumerate(staged):
            if i == 1:
                _sync(dev)
                t0 = time.perf_counter()
            sts.append(step(b).to(torch.int8))
        _sync(dev)
        out[mode + "_ms_per_step"] = (1e3 * (time.perf_counter() - t0)
                                      / max(1, n_batches - 1))
        statuses[mode] = torch.stack(sts)
    out["graphed"] = all(graphs)  # both evaluators' programs captured
    out["step_time_reduction"] = (out["legacy_ms_per_step"]
                                  / out["scan_ms_per_step"])
    out["statuses_equal"] = bool(torch.equal(statuses["scan"],
                                             statuses["legacy"]))
    return out


def _encode_spread_batches(n_batches: int, seed: int, version0: int,
                           T: int) -> dict:
    """Batches for the sharded engine (bench.py's `_encode_spread_batches`,
    the same random draws): `_encode_batches`' workload (one read and one
    write range a txn, span 1-10, the same snapshots) with the key integer
    scaled into the FIRST limb, since the engine partitions on the leading
    4 key bytes (the setK prefix would land every key on shard 0). Keys
    are 24 bytes wide, the only width the sharded step takes; limbs are
    the port's signed limbs."""
    L = keylib.NUM_LIMBS
    # multiplying keeps the order and spreads [0, KEYSPACE + MAX_SPAN]
    # across the first limb
    scale = (1 << 32) // (KEYSPACE + MAX_SPAN + 1)
    rng = np.random.RandomState(seed)

    def keys_to_limbs(v):  # v: (n, T) int64 in [0, KEYSPACE + MAX_SPAN]
        out = np.zeros((v.shape[0], L, T), dtype=np.uint32)
        out[:, 0, :] = (v * scale).astype(np.uint32)
        out[:, 1:L - 1, :] = DOT
        out[:, L - 1, :] = keylib.KEY_BYTES
        return keylib.to_signed_limbs(out)

    n = n_batches
    rlo = rng.randint(0, KEYSPACE, size=(n, T)).astype(np.int64)
    rspan = 1 + rng.randint(0, MAX_SPAN, size=(n, T)).astype(np.int64)
    wlo = rng.randint(0, KEYSPACE, size=(n, T)).astype(np.int64)
    wspan = 1 + rng.randint(0, MAX_SPAN, size=(n, T)).astype(np.int64)
    versions = version0 + VERSION_STEP * np.arange(1, n + 1, dtype=np.int64)
    snapshots = (versions - WINDOW).astype(np.int32)
    owners = np.broadcast_to(np.arange(T, dtype=np.int32), (n, T)).copy()
    return {
        "rb": keys_to_limbs(rlo),
        "re": keys_to_limbs(rlo + rspan),
        "wb": keys_to_limbs(wlo),
        "we": keys_to_limbs(wlo + wspan),
        "rtxn": owners,
        "wtxn": owners.copy(),
        "snapshot": np.broadcast_to(snapshots[:, None], (n, T)).copy(),
        "txn_valid": np.ones((n, T), dtype=bool),
        "commit_version": versions.astype(np.int32),
        "advance_floor": np.ones(n, dtype=bool),
    }


def pack_batches(stacked: dict, L: int, T: int, NR: int, NW: int
                 ) -> np.ndarray:
    """Stacked numpy batches (leading axis n) -> (n, size) int32 packed
    batch buffers (`step_graph.batch_layout`)."""
    layout, size = batch_layout(L, T, NR, NW)
    n = stacked["snapshot"].shape[0]
    out = np.zeros((n, size), dtype=np.int32)
    for i in range(n):
        views = batch_views(out[i], layout)
        for k, v in views.items():
            v[...] = stacked[k][i]
    return out


def run_sharded_kernel(T: int, n_batches: int, n_shards: int,
                       capacity: int | None = None, devices=None,
                       graphed: bool | None = None,
                       detail: dict | None = None) -> dict:
    """The sharded step over `n_shards` shards (`devices`, one a shard; by
    default cards 0..n_shards-1, which raises invalid_option past the
    attached cards): a warm-up batch, then `n_batches` timed batches, a
    batch a dispatch, full sandwich rounds (T // 2 + 1, as the engine), one
    host sync at the end. Each batch is staged on the first device as a
    packed buffer and copied into the `ShardedStepGraph`'s own. `graphed`
    (default: where the engine would, `graph_fits`) makes each dispatch
    one replay, the graph captured before the warm-up batch, outside the
    clock; `graphed=False` runs it eagerly (the yardstick). Raises
    internal_error if a shard overflowed. `detail`, if given, receives the
    staged batches (views of the packed buffers), the statuses of every
    timed batch and the states after the warm-up, after the first timed
    batch and at the end."""
    devices = ([cudaenv.resolve_device(d) for d in devices] if devices
               else make_resolver_mesh(n_shards, "cuda"))
    if len(devices) != n_shards:
        raise ValueError(f"{len(devices)} devices for {n_shards} shards")
    K = capacity or CAPACITY
    shapes = ConflictShapes(capacity=K, txns=T, reads=T, writes=T,
                            key_bytes=keylib.KEY_BYTES, strided=True)
    dev = devices[0]
    if graphed is None:
        graphed = graph_fits(devices, kernels.PHASES)
    L = shapes.limbs
    layout, _size = batch_layout(L, T, T, T)
    warm = torch.from_numpy(pack_batches(_encode_spread_batches(
        1, seed=1, version0=WINDOW, T=T), L, T, T, T)).to(dev)[0]
    main = torch.from_numpy(pack_batches(_encode_spread_batches(
        n_batches, seed=2, version0=WINDOW + VERSION_STEP, T=T), L, T, T,
        T)).to(dev)
    state = init_sharded_state(shapes, devices)
    prog = ShardedStepGraph(
        state, txns=T, reads=T, writes=T,
        max_write_life=KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
        intra_rounds=T // 2 + 1, strided=True, graphed=graphed)
    prog.capture()
    prog.buffer.copy_(warm)
    _row, warm_info = prog.run()  # the first window fill
    warm_overflow = bool(warm_info["overflow"])
    for d in dict.fromkeys(devices):
        _sync(d)
    after_warm = clone_sharded_state(state) if detail is not None else None
    after_first = None
    rows = torch.empty((n_batches, 2 * T + 2), dtype=torch.int32, device=dev)
    comms = torch.empty(n_batches, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    for i in range(n_batches):
        prog.buffer.copy_(main[i])
        row, info = prog.run()
        rows[i].copy_(row)
        comms[i].copy_(info["committed"])
        if i == 0 and detail is not None:
            after_first = clone_sharded_state(state)
    committed = comms.cpu().numpy()  # the one sync
    seconds = time.perf_counter() - t0
    if warm_overflow or bool(rows[:, 2 * T].any()):
        raise FDBError("internal_error",
                       "conflict state overflowed; the capacity is too small")
    if detail is not None:
        detail.update(batches=[batch_views(main[i], layout)
                               for i in range(n_batches)],
                      warm=batch_views(warm, layout),
                      statuses=[rows[i, :T] for i in range(n_batches)],
                      state_after_warm=after_warm,
                      state_after_first=after_first, state=state)
    total = n_batches * T
    return {
        "n_shards": n_shards,
        "value": total / seconds,
        "ms_per_batch": 1e3 * seconds / n_batches,
        "committed_frac": int(committed.sum()) / total,
        "txns_per_batch": T, "batches": n_batches, "capacity": K,
        "graphed": prog.graph is not None,
        "devices": [str(d) for d in devices],
    }


def run_ablate(T: int, n_batches: int, capacity: int | None = None,
               device=None, detail: dict | None = None) -> dict:
    """The ablation profile (scripts/profile_kernel.py): a warm-up chunk
    of 8 batches fills the window, then the full scan and each of the JAX
    step's six ablations runs over the same `n_batches` staged batches,
    each through its own scan graph from a copy of the warmed state (the
    JAX script's state is not donated): a warm-up run, then the least of 3
    timed runs, each ending in one sync. Returns ms/step a mode. `detail`,
    if given, receives the batches, the warmed state and, a mode, the
    statuses and state of its first run."""
    dev = cudaenv.resolve_device("cuda" if device is None else device)
    K = capacity or CAPACITY
    warm = stage(_encode_batches(8, seed=1, version0=WINDOW, T=T), dev)
    main_b = stage(_encode_batches(n_batches, seed=2,
                                   version0=WINDOW + 8 * VERSION_STEP, T=T),
                   dev)
    state = ref.init_state(K, LIMBS, dev, phases=kernels.PHASES)
    _scan_program(state, 8, T, dev.type == "cuda", kernels.PHASES).run(warm)
    warmed = {k: v.clone() for k, v in state.items()}
    out = {"txns_per_batch": T, "batches": n_batches, "capacity": K,
           "device": str(dev), "ms_per_step": {}}
    if detail is not None:
        detail.update(batches=main_b, warmed=warmed, runs={})
    for mode in ref.ABLATE_MODES:
        prog = _scan_program(state, n_batches, T, dev.type == "cuda",
                             kernels.PHASES, ablate=mode)
        times = []
        for rep in range(4):
            ref.write_state(state, warmed)
            _sync(dev)
            t0 = time.perf_counter()
            st, comm, ovf = prog.run(main_b)
            _sync(dev)
            times.append(time.perf_counter() - t0)
            if rep == 0 and detail is not None:
                detail["runs"][mode] = {
                    "statuses": st.clone(), "committed": comm.clone(),
                    "overflow": ovf.clone(),
                    "state": {k: v.clone() for k, v in state.items()}}
        out["ms_per_step"][mode or "full"] = 1e3 * min(times[1:]) / n_batches
    return out


def run_e2e(device: str = "cuda") -> dict:
    """The end-to-end driver for BOTH conflict backends, one SUBPROCESS
    each (`python -m foundationdb_tpu_torch.bench_e2e <backend>`), so that
    a failed device run cannot take the oracle numbers down with it; run
    before this process touches the card. The device run's engine is on
    `device`. Returns {"oracle": {...}, "device": {...}}, a backend's entry
    {"error": ...} where its run failed or took over 1,500 s (the
    reference's limit)."""
    root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=root)
    out = {}
    for backend in ("oracle", "device"):
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "foundationdb_tpu_torch.bench_e2e",
                 backend, f"--device={device}"],
                capture_output=True, text=True, timeout=1500, env=env,
                cwd=root)
            if proc.returncode != 0:
                out[backend] = {"error": proc.stderr[-600:]}
            else:
                out[backend] = json.loads(proc.stdout)
        except Exception as e:  # noqa: BLE001
            out[backend] = {"error": f"{type(e).__name__}: {e}"}
    return out


def run_main() -> dict:
    """bench.py's `main` on the card: the e2e driver first (in
    subprocesses; FDB_TPU_BENCH_E2E=0 skips it), then the kernel bench at
    T=16,384 and at T=32,768 (K=2^19: the ~450k boundaries of its history
    overflow 2^18)."""
    e2e = None
    if os.environ.get("FDB_TPU_BENCH_E2E", "1") != "0":
        e2e = run_e2e()
    r16 = run_kernel(TXNS_PER_BATCH, N_BATCHES, CHUNK)
    r32 = run_kernel(32768, 100, 50, capacity=1 << 19)
    out = {"metric": "resolver_conflict_txns_per_sec", "unit": "txns/s",
           **r16, "batch_32768": r32}
    if e2e is not None:
        out["e2e"] = e2e
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not args:
        out = run_main()
        print(json.dumps(out))
        failed = [b for b, r in (out.get("e2e") or {}).items() if "error" in r]
        if failed:
            print(f"e2e run failed: {', '.join(failed)}", file=sys.stderr)
            return 1
        return 0
    if len(args) >= 4 and args[0] == "--kernel":
        cap = int(args[4]) if len(args) > 4 else None
        print(json.dumps(run_kernel(int(args[1]), int(args[2]), int(args[3]),
                                    capacity=cap)))
        return 0
    if len(args) >= 2 and args[0] == "--ab":
        nb = int(args[2]) if len(args) > 2 else 8
        cap = int(args[3]) if len(args) > 3 else None
        print(json.dumps(run_kernel_ab(int(args[1]), n_batches=nb,
                                       capacity=cap)))
        return 0
    if len(args) >= 4 and args[0] == "--sharded-kernel":
        cap = int(args[4]) if len(args) > 4 else None
        print(json.dumps(run_sharded_kernel(int(args[1]), int(args[2]),
                                            int(args[3]), capacity=cap)))
        return 0
    if len(args) >= 3 and args[0] == "--ablate":
        cap = int(args[3]) if len(args) > 3 else None
        print(json.dumps(run_ablate(int(args[1]), int(args[2]),
                                    capacity=cap)))
        return 0
    print(__doc__.split("Usage")[1].strip(), file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
