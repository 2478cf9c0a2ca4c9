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
with the step's kernels and syncs once at the end. The run fails if the
state ever overflowed.

The yardstick is measured at bench time: a C implementation of the
SkipList algorithm (native/skiplist_baseline.c) is compiled with the host's
`cc` and run on the same workload shape. Without a compiler its entry is
{"error": ...}: the yardstick is missing, nothing else changes.

`run_sharded_kernel` (bench.py:295-400) times the sharded engine's step
(parallel/sharded_conflict.py) the same way, a batch a dispatch, on keys
spread over the first limb so that every shard gets traffic. On one card
its W shards share the card: W = 4 is then about four steps a batch, which
measures the cost of sharding, not its scaling.

There is no CPU fallback: `run_kernel`, `run_kernel_ab` and
`run_sharded_kernel` run on CUDA unless the caller passes device="cpu" (or
CPU devices; the tests do, at small sizes), and raise platform_error where
there is no card.

Usage, from the repository root on a machine with the card:

  python -m foundationdb_tpu_torch.bench --kernel T n_batches chunk [capacity]
  python -m foundationdb_tpu_torch.bench --ab T [n_batches] [capacity]
  python -m foundationdb_tpu_torch.bench --sharded-kernel T n_batches W [capacity]

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
from foundationdb_tpu_torch.parallel.sharded_conflict import (
    init_sharded_state, make_resolver_mesh, sharded_conflict_step)
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


def timed_scan(state: dict, warm: dict, chunks: list[dict], *,
               phases=kernels.PHASES) -> dict:
    """The timed core of `run_kernel`: one warm-up `conflict_scan` over the
    `warm` chunk (fills the window with history), then the clock runs over
    one `conflict_scan` per staged chunk, with one host sync at the end.
    Returns the seconds, the per-batch committed counts and overflow flags
    (numpy), the statuses of the warm chunk and of every timed chunk (on
    the device), and the states after the warm-up and at the end."""
    dev = state["bval"].device
    life = KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS
    state, warm_st, _comm, warm_ovf = ref.conflict_scan(
        state, warm, max_write_life=life, strided=True, phases=phases)
    _sync(dev)
    after_warm = state
    t0 = time.perf_counter()
    statuses, comms, ovfs = [], [], []
    for ch in chunks:
        state, st, comm, ovf = ref.conflict_scan(
            state, ch, max_write_life=life, strided=True, phases=phases)
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
        "baseline_txns_per_sec": baseline,
        "baseline_cpu_measured": cpu,
    }


def run_kernel_ab(T: int, n_batches: int = 8, capacity: int | None = None,
                  device=None) -> dict:
    """The intra-batch evaluators side by side at one batch size: "scan"
    (per-level prefix scans, bounded sweeps) against "legacy" (every
    write/read pair, a fixpoint read on the host), over the same staged
    batches and state trajectory. Reports ms/step of each (the first step,
    which fills the window, is not timed) and whether the two gave equal
    statuses on every batch."""
    dev = cudaenv.resolve_device("cuda" if device is None else device)
    if n_batches < 2:
        raise ValueError("run_kernel_ab times n_batches - 1 steps: give >= 2")
    K = capacity or CAPACITY
    batches = stage(_encode_batches(n_batches, seed=3, version0=WINDOW, T=T),
                    dev)
    staged = [{k: v[i] for k, v in batches.items()} for i in range(n_batches)]
    out = {"txns_per_batch": T, "batches": n_batches, "device": str(dev)}
    statuses = {}
    for mode in ref.INTRA_MODES:
        state = ref.init_state(K, LIMBS, dev, phases=kernels.PHASES)
        sts = []
        for i, b in enumerate(staged):
            if i == 1:
                _sync(dev)
                t0 = time.perf_counter()
            state, st, _info = ref.conflict_step(
                state, b, max_write_life=KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
                intra_mode=mode, strided=True, phases=kernels.PHASES)
            sts.append(st)
        _sync(dev)
        out[mode + "_ms_per_step"] = (1e3 * (time.perf_counter() - t0)
                                      / max(1, n_batches - 1))
        statuses[mode] = torch.stack(sts)
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


def run_sharded_kernel(T: int, n_batches: int, n_shards: int,
                       capacity: int | None = None, devices=None,
                       detail: dict | None = None) -> dict:
    """The sharded step over `n_shards` shards (`devices`, one a shard; by
    default cards 0..n_shards-1, which raises invalid_option past the
    attached cards): a warm-up batch, then `n_batches` timed batches, a
    batch a dispatch, full sandwich rounds (T // 2 + 1, as the engine), one
    host sync at the end. Raises internal_error if a shard overflowed.
    `detail`, if given, receives the staged batches, the statuses of every
    timed batch and the states after the warm-up, after the first timed
    batch and at the end."""
    devices = ([cudaenv.resolve_device(d) for d in devices] if devices
               else make_resolver_mesh(n_shards, "cuda"))
    if len(devices) != n_shards:
        raise ValueError(f"{len(devices)} devices for {n_shards} shards")
    K = capacity or CAPACITY
    shapes = ConflictShapes(capacity=K, txns=T, reads=T, writes=T,
                            key_bytes=keylib.KEY_BYTES, strided=True)
    step = sharded_conflict_step(
        devices, shapes, KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS, "scan",
        T // 2 + 1)
    dev = devices[0]
    warm = {k: v[0] for k, v in stage(
        _encode_spread_batches(1, seed=1, version0=WINDOW, T=T), dev).items()}
    main = stage(_encode_spread_batches(
        n_batches, seed=2, version0=WINDOW + VERSION_STEP, T=T), dev)
    staged = [{k: v[i] for k, v in main.items()} for i in range(n_batches)]
    state = init_sharded_state(shapes, devices)
    state, _st, warm_info = step(state, warm)  # the first window fill
    for d in dict.fromkeys(devices):
        _sync(d)
    after_warm, after_first = state, None
    t0 = time.perf_counter()
    statuses, comms, ovfs = [], [], []
    for i, b in enumerate(staged):
        state, st, info = step(state, b)
        if i == 0:
            after_first = state
        statuses.append(st)
        comms.append(info["committed"])
        ovfs.append(info["overflow"])
    committed = torch.stack(comms).cpu().numpy()  # the one sync
    seconds = time.perf_counter() - t0
    if bool(warm_info["overflow"]) or bool(torch.stack(ovfs).any()):
        raise FDBError("internal_error",
                       "conflict state overflowed; the capacity is too small")
    if detail is not None:
        detail.update(batches=staged, warm=warm, statuses=statuses,
                      state_after_warm=after_warm,
                      state_after_first=after_first, state=state)
    total = n_batches * T
    return {
        "n_shards": n_shards,
        "value": total / seconds,
        "ms_per_batch": 1e3 * seconds / n_batches,
        "committed_frac": int(committed.sum()) / total,
        "txns_per_batch": T, "batches": n_batches, "capacity": K,
        "devices": [str(d) for d in devices],
    }


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
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
    print(__doc__.split("Usage")[1].strip(), file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
