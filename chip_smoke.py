#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (foundationdb_tpu_torch) once on one NVIDIA GPU.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
Phases, each of which must pass:

  1. the card (nvidia-smi name and power limit, torch and CUDA versions);
  2. the nvcc build of the four conflict-step kernels, with its seconds;
  3. each kernel against its plain PyTorch version on the card, on inputs
     captured from the main path at its full width (K=65,536, T=1,024,
     4/4, L=7) and on edge inputs, with EXACT equality (integer kernels),
     timed beside its plain version, its bound and a library yardstick;
     then the whole step with the kernels against the plain step, state
     for state, over a small trajectory that overflows and rebases;
  4. the resolver role: the port's Resolver (CONFLICT_BACKEND=device,
     CONFLICT_DEVICE=cuda) in the port's EventLoop/SimNetwork answers
     chained ResolveTransactionBatchRequests from a proxy-like driver actor,
     phase A at the default knobs (K=65,536; 40 batches of 1,024 txns, 4
     point reads + 4 point writes each, zipfian 0.99 over 20,000 keys) and
     phase B at K=2^20 (a load of 48 batches of blind inserts, then 60
     batches over 400,000 keys). Every reply must equal the port's
     OracleConflictSet on the same batches, no state may poison, every
     served chunk must converge on the device (so the sweep kernel, not
     the host pass, decided its statuses), and each kernel must have
     launched during the phase (launch counts are zeroed just before each
     phase and read just after). Then each kernel is held to its plain
     version again on one more step from phase B's final state (K=2^20).

It prints a digest of the code it runs, the kernels line
({"kernels": [...]}), the nvidia-smi line, and last {"ok": true, "device":
{...}}. Any failure exits non-zero with no result line. Details go to
chiprun_out/chip_smoke.json. The script imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_SCALAR_OPS_PER_S = 67e12  # float32 outside the tensor cores (data sheet)
PHASE_A_BATCHES = 40
PHASE_B_BATCHES = 60
PHASE_B_LOAD_BATCHES = 48


def source_digest() -> str:
    """sha256 over the path and bytes of chip_smoke.py and of every .py,
    .cu and .cuh file of the port package, in path order: it names the
    code a run executed, so a recorded number can be tied to a commit."""
    import hashlib
    root = os.path.dirname(os.path.abspath(__file__))
    paths = ["chip_smoke.py"]
    pkg = os.path.join(root, "foundationdb_tpu_torch")
    for d, dirs, files in os.walk(pkg):
        dirs[:] = [x for x in dirs if not x.startswith(("_", "."))]
        paths += [os.path.relpath(os.path.join(d, f), root) for f in files
                  if f.endswith((".py", ".cu", ".cuh"))]
    h = hashlib.sha256()
    for rel in sorted(paths):
        h.update(rel.encode() + b"\0")
        with open(os.path.join(root, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def log(msg: str):
    print(msg, flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# traffic: YCSB-style zipfian point reads and writes
# ---------------------------------------------------------------------------

def zipf_keys(n_keys: int):
    """(cdf, keys): a zipfian (theta 0.99, the YCSB default) distribution
    over n_keys keys of 16 to 24 bytes, hashed so hot keys scatter."""
    w = 1.0 / np.arange(1, n_keys + 1, dtype=np.float64) ** 0.99
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    h = np.arange(n_keys, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    keys = []
    for i, x in enumerate(h.tolist()):
        k = b"%016x" % x
        keys.append(k if i % 3 == 0 else b"user" + k + b"#" * (i % 5))
    return cdf, keys


def make_batches(rng, cdf, keys, n_batches, txns=1024, step=10_000, prev=0):
    """[(prev_version, version, [TxnConflictInfo])] chained from `prev`:
    each txn reads and writes 4 zipfian point keys; snapshots trail by 0-3
    batches."""
    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
    out = []
    for _ in range(n_batches):
        version = prev + step
        idx = np.searchsorted(cdf, rng.random((txns, 8)))
        lag = rng.integers(0, 4, txns) * step
        batch = []
        for t in range(txns):
            ks = [keys[i] for i in idx[t].tolist()]
            batch.append(TxnConflictInfo(
                max(0, prev - int(lag[t])),
                [(k, k + b"\x00") for k in ks[:4]],
                [(k, k + b"\x00") for k in ks[4:]]))
        out.append((prev, version, batch))
        prev = version
    return out


def make_load_batches(rng, keys, n_batches, txns=1024, step=10_000):
    """YCSB's load phase, cut to `n_batches`: blind inserts (4 point writes
    a txn, no reads, so every txn commits) of distinct keys drawn at random
    from the key space and sent in ascending key order, as a bulk loader
    does. Chained from version 0."""
    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
    n = n_batches * txns * 4
    chosen = sorted(keys[i] for i in rng.choice(len(keys), n, replace=False))
    out, prev = [], 0
    for b in range(n_batches):
        version = prev + step
        base = b * txns * 4
        batch = [TxnConflictInfo(prev, [], [
            (k, k + b"\x00") for k in chosen[base + 4 * t:base + 4 * t + 4]])
            for t in range(txns)]
        out.append((prev, version, batch))
        prev = version
    return out


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over `reps` back-to-back calls
    (CUDA events), after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# device functions of each kernel wrapper, as the profiler names them
DEVICE_FUNCTIONS = {
    "sparse_table": ("table_low_kernel", "table_level_kernel"),
    "history_check": ("history_kernel",),
    "intra_sweep": ("intra_sweep_kernel",),
    "merge_compact": ("merge_prep_kernel", "merge_scan_kernel",
                      "merge_fill_kernel"),
}


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_device(fn, reps: int):
    """(device microseconds by function name, wall seconds) of `reps` calls
    of fn() under torch.profiler, after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and getattr(evt, "device_type", None) is not None \
                and "CUDA" in str(evt.device_type):
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us
    return by_name, wall


def device_ms_of(by_name: dict, name: str, reps: int) -> float | None:
    us = sum(v for k, v in by_name.items()
             if any(f in k for f in DEVICE_FUNCTIONS[name]))
    return us / 1e3 / reps if us > 0 else None


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = nops / H100_SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work_of(name: str, args, kw) -> tuple[float, float]:
    """(bytes, operations) the call must move and do on these inputs: each
    input read once, each output written once; gathers count only the
    elements this call's data touches."""
    if name == "sparse_table":
        (vals,) = args
        K = vals.shape[0]
        levels = max(1, (max(K, 2) - 1).bit_length() + 1)
        return 4.0 * K * (1 + levels), float(K * levels)
    if name == "history_check":
        table, cum_state, spos, rb, re, rtxn, snapshot, txn_valid, oldest = args
        L, NR = rb.shape
        T = snapshot.shape[0]
        nv = int((rtxn < T).sum())
        per_read = 4 * (1 + 2 * L + 2 + 2 + 2)  # rtxn, limbs, spos, cum, table
        return float(NR * 4 + nv * per_read + T * (4 + 1 + 2) + 4), \
            float(nv * (2 * L + 12))
    if name == "intra_sweep":
        c, g, geo, wtxn_c, w_ok, r_ok, rtxn, rbr = args[:8]
        nl, M = geo["src"].shape
        NR, NW, T = rtxn.shape[0], wtxn_c.shape[0], c.shape[0]
        nbytes = (nl * M * 10 + nl * NR * 8 + NW * 5 + NR * 9 + 3 * T)
        return float(nbytes), float(nl * (M * 8 + NR * 4))
    if name == "merge_compact":
        skeys, scls, sval, sidx, spos, merge_commit, wb, we, wtxn = args[:9]
        L, N = skeys.shape
        NW = wb.shape[1]
        K = kw["K"]
        T = merge_commit.shape[0]
        nbytes = (N * (L + 4) * 4 + 2 * L * NW * 4 + NW * 4 + T
                  + (L + 1) * K * 4)
        return float(nbytes), float(N * (2 * L + 24) + K * L)
    raise KeyError(name)


def library_call(name: str, args):
    """One PyTorch yardstick for the same function, or None: for the
    sparse table, the level doubling with max_pool1d (NEG padding)."""
    import torch
    if name != "sparse_table":
        return None
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    (vals,) = args
    K = vals.shape[0]

    def run():
        rows = [vals]
        cur = vals.to(torch.float64)[None, None, :]
        for lvl in range(1, ref.table_levels(K)):
            s = 1 << (lvl - 1)
            padded = torch.nn.functional.pad(cur, (0, s), value=float(ref.NEG))
            cur = torch.nn.functional.max_pool1d(padded, 2, stride=1,
                                                 dilation=s)[..., :K]
            rows.append(cur[0, 0].to(torch.int32))
        return torch.stack(rows)
    return run


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def clone_to(obj, device):
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.to(device, copy=True)
    if isinstance(obj, dict):
        return {k: clone_to(v, device) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(clone_to(v, device) for v in obj)
    return obj


def spied_phases(calls: dict, dev):
    """The plain phases, each keeping a copy of every call's inputs on
    `dev` in `calls[name]`."""
    from types import SimpleNamespace

    from foundationdb_tpu_torch.ops import conflict_ref as ref

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.setdefault(name, []).append(clone_to((a, kw), dev))
            return fn(*a, **kw)
        return wrapped
    return SimpleNamespace(
        build_table=spy("sparse_table", ref.build_table),
        history_check=spy("history_check", ref.history_check),
        intra_sweep=spy("intra_sweep", ref.intra_sweep),
        merge_compact=spy("merge_compact", ref.merge_compact))


def capture_main_path_calls(dev, batches):
    """Run the main path's step with the PLAIN phases on the card over
    `batches` (phase A traffic, default knobs) and keep the phase calls of
    the last step: the kernels' inputs at the main path's shapes."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops.conflict import DeviceConflictSet
    calls: dict = {}
    spied = spied_phases(calls, dev)
    cs = DeviceConflictSet(device=dev)
    for _prev, version, txns in batches:
        calls.clear()
        batch = cs.encoder.encode_batch(txns, version)
        cs._state, _s, _i = ref.conflict_step(
            cs._state, batch, max_write_life=5_000_000, phases=spied)
    return calls


def capture_calls_from(dev, cs, next_batch):
    """The phase calls of one more step, with the PLAIN phases, from a copy
    of a served conflict set's state: the kernels' inputs at that cell's
    shapes and state size."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    calls: dict = {}
    _prev, version, txns = next_batch
    batch = cs.encoder.encode_batch(txns, version)
    ref.conflict_step(clone_to(cs._state, dev), batch,
                      max_write_life=5_000_000,
                      phases=spied_phases(calls, dev))
    return calls


def edge_calls(dev):
    """Edge inputs: table widths off the tile size, all-NEG values, and the
    extreme int32 values the engine never stores but the kernel must not
    mishandle."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    g = torch.Generator().manual_seed(5)
    out = []
    for K in (1, 2, 1000, 1025, 65_536, 1 << 20):
        vals = torch.randint(ref.NEG, 1 << 30, (K,), generator=g,
                             dtype=torch.int32)
        out.append(((vals.to(dev),), {}))
    out.append(((torch.full((4096,), ref.NEG, dtype=torch.int32,
                            device=dev),), {}))
    return out


def check_kernels(dev, calls, results, cell, edges=True):
    """Hold each kernel to its plain version on every captured call of
    `cell` (and, with `edges`, on the edge inputs), then time the cell's
    main-path call: kernel, plain version, library yardstick, bound."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    wrappers = {"sparse_table": (kernels.build_table, ref.build_table),
                "history_check": (kernels.history_check, ref.history_check),
                "intra_sweep": (kernels.intra_sweep, ref.intra_sweep),
                "merge_compact": (kernels.merge_compact, ref.merge_compact)}
    all_calls = dict(calls)
    if edges:
        all_calls["sparse_table"] = calls["sparse_table"] + edge_calls(dev)
    for name, (kern, plain) in wrappers.items():
        n, max_err = 0, 0
        for a, kw in all_calls[name]:
            want = plain(*a, **kw)
            got = kern(*a, **kw)
            torch.cuda.synchronize()
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            for i, (w, g_) in enumerate(zip(want, got)):
                if w.shape != g_.shape or w.dtype != g_.dtype:
                    fail(f"{name} output {i}: {g_.dtype} {tuple(g_.shape)}, "
                         f"plain {w.dtype} {tuple(w.shape)}")
                err = int((w.long() - g_.long()).abs().max()) \
                    if w.numel() else 0
                max_err = max(max_err, err)
                if err:  # integer kernels: the tolerance is zero
                    fail(f"{name} output {i} differs from its plain version "
                         f"(max |diff| {err})")
            n += 1
        # time the main path's call: the last one captured from the step
        # (for the sweep, an evaluation that is not skipped)
        main = [c for c in calls[name]
                if name != "intra_sweep" or len(c[0]) < 9 or c[0][8] is None]
        a, kw = main[-1]
        reps = 20 if name == "merge_compact" else 50
        ms = time_cuda(lambda: kern(*a, **kw), reps)
        plain_ms = time_cuda(lambda: plain(*a, **kw), max(reps // 5, 5))
        lib = library_call(name, a)
        lib_ms = time_cuda(lib, reps) if lib is not None else None
        by_name, _wall = profile_device(lambda: kern(*a, **kw), reps)
        device_ms = device_ms_of(by_name, name, reps)
        nbytes, nops = work_of(name, a, kw)
        b_ms, b_by = bound_ms(nbytes, nops)
        results[name] = {"checked_calls": n, "max_abs_err": max_err,
                         "ms": ms, "device_ms": device_ms,
                         "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": lib_ms,
                         "bytes": nbytes, "operations": nops}
        log(f"cell {cell} kernel {name}: {n} calls equal to plain; "
            f"kernel_ms={ms:.4f} "
            f"(device-only {device_ms}) plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by}) library_ms={lib_ms}")


def profile_step(dev, batches):
    """Where one main-path step's time goes (default knobs): wall ms per
    chunk (encode, step, fused readback) with the kernels and with the
    plain phases on the card, and a profiler breakdown of the kernel
    step: device-busy ms, the four kernels' share, the top device
    functions and the device's idle share of the wall time."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops.conflict import (DeviceConflictSet,
                                                     _combine_status)
    out = {}
    for label, phases in (("kernels", None), ("plain", ref.PLAIN)):
        cs = DeviceConflictSet(device=dev)
        if phases is not None:
            cs._step = lambda st, b, cs=cs: ref.conflict_step(
                st, b, max_write_life=5_000_000, phases=phases)
        it = iter(batches)

        def one(cs=cs, it=it):
            _prev, version, txns = next(it)
            batch = cs.encoder.encode_batch(txns, version)
            cs._state, st, info = cs._step(cs._state, batch)
            _combine_status(st, info["eligible"], info["overflow"],
                            info["converged"]).cpu()
        one()
        torch.cuda.synchronize()
        n = 5
        t0 = time.perf_counter()
        for _ in range(n):
            one()
        out[f"{label}_chunk_ms"] = (time.perf_counter() - t0) / n * 1e3
        if label == "kernels":
            by_name, wall = profile_device(one, 3)
            busy = sum(by_name.values()) / 1e3 / 3
            ours = sum(device_ms_of(by_name, k, 3) or 0.0
                       for k in DEVICE_FUNCTIONS)
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
            out.update(
                device_busy_ms=busy, kernels_device_ms=ours,
                wall_ms=wall / 3 * 1e3,
                device_idle_share=max(0.0, 1 - busy / (wall / 3 * 1e3)),
                top_device_functions=[(k[:80], v / 1e3 / 3) for k, v in top])
    log("step profile: " + json.dumps(out))
    return out


def check_step_trajectory(dev):
    """The whole step with the kernels (card) against the plain step (CPU)
    over a small trajectory that overflows, poisons and rebases: every
    state field, status and info field must be equal after every step."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
    from foundationdb_tpu_torch.ops.conflict import (DeviceConflictSet,
                                                     state_to_numpy)
    rng = np.random.default_rng(12)
    keys = [b"k%05d" % i for i in range(20_000)]
    cpu = DeviceConflictSet(capacity=1024, txns=64, device="cpu")
    gpu = DeviceConflictSet(capacity=1024, txns=64, device=dev)
    version, steps, poisoned = 0, 0, False
    for i in range(12):
        if i == 6:
            cpu._state = ref.rebase_state(cpu._state, 40_000)
            gpu._state = ref.rebase_state(gpu._state, 40_000,
                                          phases=kernels.PHASES)
            version -= 40_000
        version += 10_000
        txns = []
        for _ in range(64):
            ks = [keys[j] for j in rng.integers(0, len(keys), 6).tolist()]
            a, b = sorted(ks[:2])
            reads = ([(ks[2], ks[2] + b"\x00"), (a, b)]
                     if rng.random() < 0.3 else [])
            txns.append(TxnConflictInfo(
                max(0, version - int(rng.integers(0, 30_000))), reads,
                [(k, k + b"\x00") for k in ks[3:]]
                + [(b, a)]))  # an inverted range: inert
        outs = []
        for cs in (cpu, gpu):
            batch = cs.encoder.encode_batch(txns, version)
            cs._state, st, info = cs._step(cs._state, batch)
            outs.append((st, info))
        torch.cuda.synchronize()
        (st_c, info_c), (st_g, info_g) = outs
        if not torch.equal(st_c, st_g.cpu()):
            fail(f"step {i}: statuses differ between kernels and plain")
        for k in info_c:
            if not torch.equal(info_c[k], info_g[k].cpu()):
                fail(f"step {i}: info[{k}] differs between kernels and plain")
        a_np, b_np = state_to_numpy(cpu._state), state_to_numpy(gpu._state)
        for k in a_np:
            if not np.array_equal(a_np[k], b_np[k]):
                fail(f"step {i}: state[{k}] differs between kernels and plain")
        poisoned |= bool(info_c["overflow"])
        steps += 1
    if not poisoned:
        fail("the step trajectory never overflowed: the poison path is "
             "unchecked")
    log(f"step trajectory: {steps} steps with kernels equal to the plain "
        f"step (overflow and rebase included)")
    return {"steps": steps, "poisoned": poisoned}


# ---------------------------------------------------------------------------
# phase 4: the resolver role serving commit batches
# ---------------------------------------------------------------------------

def serve_phase(name, dev, capacity, n_batches, n_keys, seed, n_load=0,
                window=4):
    """Serve `n_load` load batches, then `n_batches` run batches, through
    the port's Resolver; check every reply against the oracle. Returns the
    phase's numbers (throughput and latency of the run batches), the
    resolver's conflict set and one more run batch past the last served."""
    import torch

    from foundationdb_tpu_torch.core.eventloop import EventLoop
    from foundationdb_tpu_torch.core.sim import Endpoint, SimNetwork
    from foundationdb_tpu_torch.ops import kernels
    from foundationdb_tpu_torch.ops.conflict import kernel_metrics
    from foundationdb_tpu_torch.ops.conflict_oracle import OracleConflictSet
    from foundationdb_tpu_torch.server.interfaces import (
        ResolveTransactionBatchRequest, Token)
    from foundationdb_tpu_torch.server.resolver import Resolver
    from foundationdb_tpu_torch.utils.knobs import KNOBS
    from foundationdb_tpu_torch.utils.rng import DeterministicRandom

    rng = np.random.default_rng(seed)
    cdf, keys = zipf_keys(n_keys)
    t0 = time.perf_counter()
    load = make_load_batches(rng, keys, n_load) if n_load else []
    run = make_batches(rng, cdf, keys, n_batches + 1,
                       prev=load[-1][1] if load else 0)
    run, extra = run[:-1], run[-1]
    batches = load + run
    gen_s = time.perf_counter() - t0

    KNOBS.reset()
    KNOBS.overrides(CONFLICT_BACKEND="device", CONFLICT_DEVICE=str(dev),
                    CONFLICT_STATE_CAPACITY=capacity)
    loop = EventLoop()
    net = SimNetwork(loop, DeterministicRandom(seed))
    proc = net.new_process("resolver")
    proxy = net.new_process("proxy")
    t0 = time.perf_counter()
    resolver = Resolver(proc)  # warmup: every serving bucket once
    boot_s = time.perf_counter() - t0
    ep = Endpoint("resolver", Token.RESOLVER_RESOLVE)
    # host seconds by part of the role over the run batches: dispatch
    # (encode + enqueue of every chunk), readback wait + result (drain),
    # and the reply bookkeeping
    host = {"dispatch_s": 0.0, "drain_s": 0.0, "finish_s": 0.0}

    def timed(key, fn):
        def run_timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host[key] += time.perf_counter() - t
        return run_timed
    resolver.conflict_set.detect_async = timed(
        "dispatch_s", resolver.conflict_set.detect_async)
    resolver._finish_batch = timed("finish_s", resolver._finish_batch)
    import foundationdb_tpu_torch.server.resolver as resolver_mod
    drain = resolver_mod.drain_and_collect
    resolver_mod.drain_and_collect = timed("drain_s", drain)
    latency = [None] * len(batches)
    replies = [None] * len(batches)
    marks = {}

    async def send(first, last):
        inflight = []
        for i in range(first, last):
            prev, version, txns = batches[i]
            req = ResolveTransactionBatchRequest(
                prev_version=prev, version=version,
                last_receive_version=prev, transactions=txns)
            t_send = time.perf_counter()
            fut = net.request(proxy, ep, req, timeout=None)

            def done(f, i=i, t_send=t_send):
                latency[i] = time.perf_counter() - t_send
            fut.add_callback(done)
            inflight.append((i, fut))
            while len(inflight) >= window or (inflight and i == last - 1):
                j, f = inflight.pop(0)
                replies[j] = (await f).committed

    async def drive():
        # the load completes before the run starts, so the run's numbers
        # are its own
        marks["t0"] = time.perf_counter()
        await send(0, len(load))
        marks["t_run"] = time.perf_counter()
        for k in host:
            host[k] = 0.0
        await send(len(load), len(batches))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counted = ("KernelDispatches", "UnconvergedChunks")
    before = {k: kernel_metrics.as_dict()[k] for k in counted}
    kernels.reset_launches()
    loop.run_future(proxy.spawn(drive(), "proxyDriver"), max_time=1e9)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    chunks, unconverged = (kernel_metrics.as_dict()[k] - before[k]
                           for k in counted)
    resolver_mod.drain_and_collect = drain
    wall = t_end - marks["t_run"]
    peak = torch.cuda.max_memory_allocated()
    state = resolver.conflict_set._state
    boundaries, poisoned = int(state["nb"]), bool(state["poisoned"])

    t0 = time.perf_counter()
    oracle = OracleConflictSet()
    mismatches = 0
    for (prev, version, txns), got in zip(batches, replies):
        want = oracle.detect(txns, version)
        mismatches += got != want
    oracle_s = time.perf_counter() - t0
    n_txns = sum(len(b[2]) for b in run)
    statuses = np.concatenate([np.asarray(r) for r in replies[len(load):]])
    lat_ms = np.asarray(latency[len(load):], dtype=np.float64) * 1e3
    out = {
        "phase": name, "capacity": capacity, "batches": n_batches,
        "txns": n_txns, "keys": n_keys, "in_flight": window,
        "wall_s": wall, "txns_per_s": n_txns / wall,
        "batch_latency_ms_p50": float(np.percentile(lat_ms, 50)),
        "batch_latency_ms_p99": float(np.percentile(lat_ms, 99)),
        "committed_share": float((statuses == 2).mean()),
        "load_batches": len(load),
        "load_wall_s": marks["t_run"] - marks["t0"],
        "boundaries": boundaries, "poisoned": poisoned,
        "chunks": chunks, "unconverged_chunks": unconverged,
        "peak_device_bytes": peak, "launches": launches,
        "host_share": {k: v / wall for k, v in host.items()},
        "boot_s": boot_s, "traffic_gen_s": gen_s, "oracle_s": oracle_s,
        "mismatched_batches": mismatches}
    log(f"phase {name}: " + json.dumps(out))
    if mismatches:
        fail(f"phase {name}: {mismatches} batch replies differ from the "
             f"oracle")
    if poisoned:
        fail(f"phase {name}: the conflict state poisoned")
    if any(v <= 0 for v in launches.values()):
        fail(f"phase {name}: a kernel never launched: {launches}")
    if unconverged:
        # such a chunk's intra-batch verdicts come from the host pass, so
        # the oracle check would not show that the sweep kernel decided them
        fail(f"phase {name}: {unconverged} of {chunks} chunks did not "
             f"converge on the device")
    resolver.shutdown()
    return out, resolver.conflict_set, extra


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/chip_smoke.json")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    # the port: a missing package (the script alone) fails here
    from foundationdb_tpu_torch.ops import kernels
    dev = torch.device("cuda", 0)
    report: dict = {}

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    report["card"] = card
    report["torch"] = torch.__version__
    report["cuda"] = torch.version.cuda
    report["device_name"] = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    digest = source_digest()
    report["source_digest"] = digest
    log(f"source digest (sha256 of chip_smoke.py and the package's .py, .cu "
        f"and .cuh files): {digest}")

    # 2. the build
    t0 = time.perf_counter()
    kernels.library()
    build_s = time.perf_counter() - t0
    report["build"] = {"seconds": build_s,
                       "library": kernels.BUILD_INFO.get("library")}
    log(f"build: {build_s:.1f} s ({kernels.BUILD_INFO.get('library')})")
    for line in kernels.BUILD_INFO.get("ptxas", "").splitlines():
        if "registers" in line or line.startswith("=="):
            log(f"  {line.strip()}")

    # 3. kernels against their plain versions at the main path's shapes
    cdf, keys = zipf_keys(20_000)
    warm = make_batches(np.random.default_rng(args.seed + 100), cdf, keys, 4)
    kres: dict = {}
    check_kernels(dev, capture_main_path_calls(dev, warm), kres, "A")
    report["kernels"] = kres
    report["step_trajectory"] = check_step_trajectory(dev)
    report["step_profile"] = profile_step(dev, make_batches(
        np.random.default_rng(args.seed + 200), cdf, keys, 24))

    # 4. the resolver role, phases A and B; B starts with YCSB's load
    # phase, cut to 48 batches (196,608 of its 400,000 keys), so its state
    # holds about 400k boundaries; then every kernel is held to its plain
    # version again at B's shapes (K=2^20), from B's final state
    phase_a, _cs, _next = serve_phase("A", dev, 1 << 16, PHASE_A_BATCHES,
                                      20_000, args.seed + 1)
    phase_b, cs_b, next_b = serve_phase("B", dev, 1 << 20, PHASE_B_BATCHES,
                                        400_000, args.seed + 2,
                                        n_load=PHASE_B_LOAD_BATCHES)
    report["phases"] = [phase_a, phase_b]
    kres_b: dict = {}
    check_kernels(dev, capture_calls_from(dev, cs_b, next_b), kres_b, "B",
                  edges=False)
    report["kernels_cell_b"] = kres_b
    del cs_b

    kernels_line = []
    for name, (source, replaces) in kernels.KERNELS.items():
        r, rb = kres[name], kres_b[name]
        kernels_line.append({
            "name": name, "route": "cuda",
            "source": f"foundationdb_tpu_torch/{source}",
            "replaces": replaces.split(" ")[0],
            "launches": phase_a["launches"][name],
            "launches_phase_b": phase_b["launches"][name],
            "max_abs_err": max(r["max_abs_err"], rb["max_abs_err"]),
            "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "cell_b": {k: rb[k] for k in ("ms", "device_ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")}})
    report["kernels_line"] = kernels_line
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, default=str)

    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
