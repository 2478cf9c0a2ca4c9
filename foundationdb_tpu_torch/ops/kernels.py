"""The conflict step's four Hopper kernels: build, binding and wrappers.

Each wrapper has the signature of the phase function of
ops/conflict_ref.py that it replaces, so `PHASES` drops into
`conflict_ref.conflict_step` in place of `conflict_ref.PLAIN`:

  K1 build_table    csrc/sparse_table.cu   `_build_table`
  K2 history_check  csrc/history_check.cu  phases 1-2 of `conflict_step`
  K3 intra_sweep    csrc/intra_sweep.cu    `_intra_scan_blocked` in `_f_commit`
  K4 merge_compact  csrc/merge_compact.cu  `_merge_phase` up to the table

(functions of foundationdb_tpu/ops/conflict.py). A wrapper given tensors on
the CPU runs the plain version from conflict_ref; given CUDA tensors it
launches its kernel on the current stream or raises. Nothing falls back.
Each launch adds one to `LAUNCHES[name]`, so a run can show that it went
through the kernels.

The sources compile at first use with nvcc for sm_90a, one process per
source, all started together; the objects link into one shared library
with a plain C interface, bound with ctypes. The library lands in
`foundationdb_tpu_torch/_build/`, named by a hash of the sources, so a
checkout builds it once and a changed source builds anew.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.utils.errors import FDBError

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("sparse_table.cu", "history_check.cu", "intra_sweep.cu",
           "merge_compact.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# name -> (source, the JAX function it replaces)
KERNELS = {
    "sparse_table": ("csrc/sparse_table.cu",
                     "foundationdb_tpu/ops/conflict.py:145 _build_table"),
    "history_check": ("csrc/history_check.cu",
                      "foundationdb_tpu/ops/conflict.py:423 conflict_step "
                      "phases 1-2 (+ _range_max :163)"),
    "intra_sweep": ("csrc/intra_sweep.cu",
                    "foundationdb_tpu/ops/conflict.py:295 "
                    "_intra_scan_blocked (in _f_commit :537)"),
    "merge_compact": ("csrc/merge_compact.cu",
                      "foundationdb_tpu/ops/conflict.py:561 _merge_phase"),
}

LAUNCHES = {name: 0 for name in KERNELS}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# build and binding
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "fdb_sparse_table": [_P, _P, _I, _I, _P],
    "fdb_history_check": [_P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I,
                          _P, _P, _P, _P, _P],
    "fdb_intra_sweep": [_P] * 15 + [_I, _I, _I, _I, _P, _P, _P, _P],
    "fdb_merge_compact": [_P] * 14 + [_I] * 7 + [_P] * 10,
}

_lib = None
BUILD_INFO: dict = {}  # seconds, library path and ptxas report of the build


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise FDBError("platform_error",
                       "nvcc not found: the conflict kernels cannot be built")
    return found


def _source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the kernels (if this source set is not built yet) and return
    the library's path. Raises FDBError("platform_error") on any failure."""
    build_dir.mkdir(parents=True, exist_ok=True)
    lib_path = build_dir / f"libfdb_conflict_{_source_digest()}.so"
    if lib_path.exists():
        BUILD_INFO.update(seconds=0.0, library=str(lib_path), cached=True)
        return lib_path
    nvcc = _nvcc()
    t0 = time.perf_counter()
    work = build_dir / f"obj_{os.getpid()}"
    work.mkdir(exist_ok=True)
    procs = []
    for src in SOURCES:
        obj = work / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
               str(CSRC_DIR / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failed = [], []
    for src, _obj, proc in procs:
        out, _ = proc.communicate()
        reports.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src} (rc {proc.returncode}):\n{out}")
    if failed:
        raise FDBError("platform_error", "nvcc failed: " + "\n".join(failed))
    tmp = work / lib_path.name
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for _src, obj, _p in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise FDBError("platform_error", f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    shutil.rmtree(work, ignore_errors=True)
    report = "\n".join(reports)
    (build_dir / "ptxas_report.txt").write_text(report)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, library=str(lib_path),
                      cached=False, ptxas=report)
    return lib_path


def library():
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn, argtypes in _ARGTYPES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _launched(name: str, rc: int):
    if rc != 0:
        raise FDBError("internal_error",
                       f"kernel {name} failed to launch: CUDA error {rc}")
    LAUNCHES[name] += 1


def _on_cuda(name: str, first: torch.Tensor) -> bool:
    """True for CUDA inputs, False for CPU inputs (the plain version runs);
    any other device raises."""
    if first.device.type == "cuda":
        return True
    if first.device.type == "cpu":
        return False
    raise FDBError("invalid_option",
                   f"{name}: unsupported device {first.device}")


def _check(name: str, device, **tensors):
    """Each value is (tensor, dtype, shape); raise unless every tensor lies on
    `device` with that dtype and shape, contiguous."""
    for arg, (t, dtype, shape) in tensors.items():
        if (t.device != device or t.dtype != dtype
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise FDBError(
                "invalid_option",
                f"{name}: {arg} must be a contiguous {dtype} tensor of shape "
                f"{tuple(shape)} on {device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")


# Scratch the kernels keep zeroed between launches (per device and size):
# allocated zeroed once, and every launch leaves it zero again. Launches
# on one stream run in order, so reuse across calls is safe.
_zeroed: dict = {}


def _zeroed_scratch(kind: str, n: int, dtype, device) -> torch.Tensor:
    key = (kind, n, dtype, str(device))
    buf = _zeroed.get(key)
    if buf is None:
        buf = _zeroed[key] = torch.zeros(n, dtype=dtype, device=device)
    return buf


_I32, _BOOL = torch.int32, torch.bool


# ---------------------------------------------------------------------------
# K1 sparse_table
# ---------------------------------------------------------------------------

def build_table(vals: torch.Tensor) -> torch.Tensor:
    """(K,) int32 -> (LEVELS, K) power-of-two window maxima."""
    if not _on_cuda("sparse_table", vals):
        return ref.build_table(vals)
    K = vals.shape[0]
    _check("sparse_table", vals.device, vals=(vals, _I32, (K,)))
    levels = ref.table_levels(K)
    table = torch.empty((levels, K), dtype=_I32, device=vals.device)
    rc = library().fdb_sparse_table(vals.data_ptr(), table.data_ptr(), K,
                                    levels, _stream())
    _launched("sparse_table", rc)
    return table


# ---------------------------------------------------------------------------
# K2 history_check
# ---------------------------------------------------------------------------

def history_check(table, cum_state, spos, rb, re, rtxn, snapshot, txn_valid,
                  oldest):
    """Too-old and history verdicts per txn: (too_old, g0), both (T,) bool."""
    if not _on_cuda("history_check", table):
        return ref.history_check(table, cum_state, spos, rb, re, rtxn,
                                 snapshot, txn_valid, oldest)
    levels, K = table.shape
    L, NR = rb.shape
    T = snapshot.shape[0]
    N = cum_state.shape[0]
    dev = table.device
    _check("history_check", dev, table=(table, _I32, (levels, K)),
           cum_state=(cum_state, _I32, (N,)), spos=(spos, _I32, (N,)),
           rb=(rb, _I32, (L, NR)), re=(re, _I32, (L, NR)),
           rtxn=(rtxn, _I32, (NR,)), snapshot=(snapshot, _I32, (T,)),
           txn_valid=(txn_valid, _BOOL, (T,)), oldest=(oldest, _I32, ()))
    if N < K + 2 * NR:
        raise FDBError("invalid_option", "history_check: spos too short")
    scratch = _zeroed_scratch("history", 2 * T, _I32, dev)
    counter = _zeroed_scratch("history_counter", 1, _I32, dev)
    too_old = torch.empty(T, dtype=_BOOL, device=dev)
    g0 = torch.empty(T, dtype=_BOOL, device=dev)
    rc = library().fdb_history_check(
        table.data_ptr(), K, cum_state.data_ptr(), spos.data_ptr(),
        rb.data_ptr(), re.data_ptr(), L, NR, rtxn.data_ptr(),
        snapshot.data_ptr(), txn_valid.data_ptr(), oldest.data_ptr(), T,
        scratch.data_ptr(), counter.data_ptr(), too_old.data_ptr(),
        g0.data_ptr(), _stream())
    _launched("history_check", rc)
    return too_old, g0


# ---------------------------------------------------------------------------
# K3 intra_sweep
# ---------------------------------------------------------------------------

# 2 * M int32 of dynamic shared memory must fit the 227 KB a block can use
MAX_SWEEP_M = (232_448 - 1024) // 8


def intra_sweep(c, g, geo, wtxn_c, w_ok, r_ok, rtxn, rbr, skip=None,
                prev=None):
    """One evaluation of the sandwich's map f (see conflict_ref)."""
    if not _on_cuda("intra_sweep", c):
        return ref.intra_sweep(c, g, geo, wtxn_c, w_ok, r_ok, rtxn, rbr,
                               skip, prev)
    n_levels, M = geo["src"].shape
    T = c.shape[0]
    NW, NR = wtxn_c.shape[0], rtxn.shape[0]
    dev = c.device
    if M > MAX_SWEEP_M or M != NW + 2 * NR:
        raise FDBError("invalid_option",
                       f"intra_sweep: M={M} (NW={NW}, NR={NR}) exceeds the "
                       f"one-block shared-memory limit {MAX_SWEEP_M} or "
                       f"mismatches NW + 2 NR")
    lm, lq = (n_levels, M), (n_levels, NR)
    _check("intra_sweep", dev, c=(c, _BOOL, (T,)), g=(g, _BOOL, (T,)),
           src=(geo["src"], _I32, lm), is_w=(geo["is_w"], _BOOL, lm),
           werl=(geo["werl"], _I32, lm), bnd=(geo["bnd"], _BOOL, lm),
           qlo=(geo["qlo"], _I32, lq), qhi=(geo["qhi"], _I32, lq),
           wtxn_c=(wtxn_c, _I32, (NW,)), w_ok=(w_ok, _BOOL, (NW,)),
           r_ok=(r_ok, _BOOL, (NR,)), rtxn=(rtxn, _I32, (NR,)),
           rbr=(rbr, _I32, (NR,)))
    if (skip is None) != (prev is None):
        raise FDBError("invalid_option", "intra_sweep: skip needs prev")
    if skip is not None:
        _check("intra_sweep", dev, skip=(skip, _BOOL, ()),
               prev=(prev, _BOOL, (T,)))
    marks = _zeroed_scratch("sweep", T, _I32, dev)
    counter = _zeroed_scratch("sweep_counter", 1, _I32, dev)
    out = torch.empty(T, dtype=_BOOL, device=dev)
    rc = library().fdb_intra_sweep(
        c.data_ptr(), g.data_ptr(), geo["src"].data_ptr(),
        geo["is_w"].data_ptr(), geo["werl"].data_ptr(),
        geo["bnd"].data_ptr(), geo["qlo"].data_ptr(), geo["qhi"].data_ptr(),
        wtxn_c.data_ptr(), w_ok.data_ptr(), r_ok.data_ptr(),
        rtxn.data_ptr(), rbr.data_ptr(), _ptr(skip), _ptr(prev), n_levels,
        T, M, NR, marks.data_ptr(), counter.data_ptr(), out.data_ptr(),
        _stream())
    _launched("intra_sweep", rc)
    return out


# ---------------------------------------------------------------------------
# K4 merge_compact
# ---------------------------------------------------------------------------

def merge_compact(skeys, scls, sval, sidx, spos, merge_commit, wb, we, wtxn,
                  nb, oldest, poisoned, vnew, advance_floor, *, K: int,
                  max_write_life: int):
    """Merge, window GC, coalesce and compaction to K slots:
    (keys (L,K), vals (K,), nb, oldest, poisoned, boundaries)."""
    if not _on_cuda("merge_compact", skeys):
        return ref.merge_compact(
            skeys, scls, sval, sidx, spos, merge_commit, wb, we, wtxn, nb,
            oldest, poisoned, vnew, advance_floor, K=K,
            max_write_life=max_write_life)
    L, N = skeys.shape
    NW = wb.shape[1]
    NR = (N - K - 2 * NW) // 2
    T = merge_commit.shape[0]
    dev = skeys.device
    if NR < 0 or N != K + 2 * NR + 2 * NW:
        raise FDBError("invalid_option",
                       f"merge_compact: N={N} is not K + 2 NR + 2 NW")
    _check("merge_compact", dev, skeys=(skeys, _I32, (L, N)),
           scls=(scls, _I32, (N,)), sval=(sval, _I32, (N,)),
           sidx=(sidx, _I32, (N,)), spos=(spos, _I32, (N,)),
           merge_commit=(merge_commit, _BOOL, (T,)),
           wb=(wb, _I32, (L, NW)), we=(we, _I32, (L, NW)),
           wtxn=(wtxn, _I32, (NW,)), nb=(nb, _I32, ()),
           oldest=(oldest, _I32, ()), poisoned=(poisoned, _BOOL, ()),
           vnew=(vnew, _I32, ()), advance_floor=(advance_floor, _BOOL, ()))
    flags = torch.empty(N, dtype=torch.uint8, device=dev)
    delta = _zeroed_scratch("merge_delta", N, _I32, dev)
    csrc = torch.empty(K, dtype=_I32, device=dev)
    out_keys = torch.empty((L, K), dtype=_I32, device=dev)
    out_vals = torch.empty(K, dtype=_I32, device=dev)
    nb_out = torch.empty((), dtype=_I32, device=dev)
    oldest_out = torch.empty((), dtype=_I32, device=dev)
    poisoned_out = torch.empty((), dtype=_BOOL, device=dev)
    boundaries = torch.empty((), dtype=_I32, device=dev)
    rc = library().fdb_merge_compact(
        skeys.data_ptr(), scls.data_ptr(), sval.data_ptr(), sidx.data_ptr(),
        spos.data_ptr(), merge_commit.data_ptr(), wb.data_ptr(),
        we.data_ptr(), wtxn.data_ptr(), nb.data_ptr(), oldest.data_ptr(),
        poisoned.data_ptr(), vnew.data_ptr(), advance_floor.data_ptr(), L, N,
        K, NR, NW, T, int(max_write_life), flags.data_ptr(), delta.data_ptr(),
        csrc.data_ptr(), out_keys.data_ptr(), out_vals.data_ptr(),
        nb_out.data_ptr(), oldest_out.data_ptr(), poisoned_out.data_ptr(),
        boundaries.data_ptr(), _stream())
    _launched("merge_compact", rc)
    return out_keys, out_vals, nb_out, oldest_out, poisoned_out, boundaries


PHASES = SimpleNamespace(build_table=build_table, history_check=history_check,
                         intra_sweep=intra_sweep, merge_compact=merge_compact)
