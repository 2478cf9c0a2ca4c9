"""The conflict step's Hopper kernels: build, binding and wrappers.

Each wrapper has the signature of the phase function of
ops/conflict_ref.py that it replaces, so `PHASES` drops into
`conflict_ref.conflict_step` in place of `conflict_ref.PLAIN`:

  K1 build_table    csrc/sparse_table.cu    `_build_table`
     rebase_table   csrc/sparse_table.cu    `rebase_state` (`_compiled_rebase`)
  K2 history_check  csrc/history_check.cu   phases 1-2 of `conflict_step`
  K9 intra_levels   csrc/intra_levels.cu    `_intra_scan_levels`
  K3 intra_sandwich csrc/intra_sweep.cu     `_run_sandwich` (over `_f_commit`)
  K4 merge_compact  csrc/merge_compact.cu   `_merge_phase` up to the table
  K5 legacy_fixpoint csrc/legacy_overlap.cu the legacy evaluator's fixpoint
     legacy_sweep                           (`while_loop` over `_f_commit`),
                                            or one evaluation of `_f_commit`
  K6 endpoint_sort  csrc/endpoint_sort.cu   phase 0's sort, the endpoints
  K7 state_merge    csrc/state_merge.cu     phase 0's sorted union, spos,
                                            cum_state
  K8 endpoint_ranks csrc/endpoint_ranks.cu  the endpoint ranks (phase 3)
  K10 clip_ranges   csrc/shard_clip.cu      `_clip_ranges` (sharded engine)
  K11 shard_combine csrc/shard_combine.cu   `local_step`'s pmin/pmax combine
  K12 step_masks    csrc/step_glue.cu       the strided owners and the
                                            intra-batch masks
  K13 step_verdicts csrc/step_glue.cu       the statuses, the committed count,
                                            `conflict_scan`'s rows and
                                            `_combine_fn`'s readback row

(functions of foundationdb_tpu/ops/conflict.py; K10 and K11 of
foundationdb_tpu/parallel/sharded_conflict.py). The probe kernels of
ops/probes.py (csrc/probes.cu) build into the same library and count their
launches here too. A wrapper given tensors on
the CPU runs the plain version from conflict_ref; given CUDA tensors it
launches its kernel on the current stream or raises. Nothing falls back.
Each launch adds one to `LAUNCHES[name]`, so a run can show that it went
through the kernels.

K1 writes every row of the table once, in at most two launches for any K:
levels 0-10 per 1,024-column tile in shared memory, then (K > 1,024) every
higher level from each column's in-tile suffix maximum, a prefix maximum
over the whole tiles in between and the in-tile prefix maximum where the
window ends. K2 is one cooperative launch: a thread per read folds "has a
read" and "hit" into per-txn bit words (warp-aggregated atomicOr), one grid
barrier, then a thread per txn writes the verdicts; no CTA loops over T.
K3 runs the whole sandwich of a step (every evaluation and the pinch test)
in one persistent kernel: one CTA per SM, launched with
cudaLaunchCooperativeKernel so that its grid-wide barriers cannot
deadlock. Its txn bit sets sit in each CTA's shared memory where they fit
beside the CTA's reads, else (T above about 450,000 to 570,000 txns, by
the reads a txn) one copy sits in global memory, L2 resident, with one
more grid barrier an evaluation; the library picks the layout from the
shape, so no shape is refused for its size. A launch the card refuses
still raises FDBError, as any failed launch does. K4's merge scan is a
single-pass decoupled look-back scan over all SMs.

K9 computes the scan evaluator's level geometry, every level of a step,
in one cooperative launch, and picks its path on the card from the
owners. Where they arrive nondecreasing (both layouts of the main path)
and no span overfills, a CTA a span of 2^s txns (`level_plan`) does every
level below s in shared memory with block barriers only, and the levels
from s up are grid passes; any other input takes the general path, a
merge sort of the writes and of the queries by (txn, rank, class, index)
and then a grid pass a level. A grid pass bisects over samples of the
runs in shared memory and over a short window in L2 (no radix sort).
`level_paths` reads which path each launch took and how many grid
barriers the last one made (counters the kernel keeps in its flag words).
`rebase_table` is K1 with the rebase folded into its first launch: the
values are shifted down and saturated as they are loaded, and written out
beside the table.

`sort_and_rank`, the step's first phase, is K6, K8 and K7 in turn. The
state keys arrive sorted, so K6 sorts only the 2NR + 2NW endpoints: a
bitonic network per 1,024-element tile, its strides below 64 in registers
and warp shuffles, then, in the same cooperative launch, from 32 tiles
up (`sort_plan`'s sample path), a sample sort: every tile's regular
samples ranked once, spread over the CTAs, the splitters found in each
run, and each bucket's pieces merged in shared memory, three grid
barriers whatever M is; below 32 tiles (cell A's 16), or past the SMs or
the shared memory, the merge-path rounds instead, a grid barrier a round;
K8 ranks them in one
cooperative launch (each
tile's key changes as warp ballots, its count, one grid barrier, then
each tile's prefix from the counts before it); K7 merges them into the
state, a CTA a tile of 512 to 2,048 outputs: the tile's two co-ranks by
a few rounds of probes in global memory, both slices to shared memory by
cp.async, a run of outputs a thread merged with two fingers, and the
sorted union, `spos` and `cum_state` written in one pass. That is 3 device
launches, in place of about 40 torch launches.

K5 runs the legacy evaluator's whole fixpoint in one cooperative launch:
every evaluation of f is a grid pass over tiles of 512 reads by 256
writes (a tile whose writes all belong at or after its reads' txns is
skipped; CTAs take tiles from a ticket a pass), with a grid barrier
between passes and each body's test counted
on the card, so the step reads nothing on the host. `legacy_sweep` runs
the same kernel for one evaluation.

The sharded engine (parallel/sharded_conflict.py) runs a chunk as one K10
launch, the step of each shard, then one K11 launch; on one card the whole
chunk is one CUDA graph. K10 writes every shard's clipped copy of the
batch's four endpoint arrays, a thread per (shard, column), into given
buffers. K11 takes the shards' verdicts where their steps left them:
their device pointers travel by value in the launch's parameters, so the
combine costs no stack and no copy; it writes the engine's readback row
with the combined verdicts, and its committed count goes through zeroed
scratch that the launch leaves zero.

K12 and K13 are the step's elementwise glue, one launch each a step in
place of about 25 torch launches: K12 derives the range->txn maps (the
strided layout's from the padding limb) and the masks of the intra-batch
phase; K13, one thread-block cluster (a grid of clusters past T =
32,768, cluster 0 counting), writes the statuses, the committed count
(each CTA's sum read by rank 0 through distributed shared memory),
the resolver's packed readback row and, in a scan, the step's row of the
scan's outputs. With both, a step on the card is kernel launches and a
few 4-byte copies only, which is what lets ops/step_graph.py capture it
as a CUDA graph.

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
SOURCES = ("endpoint_sort.cu", "state_merge.cu", "endpoint_ranks.cu",
           "sparse_table.cu", "history_check.cu", "intra_levels.cu",
           "intra_sweep.cu", "merge_compact.cu", "legacy_overlap.cu",
           "shard_clip.cu", "shard_combine.cu", "step_glue.cu", "probes.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# name -> (source, the JAX function it replaces)
KERNELS = {
    "endpoint_sort": ("csrc/endpoint_sort.cu",
                      "foundationdb_tpu/ops/conflict.py:412 conflict_step "
                      "phase 0 (:397-421), the lax.sort's endpoints"),
    "state_merge": ("csrc/state_merge.cu",
                    "foundationdb_tpu/ops/conflict.py:413 conflict_step "
                    "phase 0 (:397-421), the sorted union, spos and "
                    "cum_state"),
    "endpoint_ranks": ("csrc/endpoint_ranks.cu",
                       "foundationdb_tpu/ops/conflict.py:465 conflict_step "
                       "endpoint ranks (:465-476)"),
    "sparse_table": ("csrc/sparse_table.cu",
                     "foundationdb_tpu/ops/conflict.py:145 _build_table"),
    "rebase_table": ("csrc/sparse_table.cu",
                     "foundationdb_tpu/ops/conflict.py:707 rebase_state "
                     "(_compiled_rebase :761)"),
    "history_check": ("csrc/history_check.cu",
                      "foundationdb_tpu/ops/conflict.py:423 conflict_step "
                      "phases 1-2 (+ _range_max :163)"),
    "intra_levels": ("csrc/intra_levels.cu",
                     "foundationdb_tpu/ops/conflict.py:243 "
                     "_intra_scan_levels"),
    "intra_sandwich": ("csrc/intra_sweep.cu",
                       "foundationdb_tpu/ops/conflict.py:311 _run_sandwich "
                       "over _intra_scan_blocked :295 (in _f_commit :537)"),
    "merge_compact": ("csrc/merge_compact.cu",
                      "foundationdb_tpu/ops/conflict.py:561 _merge_phase"),
    "legacy_blocked": ("csrc/legacy_overlap.cu",
                       "foundationdb_tpu/ops/conflict.py:506 _f_commit and "
                       "the while_loop of the legacy evaluator (:491-533)"),
    "shard_clip": ("csrc/shard_clip.cu",
                   "foundationdb_tpu/parallel/sharded_conflict.py:111 "
                   "_clip_ranges (in local_step :185-186)"),
    "shard_combine": ("csrc/shard_combine.cu",
                      "foundationdb_tpu/parallel/sharded_conflict.py:193 "
                      "local_step's pmin/pmax combine (:193-210)"),
    "step_masks": ("csrc/step_glue.cu",
                   "foundationdb_tpu/ops/conflict.py:385 conflict_step's "
                   "strided owners and intra-batch masks (:385-395, "
                   ":477-489)"),
    "step_verdicts": ("csrc/step_glue.cu",
                      "foundationdb_tpu/ops/conflict.py:545 conflict_step's "
                      "statuses and committed count (:545-553), "
                      "conflict_scan's rows (:782-786) and _combine_fn "
                      "(:1190-1198)"),
    "probe_add": ("csrc/probes.cu", "scripts/ab_pallas.py:37 add_kernel"),
    "probe_stream_rows": ("csrc/probes.cu",
                          "scripts/ab_pallas.py:49 stream_kernel"),
    "probe_join": ("csrc/probes.cu", "scripts/ab_pallas.py:80 join_kernel"),
    "probe_dynwrite": ("csrc/probes.cu",
                       "scripts/ab_pallas.py:112 dynwrite_kernel"),
    "probe_stream_limbs": ("csrc/probes.cu",
                           "scripts/ab_pallas2.py:39 stream_kernel"),
    "probe_lexjoin": ("csrc/probes.cu",
                      "scripts/ab_pallas2.py:64 lexjoin_kernel"),
}

LAUNCHES = {name: 0 for name in KERNELS}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# build and binding
# ---------------------------------------------------------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "fdb_endpoint_sort": [_P] * 4 + [_I] * 5 + [_P] * 7,
    "fdb_state_merge": [_P] * 4 + [_I] * 4 + [_P] * 7,
    "fdb_endpoint_ranks": [_P, _P, _I, _I, _P, _P, _P, _P],
    "fdb_sparse_table": [_P, _P, _I, _I, _P, _LL, _P, _P, _P, _P],
    "fdb_intra_levels": [_P] * 6 + [_I] * 5 + [_P] * 12,
    "fdb_history_check": [_P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I,
                          _I, _P, _P, _P, _P, _P],
    "fdb_intra_sandwich": [_P] * 12 + [_I] * 5 + [_P] * 12,
    "fdb_merge_compact": [_P] * 14 + [_I] * 7 + [_P] * 10,
    "fdb_legacy_overlap": [_P] * 10 + [_I] * 5 + [_P] * 7,
    "fdb_shard_clip": [_P] * 6 + [_I] * 4 + [_P] * 5,
    "fdb_shard_combine": [_P, _I, _I] + [_P] * 7,
    "fdb_step_masks": [_P] * 8 + [_I] * 5 + [_P] * 6,
    "fdb_step_verdicts": [_P] * 6 + [_I] + [_P] * 6,
    "fdb_probe_add": [_P, _P, _LL, _P],
    "fdb_probe_stream": [_P, _I, _I, _LL, _LL, _I, _P, _P],
    "fdb_probe_rank": [_P, _P, _I, _I, _I, _I] + [_LL] * 5 + [_I, _P, _P],
    "fdb_probe_dynwrite": [_P, _P, _I, _I, _I, _P, _P],
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


# Scratch every launch overwrites before it reads: kept per size too, so a
# step allocates nothing for it.
_scratches: dict = {}


def _scratch(kind: str, n: int, dtype, device) -> torch.Tensor:
    key = (kind, n, dtype, str(device))
    buf = _scratches.get(key)
    if buf is None:
        buf = _scratches[key] = torch.empty(max(n, 1), dtype=dtype,
                                            device=device)
    return buf


def release_scratch():
    """Drop every cached scratch buffer, so that the memory a large call
    took is given back; the next launch of each size allocates anew. Waits
    for the card first, since a launch in flight may still use them."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    _scratches.clear()
    _zeroed.clear()


_I32, _BOOL = torch.int32, torch.bool


# ---------------------------------------------------------------------------
# K6-K8 sort_and_rank
# ---------------------------------------------------------------------------

# endpoints a tile of K8 (RANK_TILE in the source)
RANK_TILE = 512

# K6's tile and the sample path's limits (SORT_TILE, SS_MAX_SAMPLES,
# SS_MIN_SAMPLES, SS_SAMPLE_BUDGET and SS_SMEM_MAX in the source)
SORT_TILE = 1024
SORT_MAX_SAMPLES = 64
SORT_MIN_SAMPLES = 8
SORT_SAMPLE_BUDGET = 8192
SORT_SMEM_MAX = 227 * 1024 - 1024


def sort_cap(tiles: int, samples: int) -> int:
    """The most endpoints a bucket of K6's sample path can hold (padding
    included), for `tiles` tiles of SORT_TILE and `samples` samples a
    tile: run i adds at most (c_i + 1) g - 1 endpoints for the c_i of the
    bucket's samples it holds (g = SORT_TILE / samples), the run holding
    the upper splitter at most c_i g, and the c_i sum to `samples`
    (`ss_cap` in the source)."""
    g = SORT_TILE // samples
    return (samples + tiles - 1) * g - tiles + 1


def _sort_smem_bytes(L: int, tiles: int, samples: int) -> int:
    """The sample path's dynamic shared memory (`ss_smem_words` in the
    source): the run and the larger of the hash table, the samples' keys
    and ranks and the splitters; or the bucket and its pieces' offsets."""
    ns = tiles * samples
    run = (L + 3) * SORT_TILE
    extra = max(3 * SORT_TILE, 2 * ns + samples, (L + 1) * (tiles - 1))
    bucket = (L + 8) * sort_cap(tiles, samples) + 2 * tiles + 1
    return 4 * max(run + extra, bucket)


# tiles from which the plan takes the sample path's kernel: from there it
# was timed no slower than the rounds kernel on cell A's zipfian traffic,
# and faster on keys with few ties; below it, on cell A's 16 tiles, the
# rounds kernel was the faster (PERF.md)
SORT_SAMPLE_MIN_TILES = 32
# the sample path's kernel takes the merge rounds where more than
# M / SORT_TIE_DIV endpoints tie their run predecessor's primary key: the
# sample sort was timed the faster up to 0.8% of M and the slower from
# 2.4% at 16 tiles, up to 2.3% and from 7.2% at 128 (PERF.md)
SORT_TIE_DIV = 64


def sort_samples(M: int, L: int, sms: int = 132) -> int:
    """The samples a tile K6's sample path takes for M endpoints of L limbs
    on a card of `sms` SMs, whatever the tiles: the most, a power of two
    from SORT_MAX_SAMPLES down to SORT_MIN_SAMPLES, with at most
    SORT_SAMPLE_BUDGET samples in all, whose shared memory fits
    SORT_SMEM_MAX; 0 where none fits, or the tiles are one or more than
    the SMs (a CTA a tile, each on its own SM)."""
    tiles = max(1, -(-int(M) // SORT_TILE))
    s = SORT_MAX_SAMPLES
    while 1 < tiles <= sms and s >= SORT_MIN_SAMPLES:
        if (tiles * s <= SORT_SAMPLE_BUDGET
                and _sort_smem_bytes(L, tiles, s) <= SORT_SMEM_MAX):
            return s
        s //= 2
    return 0


def sort_plan(M: int, L: int, sms: int = 132, samples: int | None = None
              ) -> dict:
    """K6's launch plan for M endpoints of L limbs on a card of `sms` SMs.
    `path` is "tile" (one tile: the tile sort alone), "sample" (a
    cooperative launch of `tiles` CTAs, a tile and a bucket each, with
    `sort_samples` samples a tile: the sample sort, or the merge rounds
    where more than `tie_limit` endpoints tie their run predecessor's
    primary key) or "rounds" (a cooperative launch of the tile sort and
    the merge rounds): one launch each. The sample path is taken from
    SORT_SAMPLE_MIN_TILES tiles up where it fits. `samples` forces the
    samples a tile (0: the tile or rounds path). `cap` bounds a bucket
    (sort_cap); `scratch_words` is the sample path's int32 scratch: the
    samples, the splitters, the tiles x tiles counts and two words a
    tile."""
    tiles = max(1, -(-int(M) // SORT_TILE))
    if samples is None:
        samples = (sort_samples(M, L, sms)
                   if tiles >= SORT_SAMPLE_MIN_TILES else 0)
    samples = int(samples)
    if samples == 0:
        path = "tile" if tiles == 1 else "rounds"
        return {"tiles": tiles, "samples": 0, "buckets": 0, "cap": 0,
                "path": path, "launches": 1,
                "grid_barriers": (tiles - 1).bit_length(),
                "smem_bytes": 0, "scratch_words": 0, "tie_limit": 0}
    return {"tiles": tiles, "samples": samples, "buckets": tiles,
            "cap": sort_cap(tiles, samples), "path": "sample",
            "launches": 1, "grid_barriers": 3,
            "smem_bytes": _sort_smem_bytes(L, tiles, samples),
            "scratch_words": (L + 1) * (tiles * samples + tiles - 1)
            + tiles * tiles + 2 * tiles,
            "tie_limit": int(M) // SORT_TIE_DIV}


_SMS: dict = {}


def _sm_count(dev) -> int:
    key = str(dev)
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[key]


# Overrides K6's plan ({"samples": s} forces the samples a tile, 0 the
# tile sort and the merge rounds; {"tie_limit": n} the sample path's tie
# limit, -1 always the rounds, 2**31 - 1 never), for the tests and the
# timing of each design at one shape; None in production.
SORT_OVERRIDE: dict | None = None


def endpoint_sort(rb, re, wb, we):
    """K6: the endpoints [rb | re | wb | we] sorted by (limbs, class,
    index): (keys (L, M), idx (M,) int32), in one cooperative launch by
    the path `sort_plan` picks."""
    if not _on_cuda("endpoint_sort", rb):
        return ref.endpoint_sort(rb, re, wb, we)
    L, NR = rb.shape
    NW = wb.shape[1]
    M = 2 * NR + 2 * NW
    dev = rb.device
    _check("endpoint_sort", dev, rb=(rb, _I32, (L, NR)),
           re=(re, _I32, (L, NR)), wb=(wb, _I32, (L, NW)),
           we=(we, _I32, (L, NW)))
    keys = torch.empty((L, M), dtype=_I32, device=dev)
    idx = torch.empty(M, dtype=_I32, device=dev)
    if M == 0:
        return keys, idx
    force = SORT_OVERRIDE or {}
    plan = sort_plan(M, L, _sm_count(dev), force.get("samples"))
    tie_limit = force.get("tie_limit", plan["tie_limit"])
    tmp_keys = _scratch("sort_keys", L * M, _I32, dev)
    tmp_idx = _scratch("sort_idx", M, _I32, dev)
    scratch = _scratch("sort_samples", plan["scratch_words"], _I32, dev)
    sync = _zeroed_scratch("sort_sync", 1, _I32, dev)
    rc = library().fdb_endpoint_sort(
        rb.data_ptr(), re.data_ptr(), wb.data_ptr(), we.data_ptr(), L, NR,
        NW, plan["samples"], tie_limit, keys.data_ptr(), idx.data_ptr(),
        tmp_keys.data_ptr(), tmp_idx.data_ptr(), scratch.data_ptr(),
        sync.data_ptr(), _stream())
    _launched("endpoint_sort", rc)
    return keys, idx


def endpoint_ranks(ekeys, eidx):
    """K8: the dense rank of each endpoint's key among all endpoint keys,
    at its endpoint index, from K6's sorted endpoints: (M,) int32."""
    if not _on_cuda("endpoint_ranks", ekeys):
        return ref.endpoint_ranks(ekeys, eidx)
    L, M = ekeys.shape
    dev = ekeys.device
    _check("endpoint_ranks", dev, ekeys=(ekeys, _I32, (L, M)),
           eidx=(eidx, _I32, (M,)))
    qranks = torch.empty(M, dtype=_I32, device=dev)
    if M == 0:
        return qranks
    counts = _scratch("rank_counts", -(-M // RANK_TILE), _I32, dev)
    sync = _zeroed_scratch("rank_sync", 1, _I32, dev)
    rc = library().fdb_endpoint_ranks(ekeys.data_ptr(), eidx.data_ptr(), L,
                                      M, counts.data_ptr(), sync.data_ptr(),
                                      qranks.data_ptr(), _stream())
    _launched("endpoint_ranks", rc)
    return qranks


MERGE_MAX_LIMBS = 17  # SM_MAX_LIMBS in the source: 64-byte keys


def state_merge(bkeys, bval, ekeys, eidx, NR: int):
    """K7: the sorted endpoints merged into the sorted state: (skeys,
    scls, sval, sidx, spos, cum_state), as `conflict_ref.state_merge`."""
    if not _on_cuda("state_merge", bkeys):
        return ref.state_merge(bkeys, bval, ekeys, eidx, NR)
    L, K = bkeys.shape
    M = eidx.shape[0]
    N = K + M
    dev = bkeys.device
    if not 1 <= L <= MERGE_MAX_LIMBS:
        raise FDBError("invalid_option",
                       f"state_merge: L={L} (at most {MERGE_MAX_LIMBS})")
    if NR < 0 or M < 2 * NR or (M - 2 * NR) % 2:
        raise FDBError("invalid_option",
                       f"state_merge: M={M} is not 2 NR + 2 NW (NR={NR})")
    _check("state_merge", dev, bkeys=(bkeys, _I32, (L, K)),
           bval=(bval, _I32, (K,)), ekeys=(ekeys, _I32, (L, M)),
           eidx=(eidx, _I32, (M,)))
    skeys = torch.empty((L, N), dtype=_I32, device=dev)
    vecs = torch.empty((5, N), dtype=_I32, device=dev)
    scls, sval, sidx, spos, cum_state = vecs
    rc = library().fdb_state_merge(
        bkeys.data_ptr(), bval.data_ptr(), ekeys.data_ptr(), eidx.data_ptr(),
        L, K, M, NR, skeys.data_ptr(), scls.data_ptr(), sval.data_ptr(),
        sidx.data_ptr(), spos.data_ptr(), cum_state.data_ptr(), _stream())
    _launched("state_merge", rc)
    return skeys, scls, sval, sidx, spos, cum_state


SORT_PARTS = SimpleNamespace(endpoint_sort=endpoint_sort,
                             endpoint_ranks=endpoint_ranks,
                             state_merge=state_merge)


def sort_and_rank(bkeys, bval, rb, re, wb, we):
    """Phase 0 and the endpoint ranks of the step: (skeys, scls, sval,
    sidx, spos, cum_state, qranks), as `conflict_ref.sort_and_rank`. On
    the card: K6 sorts the endpoints, K8 ranks them and K7 merges them into
    the state (the state keys must be sorted, as every state is)."""
    if not _on_cuda("endpoint_sort", bkeys):
        return ref.sort_and_rank(bkeys, bval, rb, re, wb, we)
    return ref.sort_and_rank_parts(bkeys, bval, rb, re, wb, we, SORT_PARTS)


# ---------------------------------------------------------------------------
# K1 sparse_table
# ---------------------------------------------------------------------------

# columns a CTA tiles and the levels its first launch writes (TILE and
# LOW_LEVELS in the source)
TABLE_TILE = 1024
TABLE_LOW_LEVELS = 11


def _sparse_table(name, vals, delta=0, oldest=None, out=None):
    """K1's launches: the table of vals (shifted by -delta, saturating at
    NEG, with `oldest`: then also the shifted vals and oldest), into `out`
    if given (not `vals`' own storage)."""
    K = vals.shape[0]
    dev = vals.device
    _check(name, dev, vals=(vals, _I32, (K,)))
    levels = ref.table_levels(K)
    if out is None:
        table = torch.empty((levels, K), dtype=_I32, device=dev)
    else:
        _check(name, dev, out=(out, _I32, (levels, K)))
        table = out
    scratch = None  # pre, suf and the tile maxima, for the second launch
    if levels > TABLE_LOW_LEVELS:
        scratch = _scratch("table", 2 * K + -(-K // TABLE_TILE), _I32,
                           dev).data_ptr()
    shifted = oldest_out = None
    if oldest is not None:
        _check(name, dev, oldest=(oldest, _I32, ()))
        shifted = torch.empty(K, dtype=_I32, device=dev)
        oldest_out = torch.empty((), dtype=_I32, device=dev)
    rc = library().fdb_sparse_table(
        vals.data_ptr(), table.data_ptr(), K, levels, scratch, int(delta),
        None if oldest is None else oldest.data_ptr(),
        None if shifted is None else shifted.data_ptr(),
        None if oldest_out is None else oldest_out.data_ptr(), _stream())
    _launched(name, rc)
    return table, shifted, oldest_out


def build_table(vals: torch.Tensor, out=None) -> torch.Tensor:
    """(K,) int32 -> (LEVELS, K) power-of-two window maxima, written into
    `out` when given (the state's table: the step's last reader of the old
    table, K2, has run by then)."""
    if not _on_cuda("sparse_table", vals):
        return ref.build_table(vals, out=out)
    return _sparse_table("sparse_table", vals, out=out)[0]


def rebase_table(bval, oldest, delta: int):
    """K1 with the rebase folded into its first launch: (bval', oldest',
    table), bval' = max(bval - delta, NEG), oldest' alike, the table of
    bval'. 0 <= delta <= 2^30."""
    if not _on_cuda("rebase_table", bval):
        return ref.rebase_table(bval, oldest, delta)
    if not 0 <= int(delta) <= 1 << 30:
        raise FDBError("invalid_option",
                       f"rebase_table: delta {delta} is not in [0, 2^30]")
    table, shifted, oldest_out = _sparse_table("rebase_table", bval, delta,
                                               oldest)
    return shifted, oldest_out, table


# ---------------------------------------------------------------------------
# K2 history_check
# ---------------------------------------------------------------------------

def history_check(table, cum_state, spos, rb, re, rtxn, snapshot, txn_valid,
                  oldest, skip_history: bool = False):
    """Too-old and history verdicts per txn: (too_old, g0), both (T,) bool.
    With `skip_history`, no read hits (the `no_hist` ablations)."""
    if not _on_cuda("history_check", table):
        return ref.history_check(table, cum_state, spos, rb, re, rtxn,
                                 snapshot, txn_valid, oldest, skip_history)
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
    words = _zeroed_scratch("history_words", 2 * (-(-T // 32)), _I32, dev)
    sync = _zeroed_scratch("history_sync", 1, _I32, dev)
    too_old = torch.empty(T, dtype=_BOOL, device=dev)
    g0 = torch.empty(T, dtype=_BOOL, device=dev)
    rc = library().fdb_history_check(
        table.data_ptr(), K, cum_state.data_ptr(), spos.data_ptr(),
        rb.data_ptr(), re.data_ptr(), L, NR, rtxn.data_ptr(),
        snapshot.data_ptr(), txn_valid.data_ptr(), oldest.data_ptr(), T,
        int(bool(skip_history)), words.data_ptr(), sync.data_ptr(),
        too_old.data_ptr(),
        g0.data_ptr(), _stream())
    _launched("history_check", rc)
    return too_old, g0


# ---------------------------------------------------------------------------
# K9 intra_levels
# ---------------------------------------------------------------------------

# elements a span of K9's span path holds in shared memory, and the
# dynamic shared memory of a CTA (LV_SPAN_CAP and LV_SMEM in the source)
LEVEL_SPAN_CAP = 4096
LEVEL_SPAN_LOG2_MAX = 10  # LV_SPAN_LOG2_MAX: a span is at most 2^10 txns
LEVEL_SMEM_BYTES = (2 * LEVEL_SPAN_CAP * 12
                    + 4 * (2 + 5 * (1 << LEVEL_SPAN_LOG2_MAX) // 2))


def level_plan(T: int, NW: int, NR: int, span_log2: int | None = None
               ) -> dict:
    """K9's launch plan for a shape: `span_log2` (s) is the largest s up to
    n_levels and LEVEL_SPAN_LOG2_MAX at which a span of 2^s txns at the
    shape's average load (its writes, and the queries of a span and a
    half) fills at most a quarter of LEVEL_SPAN_CAP (the sweep of s on the
    H100 put the least time there: a larger span runs more levels in
    fewer CTAs); 0 turns the span path off. Levels below s run in a
    span's CTA, the rest as grid passes. `grid_barriers` counts the span
    path's grid barriers, `general_barriers` the general path's (the one
    that any other input takes: shuffled owners, an overfull span); the
    kernel counts the barriers it makes (`level_paths`), and the card
    tests hold the two equal. `span_log2` gives the plan at a forced s."""
    n_levels = max(1, (int(T) - 1).bit_length())
    s = 0
    while (s < min(n_levels, LEVEL_SPAN_LOG2_MAX)
           and (NW + 3 * NR) * (1 << (s + 1)) <= LEVEL_SPAN_CAP // 4 * T):
        s += 1
    if span_log2 is not None:
        s = int(span_log2)
    merge_rounds = max(0, (-(-max(NW, 2 * NR, 1) // 1024) - 1).bit_length())
    return {"n_levels": n_levels, "span_log2": s,
            "spans": (T >> s) + 1 if s else 0,
            "grid_levels": n_levels - s,
            "grid_barriers": 1 + (s < n_levels) + max(0, n_levels - s - 1),
            "general_barriers": 3 + merge_rounds + n_levels - 1,
            "smem_bytes": LEVEL_SMEM_BYTES}


# K9's flag words: two the kernel leaves zero, then its span-path and
# general-path launch counters and the grid barriers of its last launch
LEVEL_FLAG_WORDS = 5


def level_paths(reset: bool = False) -> dict:
    """What K9's launches did, summed over the devices it ran on: how many
    took the span path and how many the general path (since the last
    reset), and the grid barriers of the last launch (one device's). Reads
    the card (a sync); `reset` zeroes the counters after reading."""
    out = {"span": 0, "general": 0, "barriers": 0}
    for (kind, *_rest), buf in _zeroed.items():
        if kind != "levels_flag":
            continue
        span, general, barriers = (int(v) for v in buf[2:].tolist())
        out["span"] += span
        out["general"] += general
        out["barriers"] = barriers
        if reset:
            buf[2:4].zero_()
    return out


def intra_levels(T, wtxn_c, rtxn, rbr, rer, wbr, wer, *,
                 span_log2: int | None = None) -> dict:
    """The scan evaluator's level geometry, every level in one cooperative
    launch: {src, is_w, werl, bnd: (n_levels, M); qlo, qhi: (n_levels,
    NR)}, equal to `conflict_ref.intra_levels` (the total order). The
    kernel picks its path on the card from the owners; `span_log2` (s in
    0..n_levels, 0 for the general path) overrides `level_plan`'s."""
    if not _on_cuda("intra_levels", wbr):
        return ref.intra_levels(T, wtxn_c, rtxn, rbr, rer, wbr, wer)
    NW, NR = wbr.shape[0], rbr.shape[0]
    M = NW + 2 * NR
    T = int(T)
    dev = wbr.device
    if T < 1:
        raise FDBError("invalid_option", f"intra_levels: T={T} < 1")
    _check("intra_levels", dev, wtxn_c=(wtxn_c, _I32, (NW,)),
           rtxn=(rtxn, _I32, (NR,)), rbr=(rbr, _I32, (NR,)),
           rer=(rer, _I32, (NR,)), wbr=(wbr, _I32, (NW,)),
           wer=(wer, _I32, (NW,)))
    n_levels = max(1, (T - 1).bit_length())
    lm, lq = (n_levels, M), (n_levels, NR)
    out = {"src": torch.empty(lm, dtype=_I32, device=dev),
           "is_w": torch.empty(lm, dtype=_BOOL, device=dev),
           "werl": torch.empty(lm, dtype=_I32, device=dev),
           "bnd": torch.empty(lm, dtype=_BOOL, device=dev),
           "qlo": torch.empty(lq, dtype=_I32, device=dev),
           "qhi": torch.empty(lq, dtype=_I32, device=dev)}
    if M == 0:
        return out
    keys = _scratch("levels_keys", 2 * M, torch.int64, dev)
    owners = _scratch("levels_owners", 2 * M, _I32, dev)
    counts = _scratch("levels_counts", 2 * (T + 2), _I32, dev)
    sync = _zeroed_scratch("levels_sync", 1, _I32, dev)
    flag = _zeroed_scratch("levels_flag", LEVEL_FLAG_WORDS, _I32, dev)
    rc = library().fdb_intra_levels(
        wtxn_c.data_ptr(), rtxn.data_ptr(), rbr.data_ptr(), rer.data_ptr(),
        wbr.data_ptr(), wer.data_ptr(), T, NW, NR, n_levels,
        level_plan(T, NW, NR)["span_log2"] if span_log2 is None
        else int(span_log2), keys.data_ptr(),
        owners.data_ptr(), counts.data_ptr(), sync.data_ptr(),
        flag.data_ptr(), out["src"].data_ptr(), out["is_w"].data_ptr(),
        out["werl"].data_ptr(), out["bnd"].data_ptr(), out["qlo"].data_ptr(),
        out["qhi"].data_ptr(), _stream())
    _launched("intra_levels", rc)
    return out


# ---------------------------------------------------------------------------
# K3 intra_sandwich
# ---------------------------------------------------------------------------

# CTAs the sandwich's aggregate scratch has room for (SAND_MAX_GRID)
SANDWICH_MAX_GRID = 1024


def intra_sandwich(g, geo, wtxn_c, w_ok, r_ok, rtxn, rbr, rounds: int,
                   evals=None):
    """The whole sandwich of the scan evaluator (see conflict_ref):
    (lower, upper, converged), in one cooperative launch. With `evals` (a
    0-dim int32 tensor) the number of evaluations of f that ran is written
    there."""
    if not _on_cuda("intra_sandwich", g):
        return ref.intra_sandwich(g, geo, wtxn_c, w_ok, r_ok, rtxn, rbr,
                                  rounds, evals)
    n_levels, M = geo["src"].shape
    T = g.shape[0]
    NW, NR = wtxn_c.shape[0], rtxn.shape[0]
    dev = g.device
    if M != NW + 2 * NR:
        raise FDBError("invalid_option",
                       f"intra_sandwich: M={M} is not NW + 2 NR "
                       f"(NW={NW}, NR={NR})")
    lm, lq = (n_levels, M), (n_levels, NR)
    _check("intra_sandwich", dev, g=(g, _BOOL, (T,)),
           src=(geo["src"], _I32, lm), is_w=(geo["is_w"], _BOOL, lm),
           werl=(geo["werl"], _I32, lm), bnd=(geo["bnd"], _BOOL, lm),
           qlo=(geo["qlo"], _I32, lq), qhi=(geo["qhi"], _I32, lq),
           wtxn_c=(wtxn_c, _I32, (NW,)), w_ok=(w_ok, _BOOL, (NW,)),
           r_ok=(r_ok, _BOOL, (NR,)), rtxn=(rtxn, _I32, (NR,)),
           rbr=(rbr, _I32, (NR,)))
    if evals is None:
        evals = torch.empty((), dtype=_I32, device=dev)
    else:
        _check("intra_sandwich", dev, evals=(evals, _I32, ()))
    rec = _scratch("sandwich_rec", 2 * n_levels * M, _I32, dev)
    agg = _scratch("sandwich_agg", 4 * SANDWICH_MAX_GRID, _I32, dev)
    slots = _scratch("sandwich_slots", 2 * n_levels * NR, _I32, dev)
    bits = _scratch("sandwich_bits", 2 * (-(-T // 32)), _I32, dev)
    marks = _zeroed_scratch("sandwich_marks", 2 * (-(-T // 32)), _I32, dev)
    sync = _zeroed_scratch("sandwich_sync", 2, _I32, dev)
    differ = _zeroed_scratch("sandwich_differ", 3, _I32, dev)
    out = torch.empty(2 * T + 1, dtype=_BOOL, device=dev)
    rc = library().fdb_intra_sandwich(
        g.data_ptr(), geo["src"].data_ptr(), geo["is_w"].data_ptr(),
        geo["werl"].data_ptr(), geo["bnd"].data_ptr(), geo["qlo"].data_ptr(),
        geo["qhi"].data_ptr(), wtxn_c.data_ptr(), w_ok.data_ptr(),
        r_ok.data_ptr(), rtxn.data_ptr(), rbr.data_ptr(), n_levels, T, M, NR,
        int(rounds), rec.data_ptr(), agg.data_ptr(), slots.data_ptr(),
        bits.data_ptr(), marks.data_ptr(), sync.data_ptr(),
        differ.data_ptr(), out[:T].data_ptr(),
        out[T:2 * T].data_ptr(), out[2 * T].data_ptr(), evals.data_ptr(),
        _stream())
    _launched("intra_sandwich", rc)
    return out[:T], out[T:2 * T], out[2 * T]


# ---------------------------------------------------------------------------
# K4 merge_compact
# ---------------------------------------------------------------------------

# elements per tile of the merge scan and int32 per tile descriptor
# (SCAN_TILE and DESC_WORDS in the source)
MERGE_TILE = 2048
MERGE_DESC_WORDS = 24


def merge_compact(skeys, scls, sval, sidx, spos, merge_commit, wb, we, wtxn,
                  nb, oldest, poisoned, vnew, advance_floor, *, K: int,
                  max_write_life: int, out=None):
    """Merge, window GC, coalesce and compaction to K slots:
    (keys (L,K), vals (K,), nb, oldest, poisoned, boundaries); with `out`
    = (keys, vals) those two are written there (the kernel reads the sorted
    union, never the state's keys or values, so the state's own buffers may
    be given). nb, oldest and poisoned are read by every CTA, so they are
    always new tensors."""
    if not _on_cuda("merge_compact", skeys):
        return ref.merge_compact(
            skeys, scls, sval, sidx, spos, merge_commit, wb, we, wtxn, nb,
            oldest, poisoned, vnew, advance_floor, K=K,
            max_write_life=max_write_life, out=out)
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
    n_tiles = -(-N // MERGE_TILE)
    desc = _scratch("merge_desc", MERGE_DESC_WORDS * n_tiles + 1, _I32, dev)
    delta = _zeroed_scratch("merge_delta", N, _I32, dev)
    csrc = _scratch("merge_csrc", K, _I32, dev)
    if out is None:
        out_keys = torch.empty((L, K), dtype=_I32, device=dev)
        out_vals = torch.empty(K, dtype=_I32, device=dev)
    else:
        out_keys, out_vals = out
        _check("merge_compact", dev, out_keys=(out_keys, _I32, (L, K)),
               out_vals=(out_vals, _I32, (K,)))
    nb_out = torch.empty((), dtype=_I32, device=dev)
    oldest_out = torch.empty((), dtype=_I32, device=dev)
    poisoned_out = torch.empty((), dtype=_BOOL, device=dev)
    boundaries = torch.empty((), dtype=_I32, device=dev)
    rc = library().fdb_merge_compact(
        skeys.data_ptr(), scls.data_ptr(), sval.data_ptr(), sidx.data_ptr(),
        spos.data_ptr(), merge_commit.data_ptr(), wb.data_ptr(),
        we.data_ptr(), wtxn.data_ptr(), nb.data_ptr(), oldest.data_ptr(),
        poisoned.data_ptr(), vnew.data_ptr(), advance_floor.data_ptr(), L, N,
        K, NR, NW, T, int(max_write_life), desc.data_ptr(), delta.data_ptr(),
        csrc.data_ptr(), out_keys.data_ptr(), out_vals.data_ptr(),
        nb_out.data_ptr(), oldest_out.data_ptr(), poisoned_out.data_ptr(),
        boundaries.data_ptr(), _stream())
    _launched("merge_compact", rc)
    return out_keys, out_vals, nb_out, oldest_out, poisoned_out, boundaries


# ---------------------------------------------------------------------------
# K5 legacy_blocked
# ---------------------------------------------------------------------------

# reads and writes a tile of K5, and the T-bit sets it rotates (LG_RCHUNK,
# LG_WCHUNK and LG_BITSETS in the source)
LEGACY_TILE_READS = 512
LEGACY_TILE_WRITES = 256
LEGACY_BITSETS = 4


def _legacy(c, g, wtxn, rtxn, w_ok, r_ok, wbr, wer, rbr, rer, fixpoint,
            evals, max_bodies=None):
    """K5's launch: one evaluation of f on c, or the fixpoint from g.
    Returns (out (T,) bool, converged () bool)."""
    T = g.shape[0]
    NW, NR = wtxn.shape[0], rtxn.shape[0]
    dev = g.device
    max_bodies = ref.legacy_guard(T) if max_bodies is None else max_bodies
    if T < 1 or max_bodies < 1:
        raise FDBError("invalid_option",
                       f"legacy_blocked: T={T}, max_bodies={max_bodies}")
    _check("legacy_blocked", dev, c=(c, _BOOL, (T,)), g=(g, _BOOL, (T,)),
           wtxn=(wtxn, _I32, (NW,)), rtxn=(rtxn, _I32, (NR,)),
           w_ok=(w_ok, _BOOL, (NW,)), r_ok=(r_ok, _BOOL, (NR,)),
           wbr=(wbr, _I32, (NW,)), wer=(wer, _I32, (NW,)),
           rbr=(rbr, _I32, (NR,)), rer=(rer, _I32, (NR,)))
    if evals is not None:
        _check("legacy_blocked", dev, evals=(evals, _I32, ()))
    words = -(-T // 32)
    # the bit sets, then a tile ticket a bit set
    marks = _zeroed_scratch("legacy_marks", LEGACY_BITSETS * (words + 1),
                            _I32, dev)
    bounds = _scratch("legacy_bounds", -(-NR // LEGACY_TILE_READS)
                      + -(-NW // LEGACY_TILE_WRITES), _I32, dev)
    sync = _zeroed_scratch("legacy_sync", 1, _I32, dev)
    out = torch.empty(T + 1, dtype=_BOOL, device=dev)
    rc = library().fdb_legacy_overlap(
        c.data_ptr(), g.data_ptr(), wtxn.data_ptr(), rtxn.data_ptr(),
        w_ok.data_ptr(), r_ok.data_ptr(), wbr.data_ptr(), wer.data_ptr(),
        rbr.data_ptr(), rer.data_ptr(), T, NW, NR, int(fixpoint),
        int(max_bodies), marks.data_ptr(), bounds.data_ptr(), sync.data_ptr(),
        out.data_ptr(), out[T].data_ptr(),
        None if evals is None else evals.data_ptr(), _stream())
    _launched("legacy_blocked", rc)
    return out[:T], out[T]


def legacy_sweep(c, g, wtxn, rtxn, w_ok, r_ok, wbr, wer, rbr, rer):
    """One evaluation of the legacy evaluator's map f (see conflict_ref),
    without the (NW, NR) matrix: K5 for a single pass."""
    if not _on_cuda("legacy_blocked", c):
        return ref.legacy_sweep(c, g, wtxn, rtxn, w_ok, r_ok, wbr, wer, rbr,
                                rer)
    return _legacy(c, g, wtxn, rtxn, w_ok, r_ok, wbr, wer, rbr, rer, False,
                   None)[0]


def legacy_fixpoint(g, wtxn, rtxn, w_ok, r_ok, wbr, wer, rbr, rer,
                    evals=None, max_bodies=None):
    """The legacy evaluator's whole fixpoint (`conflict_ref.run_legacy`
    over `legacy_sweep`) in one cooperative launch: (commit (T,) bool,
    converged () bool). converged is False only if the loop reached its
    guard of `max_bodies` bodies (default `conflict_ref.legacy_guard(T)`,
    which a monotone map never reaches); the engine raises on it. With
    `evals` (a 0-dim int32 tensor) the evaluations of f that ran are
    written there."""
    if not _on_cuda("legacy_blocked", g):
        return ref.legacy_fixpoint(g, wtxn, rtxn, w_ok, r_ok, wbr, wer, rbr,
                                   rer, evals, max_bodies)
    return _legacy(g, g, wtxn, rtxn, w_ok, r_ok, wbr, wer, rbr, rer, True,
                   evals, max_bodies)


# ---------------------------------------------------------------------------
# K10 shard_clip, K11 shard_combine (the sharded engine)
# ---------------------------------------------------------------------------

# the widest key the clip takes in registers and the most shards the
# combine's launch parameters carry (CLIP_MAX_L, COMBINE_MAX_SHARDS)
CLIP_MAX_LIMBS = 17
COMBINE_MAX_SHARDS = 64


def clip_ranges(rb, re, wb, we, lo, hi, out=None):
    """K10: every range clipped to every shard's [lo, hi): four (W, L, N)
    int32 tensors (rb', re', wb', we'), as `conflict_ref.clip_ranges`;
    with `out` (four such tensors) written there."""
    if not _on_cuda("shard_clip", rb):
        return ref.clip_ranges(rb, re, wb, we, lo, hi, out=out)
    L, NR = rb.shape
    NW = wb.shape[1]
    W = lo.shape[0]
    dev = rb.device
    if not 1 <= L <= CLIP_MAX_LIMBS or W < 1:
        raise FDBError("invalid_option",
                       f"shard_clip: L={L} (at most {CLIP_MAX_LIMBS}), "
                       f"W={W} (at least 1)")
    _check("shard_clip", dev, rb=(rb, _I32, (L, NR)), re=(re, _I32, (L, NR)),
           wb=(wb, _I32, (L, NW)), we=(we, _I32, (L, NW)),
           lo=(lo, _I32, (W, L)), hi=(hi, _I32, (W, L)))
    if out is None:
        outs = tuple(torch.empty((W, L, n), dtype=_I32, device=dev)
                     for n in (NR, NR, NW, NW))
    else:
        outs = tuple(out)
        _check("shard_clip", dev, **{
            f"out[{i}]": (o, _I32, (W, L, n))
            for i, (o, n) in enumerate(zip(outs, (NR, NR, NW, NW)))})
    if NR + NW == 0:
        return outs
    rc = library().fdb_shard_clip(
        rb.data_ptr(), re.data_ptr(), wb.data_ptr(), we.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), L, NR, NW, W,
        *(o.data_ptr() for o in outs), _stream())
    _launched("shard_clip", rc)
    return outs


def shard_combine(statuses, eligible, overflow, boundaries, converged,
                  txn_valid):
    """K11: the W shards' outputs (sequences of W tensors) combined into
    (statuses, info, row) in one launch, as `conflict_ref.shard_combine`:
    row the (2T+2,) int32 readback row [statuses | eligible | overflow |
    converged], statuses a view of its head."""
    if not _on_cuda("shard_combine", txn_valid):
        return ref.shard_combine(statuses, eligible, overflow, boundaries,
                                 converged, txn_valid)
    W, T = len(statuses), txn_valid.shape[0]
    dev = txn_valid.device
    if not 1 <= W <= COMBINE_MAX_SHARDS or T < 1:
        raise FDBError("invalid_option",
                       f"shard_combine: W={W} shards (1 to "
                       f"{COMBINE_MAX_SHARDS}), T={T} txns (at least 1)")
    groups = (statuses, eligible, overflow, boundaries, converged)
    if any(len(g) != W for g in groups):
        raise FDBError("invalid_option",
                       "shard_combine: every field needs one tensor a shard")
    specs = ((_I32, (T,)), (_BOOL, (T,)), (_BOOL, ()), (_I32, ()),
             (_BOOL, ()))
    _check("shard_combine", dev, txn_valid=(txn_valid, _BOOL, (T,)),
           **{f"{field}[{d}]": (t, dtype, shape)
              for field, g, (dtype, shape) in zip(
                  ("statuses", "eligible", "overflow", "boundaries",
                   "converged"), groups, specs)
              for d, t in enumerate(g)})
    ptrs = (ctypes.c_void_p * (5 * W))(*(t.data_ptr() for g in groups
                                         for t in g))
    scratch = _zeroed_scratch("combine", 2, _I32, dev)
    # the row, then boundaries and committed
    words = torch.empty(2 * T + 4, dtype=_I32, device=dev)
    # eligible, then overflow and converged
    flags = torch.empty(T + 2, dtype=_BOOL, device=dev)
    rc = library().fdb_shard_combine(
        ptrs, W, T, txn_valid.data_ptr(), scratch.data_ptr(),
        words.data_ptr(), flags.data_ptr(), words[2 * T + 2].data_ptr(),
        flags[T].data_ptr(), _stream())
    _launched("shard_combine", rc)
    row = words[:2 * T + 2]
    return row[:T], {"overflow": flags[T], "boundaries": words[2 * T + 2],
                     "committed": words[2 * T + 3], "converged": flags[T + 1],
                     "eligible": flags[:T]}, row


# ---------------------------------------------------------------------------
# K12 step_masks, K13 step_verdicts (the step's glue)
# ---------------------------------------------------------------------------

def step_masks(rb, wb, rtxn, wtxn, rbr, rer, wbr, wer, T: int,
               strided: bool):
    """K12: (rtxn, wtxn, wtxn_c, r_ok, w_ok) in one launch, as
    `conflict_ref.step_masks` (in the strided layout the maps come from
    the keys and the given rtxn / wtxn are not read)."""
    if not _on_cuda("step_masks", rb):
        return ref.step_masks(rb, wb, rtxn, wtxn, rbr, rer, wbr, wer, T,
                              strided)
    L, NR = rb.shape
    NW = wb.shape[1]
    T = int(T)
    dev = rb.device
    if T < 1 or (strided and (NR % T or NW % T)):
        raise FDBError("invalid_option",
                       f"step_masks: T={T}, NR={NR}, NW={NW} (strided "
                       f"needs both multiples of T)")
    _check("step_masks", dev, rb=(rb, _I32, (L, NR)), wb=(wb, _I32, (L, NW)),
           rtxn=(rtxn, _I32, (NR,)), wtxn=(wtxn, _I32, (NW,)),
           rbr=(rbr, _I32, (NR,)), rer=(rer, _I32, (NR,)),
           wbr=(wbr, _I32, (NW,)), wer=(wer, _I32, (NW,)))
    owners = torch.empty(NR + 2 * NW, dtype=_I32, device=dev)
    oks = torch.empty(NR + NW, dtype=_BOOL, device=dev)
    out = (owners[:NR], owners[NR:NR + NW], owners[NR + NW:], oks[:NR],
           oks[NR:])
    if NR + NW == 0:
        return out
    rc = library().fdb_step_masks(
        rb.data_ptr(), wb.data_ptr(), rtxn.data_ptr(), wtxn.data_ptr(),
        rbr.data_ptr(), rer.data_ptr(), wbr.data_ptr(), wer.data_ptr(), L,
        NR, NW, T, int(bool(strided)), *(t.data_ptr() for t in out),
        _stream())
    _launched("step_masks", rc)
    return out


def step_verdicts(commit, too_old, txn_valid, eligible, overflow, converged,
                  scan_out=None, index: int = 0):
    """K13: (statuses (T,) int32, committed () int32, row (2T+2,) int32) in
    one launch of one thread-block cluster (past T = 32,768 a grid of
    clusters, cluster 0 counting), as `conflict_ref.step_verdicts`;
    with `scan_out` it also writes entry `index` of the scan's (statuses,
    committed, overflow)."""
    if not _on_cuda("step_verdicts", commit):
        return ref.step_verdicts(commit, too_old, txn_valid, eligible,
                                 overflow, converged, scan_out, index)
    T = commit.shape[0]
    dev = commit.device
    if T < 1:
        raise FDBError("invalid_option", "step_verdicts: T=0")
    _check("step_verdicts", dev, commit=(commit, _BOOL, (T,)),
           too_old=(too_old, _BOOL, (T,)), txn_valid=(txn_valid, _BOOL, (T,)),
           eligible=(eligible, _BOOL, (T,)), overflow=(overflow, _BOOL, ()),
           converged=(converged, _BOOL, ()))
    scan_ptrs = (None, None, None)
    if scan_out is not None:
        st, comm, ovf = scan_out
        M = st.shape[0]
        _check("step_verdicts", dev, scan_statuses=(st, torch.int8, (M, T)),
               scan_committed=(comm, _I32, (M,)),
               scan_overflow=(ovf, _BOOL, (M,)))
        if not 0 <= index < M:
            raise FDBError("invalid_option",
                           f"step_verdicts: index {index} not in [0, {M})")
        scan_ptrs = (st[index].data_ptr(), comm[index].data_ptr(),
                     ovf[index].data_ptr())
    row = torch.empty(2 * T + 2, dtype=_I32, device=dev)
    committed = torch.empty((), dtype=_I32, device=dev)
    rc = library().fdb_step_verdicts(
        commit.data_ptr(), too_old.data_ptr(), txn_valid.data_ptr(),
        eligible.data_ptr(), overflow.data_ptr(), converged.data_ptr(), T,
        row.data_ptr(), committed.data_ptr(), *scan_ptrs, _stream())
    _launched("step_verdicts", rc)
    return row[:T], committed, row


PHASES = SimpleNamespace(sort_and_rank=sort_and_rank, step_masks=step_masks,
                         build_table=build_table, history_check=history_check,
                         intra_levels=intra_levels,
                         intra_sandwich=intra_sandwich,
                         merge_compact=merge_compact,
                         legacy_fixpoint=legacy_fixpoint,
                         step_verdicts=step_verdicts,
                         rebase_table=rebase_table,
                         clip_ranges=clip_ranges, shard_combine=shard_combine)
