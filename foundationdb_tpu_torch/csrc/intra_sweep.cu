// K3 intra_sweep: one evaluation of the "earlier transactions win" map of
// the intra-batch sandwich, over every dyadic level at once.
//
// Replaces: foundationdb_tpu/ops/conflict.py `_intra_scan_blocked`
// (:295-308) with `_seg_cummax` (:227-236) inside `_f_commit` (:537-541),
// which the jitted step evaluates up to 2 * rounds + 1 times per chunk in
// `_run_sandwich` (:311-334). Given the committed set c (T,), with
// cm[i] = is_w[l][i] & c[wtxn_c[src]] & w_ok[src] (src = src[l][i]):
//   case A: pref = inclusive prefix sum of cm; a read j is blocked when
//           pref[qhi[l][j]] - pref[qlo[l][j]] > 0,
//   case B: segmax = running max of (cm ? werl : -1) restarting at bnd;
//           a read j is blocked when segmax[qlo[l][j]] > rbr[j].
// A blocked read with r_ok marks its txn (atomic OR); the last block to
// finish writes out[t] = g[t] & !marked[t] and clears the marks.
// With *skip set (the sandwich has pinched: `lax.cond` of :329), the
// kernels copy prev to out instead, so the host never reads the flag.
//
// Bound on H100: bytes. Per evaluation it reads about 10 B per level
// element plus 12 B per read and level, and writes T bytes (~1.7 MB at
// M = 12,288, NR = 4,096, 10 levels: ~0.5 us of HBM time; ~17 MB at the
// kernel bench's M = 98,304, 15 levels: ~5 us). Design: a grid over
// (tile, level) and a three-step tiled scan of the fused (sum, max, reset)
// monoid, so any M works and every SM has tiles:
//   1. sweep_reduce: each tile of 1,024 elements reduces to its aggregate;
//   2. sweep_scan: each tile folds the aggregates of the tiles before it
//      into its carry, rescans itself and writes the level's prefix arrays
//      (pref and segmax, n_levels x M x 2 int32 of global scratch);
//   3. sweep_answer: one thread per read tests every level and marks its
//      txn; the last block folds the marks.
#include "common.cuh"

#define SWEEP_THREADS 256
#define SWEEP_IPT 4
#define SWEEP_TILE (SWEEP_THREADS * SWEEP_IPT)

struct SweepElem {
  int sum;  // committed writes so far (case A)
  int mv;   // running max of committed write-end ranks (case B)
  int r;    // a segment reset lies in the span
  static __device__ __forceinline__ SweepElem shfl_up(SweepElem x, int d) {
    return {fdb_shfl_up(x.sum, d), fdb_shfl_up(x.mv, d), fdb_shfl_up(x.r, d)};
  }
};
struct SweepOp {
  __device__ __forceinline__ SweepElem operator()(SweepElem a,
                                                  SweepElem b) const {
    return {a.sum + b.sum, b.r ? b.mv : max(a.mv, b.mv), a.r | b.r};
  }
};
__device__ __forceinline__ SweepElem sweep_id() { return {0, INT_MIN, 0}; }

// The level-sorted element gi, as a scan element under the committed set c.
__device__ __forceinline__ SweepElem sweep_elem(
    long long gi, const uint8_t* __restrict__ c,
    const int32_t* __restrict__ src, const uint8_t* __restrict__ is_w,
    const int32_t* __restrict__ werl, const uint8_t* __restrict__ bnd,
    const int32_t* __restrict__ wtxn_c, const uint8_t* __restrict__ w_ok) {
  bool cm = false;
  if (is_w[gi]) {
    const int s = src[gi];
    cm = w_ok[s] && c[wtxn_c[s]];
  }
  return {cm ? 1 : 0, cm ? werl[gi] : -1, bnd[gi] ? 1 : 0};
}

#define SWEEP_ELEM_ARGS                                              \
  const uint8_t *__restrict__ c, const int32_t *__restrict__ src,    \
      const uint8_t *__restrict__ is_w,                              \
      const int32_t *__restrict__ werl,                              \
      const uint8_t *__restrict__ bnd,                               \
      const int32_t *__restrict__ wtxn_c,                            \
      const uint8_t *__restrict__ w_ok

// 1. tile (blockIdx.x) of level (blockIdx.y) -> its aggregate
__global__ void __launch_bounds__(SWEEP_THREADS)
sweep_reduce_kernel(SWEEP_ELEM_ARGS, const uint8_t* skip, int M, int n_tiles,
                    SweepElem* agg) {
  if (skip != nullptr && *skip) return;
  __shared__ SweepElem sh_scan[32];
  const SweepOp op;
  const long long lvl_off = (long long)blockIdx.y * M;
  const int i0 = blockIdx.x * SWEEP_TILE + threadIdx.x * SWEEP_IPT;
  SweepElem acc = sweep_id();
#pragma unroll
  for (int k = 0; k < SWEEP_IPT; ++k)
    if (i0 + k < M)
      acc = op(acc, sweep_elem(lvl_off + i0 + k, c, src, is_w, werl, bnd,
                               wtxn_c, w_ok));
  SweepElem total;
  fdb_block_exclusive_scan(acc, op, sweep_id(), sh_scan, &total);
  if (threadIdx.x == 0) agg[(long long)blockIdx.y * n_tiles + blockIdx.x] = total;
}

// 2. carry from the earlier tiles' aggregates, rescan, write pref/segmax
__global__ void __launch_bounds__(SWEEP_THREADS)
sweep_scan_kernel(SWEEP_ELEM_ARGS, const uint8_t* skip, int M, int n_tiles,
                  const SweepElem* __restrict__ agg, int32_t* prefseg) {
  if (skip != nullptr && *skip) return;
  __shared__ SweepElem sh_scan[32];
  const SweepOp op;
  const int tile = blockIdx.x;
  const SweepElem* lagg = agg + (long long)blockIdx.y * n_tiles;
  SweepElem carry = sweep_id(), total;
  for (int base = 0; base < tile; base += SWEEP_THREADS) {
    const int k = base + threadIdx.x;
    fdb_block_exclusive_scan(k < tile ? lagg[k] : sweep_id(), op, sweep_id(),
                             sh_scan, &total);
    carry = op(carry, total);
  }
  const long long lvl_off = (long long)blockIdx.y * M;
  const int i0 = tile * SWEEP_TILE + threadIdx.x * SWEEP_IPT;
  SweepElem e[SWEEP_IPT];
  SweepElem acc = sweep_id();
#pragma unroll
  for (int k = 0; k < SWEEP_IPT; ++k) {
    e[k] = i0 + k < M ? sweep_elem(lvl_off + i0 + k, c, src, is_w, werl, bnd,
                                   wtxn_c, w_ok)
                      : sweep_id();
    acc = op(acc, e[k]);
  }
  SweepElem run = op(carry, fdb_block_exclusive_scan(acc, op, sweep_id(),
                                                     sh_scan, &total));
  int32_t* pref = prefseg + 2 * lvl_off;
  int32_t* segmax = pref + M;
#pragma unroll
  for (int k = 0; k < SWEEP_IPT; ++k) {
    run = op(run, e[k]);
    if (i0 + k < M) {
      pref[i0 + k] = run.sum;
      segmax[i0 + k] = run.mv;
    }
  }
}

// 3. one thread per read: blocked at any level -> mark its txn; then the
// last block folds the marks into the new committed set
__global__ void __launch_bounds__(SWEEP_THREADS)
sweep_answer_kernel(const uint8_t* __restrict__ g,
                    const int32_t* __restrict__ qlo,
                    const int32_t* __restrict__ qhi,
                    const uint8_t* __restrict__ r_ok,
                    const int32_t* __restrict__ rtxn,
                    const int32_t* __restrict__ rbr, const uint8_t* skip,
                    const uint8_t* prev, int n_levels, int T, int M, int NR,
                    const int32_t* __restrict__ prefseg, int32_t* marks,
                    unsigned int* counter, uint8_t* out) {
  if (skip != nullptr && *skip) {  // the same for every block
    for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < T;
         t += gridDim.x * blockDim.x)
      out[t] = prev[t];
    return;
  }
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < NR && r_ok[j]) {
    const int rb = rbr[j];
    for (int l = 0; l < n_levels; ++l) {
      const int32_t* pref = prefseg + 2LL * l * M;
      const int lo = qlo[(long long)l * NR + j];
      const int hi = qhi[(long long)l * NR + j];
      if (pref[hi] - pref[lo] > 0 || pref[M + lo] > rb) {
        atomicOr(&marks[rtxn[j]], 1);
        break;
      }
    }
  }
  fdb_fold_marks_last_block(g, marks, counter, out, T);
}

// agg: n_levels * ceil(M / 1024) * 3 int32 and prefseg: n_levels * M * 2
// int32, both overwritten; marks: T int32 and counter: 1 uint32, both zero
// on entry and left zero again. skip and prev may both be null (no round
// skip). Three launches on `stream`.
extern "C" int fdb_intra_sweep(
    const uint8_t* c, const uint8_t* g, const int32_t* src, const uint8_t* is_w,
    const int32_t* werl, const uint8_t* bnd, const int32_t* qlo,
    const int32_t* qhi, const int32_t* wtxn_c, const uint8_t* w_ok,
    const uint8_t* r_ok, const int32_t* rtxn, const int32_t* rbr,
    const uint8_t* skip, const uint8_t* prev, int n_levels, int T, int M,
    int NR, int32_t* agg, int32_t* prefseg, int32_t* marks,
    unsigned int* counter, uint8_t* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = (M + SWEEP_TILE - 1) / SWEEP_TILE;
  const dim3 grid(n_tiles, n_levels);
  SweepElem* aggs = reinterpret_cast<SweepElem*>(agg);
  sweep_reduce_kernel<<<grid, SWEEP_THREADS, 0, s>>>(
      c, src, is_w, werl, bnd, wtxn_c, w_ok, skip, M, n_tiles, aggs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sweep_scan_kernel<<<grid, SWEEP_THREADS, 0, s>>>(
      c, src, is_w, werl, bnd, wtxn_c, w_ok, skip, M, n_tiles, aggs, prefseg);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int blocks = NR > 0 ? (NR + SWEEP_THREADS - 1) / SWEEP_THREADS : 1;
  sweep_answer_kernel<<<blocks, SWEEP_THREADS, 0, s>>>(
      g, qlo, qhi, r_ok, rtxn, rbr, skip, prev, n_levels, T, M, NR, prefseg,
      marks, counter, out);
  return (int)cudaGetLastError();
}
