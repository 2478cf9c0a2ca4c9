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
// kernel copies prev to out instead, so the host never reads the flag.
//
// Bound on H100: latency of the block-wide scans. Per evaluation it reads
// about 10 B per level element plus 12 B per read and level (~1.7 MB at
// M = 12,288, NR = 4,096, 10 levels: ~0.5 us of HBM time) and writes T
// bytes; the work is O(levels * (M + NR)) integer ops. Design: one block
// per level; the two scans run as one fused scan over (sum, max, reset)
// in registers, four elements a thread, with the prefix carried across
// tiles, into shared memory (2 * M int32, dynamic); the queries then read
// shared memory only. Ten blocks leave most SMs idle: a later PR splits
// levels across blocks with a decoupled look-back.
#include "common.cuh"

#define SWEEP_THREADS 1024
#define SWEEP_IPT 4

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

__global__ void __launch_bounds__(SWEEP_THREADS)
intra_sweep_kernel(const uint8_t* __restrict__ c, const uint8_t* __restrict__ g,
                   const int32_t* __restrict__ src,
                   const uint8_t* __restrict__ is_w,
                   const int32_t* __restrict__ werl,
                   const uint8_t* __restrict__ bnd,
                   const int32_t* __restrict__ qlo,
                   const int32_t* __restrict__ qhi,
                   const int32_t* __restrict__ wtxn_c,
                   const uint8_t* __restrict__ w_ok,
                   const uint8_t* __restrict__ r_ok,
                   const int32_t* __restrict__ rtxn,
                   const int32_t* __restrict__ rbr, const uint8_t* skip,
                   const uint8_t* prev, int T, int M, int NR,
                   int32_t* marks, unsigned int* counter, uint8_t* out) {
  extern __shared__ int32_t smem[];
  int32_t* pref = smem;        // [M]
  int32_t* segmax = smem + M;  // [M]
  __shared__ SweepElem sh_scan[32];
  __shared__ bool am_last;

  if (skip != nullptr && *skip) {
    if (blockIdx.x == 0)
      for (int t = threadIdx.x; t < T; t += blockDim.x) out[t] = prev[t];
    return;
  }
  const long long lvl_off = (long long)blockIdx.x * M;
  const SweepOp op;
  const SweepElem id = {0, INT_MIN, 0};
  SweepElem carry = id;
  const int tile = SWEEP_THREADS * SWEEP_IPT;
  for (int base = 0; base < M; base += tile) {
    SweepElem e[SWEEP_IPT];
    SweepElem agg = id;
    const int i0 = base + threadIdx.x * SWEEP_IPT;
#pragma unroll
    for (int k = 0; k < SWEEP_IPT; ++k) {
      const int i = i0 + k;
      e[k] = id;
      if (i < M) {
        const long long gi = lvl_off + i;
        bool cm = false;
        if (is_w[gi]) {
          const int s = src[gi];
          cm = w_ok[s] && c[wtxn_c[s]];
        }
        e[k] = {cm ? 1 : 0, cm ? werl[gi] : -1, bnd[gi] ? 1 : 0};
      }
      agg = op(agg, e[k]);
    }
    SweepElem total;
    SweepElem run = op(carry,
                       fdb_block_exclusive_scan(agg, op, id, sh_scan, &total));
#pragma unroll
    for (int k = 0; k < SWEEP_IPT; ++k) {
      const int i = i0 + k;
      run = op(run, e[k]);
      if (i < M) {
        pref[i] = run.sum;
        segmax[i] = run.mv;
      }
    }
    carry = op(carry, total);
  }
  __syncthreads();

  const long long q_off = (long long)blockIdx.x * NR;
  for (int j = threadIdx.x; j < NR; j += blockDim.x) {
    if (!r_ok[j]) continue;
    const int lo = qlo[q_off + j], hi = qhi[q_off + j];
    if (pref[hi] - pref[lo] > 0 || segmax[lo] > rbr[j])
      atomicOr(&marks[rtxn[j]], 1);
  }

  // the last block to arrive folds the marks into the new committed set
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) am_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!am_last) return;
  __threadfence();
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    out[t] = g[t] && !__ldcg(&marks[t]);
    marks[t] = 0;
  }
  if (threadIdx.x == 0) *counter = 0;
}

// marks: T int32 and counter: 1 uint32, both zero on entry; the kernel
// leaves them zero again. skip and prev may both be null (no round skip).
extern "C" int fdb_intra_sweep(
    const uint8_t* c, const uint8_t* g, const int32_t* src, const uint8_t* is_w,
    const int32_t* werl, const uint8_t* bnd, const int32_t* qlo,
    const int32_t* qhi, const int32_t* wtxn_c, const uint8_t* w_ok,
    const uint8_t* r_ok, const int32_t* rtxn, const int32_t* rbr,
    const uint8_t* skip, const uint8_t* prev, int n_levels, int T, int M,
    int NR, int32_t* marks, unsigned int* counter, uint8_t* out,
    void* stream) {
  const size_t smem = 2 * (size_t)M * sizeof(int32_t);
  static size_t smem_allowed = 0;  // bytes opted in so far
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        intra_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  intra_sweep_kernel<<<n_levels, SWEEP_THREADS, smem, (cudaStream_t)stream>>>(
      c, g, src, is_w, werl, bnd, qlo, qhi, wtxn_c, w_ok, r_ok, rtxn, rbr,
      skip, prev, T, M, NR, marks, counter, out);
  return (int)cudaGetLastError();
}
