// K12 step_masks and K13 step_verdicts: the conflict step's elementwise
// glue, each one launch.
//
// Replaces: in foundationdb_tpu/ops/conflict.py `conflict_step`, part of
// the jitted XLA step,
//   K12: the range->txn maps of the strided layout and the intra-batch
//        masks (:385-395, :477-489): rvalid / wvalid from the padding
//        length limb, the strided owner j // (N / T), wtxn_c =
//        min(wtxn, T - 1), r_ok = rvalid & (rbr < rer), w_ok alike;
//   K13: the statuses (:545-553), info["committed"] (:697), the int8
//        statuses, committed and overflow rows of `conflict_scan`
//        (:782-786), and the resolver's readback row, `_combine_fn`
//        (:1190-1198): [statuses | eligible | overflow | converged].
// Both ran as about 25 small torch launches a step.
//
// Bound on H100: the launch. K12 reads at most 12 bytes a range and
// writes 5 (reads) or 9 (writes): 0.2 MB at the kernel bench's
// NR = NW = 16,384, 0.07 us of HBM time. K13 reads 4 and writes 9 bytes a
// txn (0.2 MB at T = 16,384). A launch costs a few microseconds, so each
// is one launch of independent threads, grid-strided, and nothing more.
//
// K13's committed count: each block sums its committed txns (warp sums,
// then one shared counter) and adds the sum to a global counter; the last
// block to finish (an atomic ticket) writes the count and resets both
// counters, so the scratch is zero again for the next launch (as K11
// does). That also holds inside a replayed CUDA graph: every replay finds
// the scratch zero.
#include "common.cuh"

#define GLUE_THREADS 256

__global__ void __launch_bounds__(GLUE_THREADS)
step_masks_kernel(const int32_t* __restrict__ rb,
                  const int32_t* __restrict__ wb,
                  const int32_t* __restrict__ rtxn,
                  const int32_t* __restrict__ wtxn,
                  const int32_t* __restrict__ rbr,
                  const int32_t* __restrict__ rer,
                  const int32_t* __restrict__ wbr,
                  const int32_t* __restrict__ wer, int L, int NR, int NW,
                  int T, int strided, int32_t* __restrict__ rtxn_out,
                  int32_t* __restrict__ wtxn_out,
                  int32_t* __restrict__ wtxn_c, uint8_t* __restrict__ r_ok,
                  uint8_t* __restrict__ w_ok) {
  const long long n = (long long)NR + NW;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (long long)gridDim.x * blockDim.x) {
    if (j < NR) {
      const int r = (int)j;
      int owner;
      if (strided)  // a real key never carries the padding length limb
        owner = rb[(long long)(L - 1) * NR + r] != FDB_PAD_LIMB
                    ? r / (NR / T) : T;
      else
        owner = rtxn[r];
      rtxn_out[r] = owner;
      r_ok[r] = owner < T && rbr[r] < rer[r];
    } else {
      const int w = (int)(j - NR);
      int owner;
      if (strided)
        owner = wb[(long long)(L - 1) * NW + w] != FDB_PAD_LIMB
                    ? w / (NW / T) : T;
      else
        owner = wtxn[w];
      wtxn_out[w] = owner;
      wtxn_c[w] = min(owner, T - 1);
      w_ok[w] = owner < T && wbr[w] < wer[w];
    }
  }
}

__global__ void __launch_bounds__(GLUE_THREADS)
step_verdicts_kernel(const uint8_t* __restrict__ commit,
                     const uint8_t* __restrict__ too_old,
                     const uint8_t* __restrict__ txn_valid,
                     const uint8_t* __restrict__ eligible,
                     const uint8_t* __restrict__ overflow,
                     const uint8_t* __restrict__ converged, int T,
                     unsigned int* scratch, int32_t* __restrict__ row,
                     int32_t* __restrict__ committed,
                     int8_t* __restrict__ scan_statuses,
                     int32_t* __restrict__ scan_committed,
                     uint8_t* __restrict__ scan_overflow) {
  __shared__ unsigned int sh_count;
  if (threadIdx.x == 0) sh_count = 0u;
  __syncthreads();

  unsigned int mine = 0u;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < T;
       t += gridDim.x * blockDim.x) {
    const bool c = commit[t] != 0;
    // Committed 2, TooOld 1, Conflict 0; a txn that is not valid reads
    // Committed
    const int32_t s = (!txn_valid[t] || c) ? 2 : (too_old[t] ? 1 : 0);
    row[t] = s;
    row[T + t] = eligible[t] != 0;
    if (scan_statuses) scan_statuses[t] = (int8_t)s;
    mine += c ? 1u : 0u;
  }
  mine = __reduce_add_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(&sh_count, mine);
  __syncthreads();

  if (threadIdx.x == 0) {
    if (blockIdx.x == 0) {
      const uint8_t ov = *overflow != 0;
      row[2 * T] = ov;
      row[2 * T + 1] = *converged != 0;
      if (scan_overflow) *scan_overflow = ov;
    }
    if (sh_count) atomicAdd(&scratch[0], sh_count);
    __threadfence();
    if (atomicAdd(&scratch[1], 1u) == gridDim.x - 1) {  // the last block
      __threadfence();
      const int32_t count = (int32_t)atomicExch(&scratch[0], 0u);
      scratch[1] = 0u;
      *committed = count;
      if (scan_committed) *scan_committed = count;
    }
  }
}

// A thread per element, at most 8 blocks an SM (grid-strided past that).
static cudaError_t glue_blocks(long long n, int* blocks) {
  int dev = 0;
  FdbDeviceLimits lim;
  const cudaError_t e = fdb_device_limits(&dev, &lim);
  if (e != cudaSuccess) return e;
  long long b = (n + GLUE_THREADS - 1) / GLUE_THREADS;
  const long long cap = (long long)lim.sms * 8;
  if (b > cap) b = cap;
  *blocks = (int)(b < 1 ? 1 : b);
  return cudaSuccess;
}

// One launch on `stream`. In the strided layout NR and NW are multiples of
// T and rtxn / wtxn are not read.
extern "C" int fdb_step_masks(const int32_t* rb, const int32_t* wb,
                              const int32_t* rtxn, const int32_t* wtxn,
                              const int32_t* rbr, const int32_t* rer,
                              const int32_t* wbr, const int32_t* wer, int L,
                              int NR, int NW, int T, int strided,
                              int32_t* rtxn_out, int32_t* wtxn_out,
                              int32_t* wtxn_c, uint8_t* r_ok, uint8_t* w_ok,
                              void* stream) {
  if (T < 1 || L < 1 || NR < 0 || NW < 0 ||
      (strided && (NR % T || NW % T)))
    return (int)cudaErrorInvalidValue;
  if (NR + NW == 0) return (int)cudaSuccess;
  int blocks = 0;
  const cudaError_t e = glue_blocks((long long)NR + NW, &blocks);
  if (e != cudaSuccess) return (int)e;
  step_masks_kernel<<<blocks, GLUE_THREADS, 0, (cudaStream_t)stream>>>(
      rb, wb, rtxn, wtxn, rbr, rer, wbr, wer, L, NR, NW, T, strided, rtxn_out,
      wtxn_out, wtxn_c, r_ok, w_ok);
  return (int)cudaGetLastError();
}

// scratch: 2 uint32, zero on entry and left zero. The scan outputs may be
// null (a lone step); given, they are row i of the (M, T) int8 statuses
// and entry i of the (M,) committed and overflow. One launch on `stream`.
extern "C" int fdb_step_verdicts(const uint8_t* commit, const uint8_t* too_old,
                                 const uint8_t* txn_valid,
                                 const uint8_t* eligible,
                                 const uint8_t* overflow,
                                 const uint8_t* converged, int T,
                                 unsigned int* scratch, int32_t* row,
                                 int32_t* committed, int8_t* scan_statuses,
                                 int32_t* scan_committed,
                                 uint8_t* scan_overflow, void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t e = glue_blocks(T, &blocks);
  if (e != cudaSuccess) return (int)e;
  step_verdicts_kernel<<<blocks, GLUE_THREADS, 0, (cudaStream_t)stream>>>(
      commit, too_old, txn_valid, eligible, overflow, converged, T, scratch,
      row, committed, scan_statuses, scan_committed, scan_overflow);
  return (int)cudaGetLastError();
}
