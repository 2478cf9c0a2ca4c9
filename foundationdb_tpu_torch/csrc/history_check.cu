// K2 history_check: too-old and history verdicts per transaction.
//
// Replaces: foundationdb_tpu/ops/conflict.py `conflict_step` phases 1-2
// (:423-444) with `_range_max` (:163-169), part of the jitted XLA step.
// For each read r of txn t = rtxn[r] (t == T marks padding):
//   i0 = max(cum_state[spos[K + r]] - 1, 0)       segment holding the begin
//   i1 = max(cum_state[spos[K + NR + r]], i0 + 1)  first boundary >= end
//   hit = rb < re  and  max(vals[i0 .. i1)) > snapshot[t]
// with the O(1) range max from two sparse-table entries; hits and "has a
// read" fold to their txn by atomic OR. The last block to finish then
// writes, per txn, too_old = valid & has_reads & snapshot < oldest and
// g0 = valid & ~too_old & ~hit, and clears the scratch for the next call.
//
// Bound on H100: bytes, and mostly latency. Per read it gathers 2 spos,
// 2 cum_state, 2 table entries and 2L key limbs (~90 B at L = 7: 0.4 MB at
// NR = 4,096, ~0.1 us of HBM time); one thread per read keeps every gather
// independent, so the kernel is a handful of dependent memory latencies.
#include "common.cuh"

__global__ void history_kernel(
    const int32_t* __restrict__ table, int K, const int32_t* __restrict__ cum_state,
    const int32_t* __restrict__ spos, const int32_t* __restrict__ rb,
    const int32_t* __restrict__ re, int L, int NR,
    const int32_t* __restrict__ rtxn, const int32_t* __restrict__ snapshot,
    const uint8_t* __restrict__ txn_valid, const int32_t* __restrict__ oldest,
    int T, int32_t* scratch, unsigned int* counter, uint8_t* too_old,
    uint8_t* g0) {
  int32_t* has_reads = scratch;
  int32_t* hist = scratch + T;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < NR) {
    const int t = rtxn[r];
    if (t < T) {
      atomicOr(&has_reads[t], 1);
      if (fdb_key_lt(rb, re, L, NR, r)) {
        const int ub = cum_state[spos[K + r]];
        const int lb = cum_state[spos[K + NR + r]];
        const int i0 = max(ub - 1, 0);
        const int i1 = max(lb, i0 + 1);
        const int w = i1 - i0;
        const int lvl = 31 - __clz(w);
        const int32_t* row = table + (long long)lvl * K;
        const int32_t mv = max(row[i0], row[max(i1 - (1 << lvl), i0)]);
        if (mv > snapshot[t]) atomicOr(&hist[t], 1);
      }
    }
  }
  // last block to arrive folds the per-txn verdicts
  __shared__ bool am_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) am_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!am_last) return;
  __threadfence();
  const int32_t old = *oldest;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const bool valid = txn_valid[t];
    const bool to = valid && __ldcg(&has_reads[t]) && snapshot[t] < old;
    too_old[t] = to;
    g0[t] = valid && !to && !__ldcg(&hist[t]);
    has_reads[t] = 0;
    hist[t] = 0;
  }
  if (threadIdx.x == 0) *counter = 0;
}

// scratch: 2*T int32 and counter: 1 uint32, both zero on entry; the kernel
// leaves them zero again.
extern "C" int fdb_history_check(
    const int32_t* table, int K, const int32_t* cum_state, const int32_t* spos,
    const int32_t* rb, const int32_t* re, int L, int NR, const int32_t* rtxn,
    const int32_t* snapshot, const uint8_t* txn_valid, const int32_t* oldest,
    int T, int32_t* scratch, unsigned int* counter, uint8_t* too_old,
    uint8_t* g0, void* stream) {
  const int threads = 256;
  const int blocks = NR > 0 ? (NR + threads - 1) / threads : 1;
  history_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      table, K, cum_state, spos, rb, re, L, NR, rtxn, snapshot, txn_valid,
      oldest, T, scratch, counter, too_old, g0);
  return (int)cudaGetLastError();
}
