// K2 history_check: too-old and history verdicts per transaction.
//
// Replaces: foundationdb_tpu/ops/conflict.py `conflict_step` phases 1-2
// (:423-444) with `_range_max` (:163-169), part of the jitted XLA step.
// For each read r of txn t = rtxn[r] (t outside [0, T) marks padding):
//   i0 = max(cum_state[spos[K + r]] - 1, 0)       segment holding the begin
//   i1 = max(cum_state[spos[K + NR + r]], i0 + 1)  first boundary >= end
//   hit = rb < re  and  max(vals[i0 .. i1)) > snapshot[t]
// with the O(1) range max from two sparse-table entries. Per txn:
//   too_old = valid & has_reads & snapshot < oldest
//   g0 = valid & ~too_old & ~(any hit of its reads).
// Any rtxn is valid input: unsorted, repeated, padding anywhere, txns
// without reads. (Both encoders write it nondecreasing; that only makes
// the fold cheaper.)
//
// Bound on H100: bytes, and mostly latency. Per read it gathers 2 spos,
// 2 cum_state, 2 table entries and 2L key limbs (~90 B at L = 7: 0.4 MB at
// NR = 4,096, ~0.1 us of HBM time), so no launch reaches the bound; the
// floor is one launch, a chain of three dependent gathers (spos ->
// cum_state -> table) and the fold.
//
// Design. A fold by the last CTA to finish would loop over all T txns in
// one CTA, ~2.8 us per 1,024 txns on the H100 (0.092 ms at T = 32,768), so
// no CTA loops over T. One cooperative launch, grid-strided, as many CTAs
// as the reads or the txns need and the card holds at once:
//   - read pass: a thread per read, every gather independent across
//     threads. "Has a read" and "hit" fold into two bit sets of ceil(T / 32)
//     words in global scratch: the lanes of a warp whose txns share a word
//     (__match_any_sync) OR their bits together (__reduce_or_sync) and one
//     of them makes the atomicOr, so nondecreasing rtxn costs an atomic per
//     32 reads and any other order is still right;
//   - one grid barrier (common.cuh `fdb_grid_sync`);
//   - txn pass: a warp per word, a thread per txn; it writes too_old and g0
//     and clears the word, so the scratch is zero again for the next launch.
// A refused launch returns its CUDA error, and the Python wrapper raises.
#include "common.cuh"

#define HIST_THREADS 256

__global__ void __launch_bounds__(HIST_THREADS)
history_grid_kernel(const int32_t* __restrict__ table, int K,
                    const int32_t* __restrict__ cum_state,
                    const int32_t* __restrict__ spos,
                    const int32_t* __restrict__ rb,
                    const int32_t* __restrict__ re, int L, int NR,
                    const int32_t* __restrict__ rtxn,
                    const int32_t* __restrict__ snapshot,
                    const uint8_t* __restrict__ txn_valid,
                    const int32_t* __restrict__ oldest, int T,
                    int skip_history, unsigned int* words, unsigned int* sync,
                    uint8_t* __restrict__ too_old, uint8_t* __restrict__ g0) {
  const int W = (T + 31) >> 5;
  unsigned int* has_reads = words;
  unsigned int* hist = words + W;
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;

  // read pass; the trip count is the same for all lanes of a warp, so
  // every lane reaches the warp-wide fold
  for (int base = warp * 32; base < NR; base += n_warps * 32) {
    const int r = base + lane;
    int t = r < NR ? rtxn[r] : -1;
    if ((unsigned)t >= (unsigned)T) t = -1;  // padding
    bool hit = false;
    if (t >= 0) {
      const int ub = cum_state[spos[K + r]];
      const int lb = cum_state[spos[K + NR + r]];
      const int32_t snap = snapshot[t];
      if (!skip_history && fdb_key_lt(rb, re, L, NR, r)) {
        const int i0 = max(ub - 1, 0);
        const int i1 = max(lb, i0 + 1);
        const int lvl = 31 - __clz(i1 - i0);
        const int32_t* row = table + (long long)lvl * K;
        hit = max(row[i0], row[max(i1 - (1 << lvl), i0)]) > snap;
      }
    }
    const int word = t >= 0 ? t >> 5 : -1;
    const unsigned int bit = t >= 0 ? 1u << (t & 31) : 0u;
    const unsigned int peers = __match_any_sync(0xffffffffu, word);
    const unsigned int reads = __reduce_or_sync(peers, bit);
    const unsigned int hits = __reduce_or_sync(peers, hit ? bit : 0u);
    if (word >= 0 && lane == __ffs(peers) - 1) {
      atomicOr(&has_reads[word], reads);
      if (hits) atomicOr(&hist[word], hits);
    }
  }

  fdb_grid_sync(sync);

  // txn pass: word w is read and then cleared by warp w alone
  const int32_t old = *oldest;
  for (int w = warp; w < W; w += n_warps) {
    const unsigned int hr = __ldcg(&has_reads[w]);
    const unsigned int hh = __ldcg(&hist[w]);
    const int t = w * 32 + lane;
    if (t < T) {
      const bool valid = txn_valid[t];
      const bool to = valid && ((hr >> lane) & 1u) && snapshot[t] < old;
      too_old[t] = to;
      g0[t] = valid && !to && !((hh >> lane) & 1u);
    }
    __syncwarp();
    if (lane == 0 && (hr | hh)) {
      has_reads[w] = 0;
      hist[w] = 0;
    }
  }
}

// Co-resident CTAs an SM of each device, read once.
static int g_hist_per_sm[64];

// words: 2 * ceil(T / 32) uint32, zero on entry and left zero; sync: 1
// uint32 whose low 31 bits are zero on entry, and stay so. With
// skip_history set (the `no_hist` and `only_merge` ablations of the JAX
// step, :427-429) the read pass folds "has a read" and no hit. One
// cooperative launch on `stream`.
extern "C" int fdb_history_check(
    const int32_t* table, int K, const int32_t* cum_state, const int32_t* spos,
    const int32_t* rb, const int32_t* re, int L, int NR, const int32_t* rtxn,
    const int32_t* snapshot, const uint8_t* txn_valid, const int32_t* oldest,
    int T, int skip_history, unsigned int* words, unsigned int* sync,
    uint8_t* too_old, uint8_t* g0, void* stream) {
  if (T < 1 || NR < 0) return (int)cudaErrorInvalidValue;
  int dev = 0;
  FdbDeviceLimits lim;
  cudaError_t e = fdb_device_limits(&dev, &lim);
  if (e != cudaSuccess) return (int)e;
  if (g_hist_per_sm[dev] == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &g_hist_per_sm[dev], history_grid_kernel, HIST_THREADS, 0);
    if (e != cudaSuccess) {
      g_hist_per_sm[dev] = 0;
      return (int)e;
    }
    if (g_hist_per_sm[dev] < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  // a thread per read, a warp per word of the bit sets
  const long long W = (T + 31) / 32;
  long long want = ((long long)NR + HIST_THREADS - 1) / HIST_THREADS;
  const long long for_txns = (W * 32 + HIST_THREADS - 1) / HIST_THREADS;
  if (for_txns > want) want = for_txns;
  const long long cap = (long long)lim.sms * g_hist_per_sm[dev];
  const int G = (int)(want < cap ? want : cap);
  void* params[] = {&table, &K,        &cum_state, &spos,   &rb,
                    &re,    &L,        &NR,        &rtxn,   &snapshot,
                    &txn_valid, &oldest, &T,       &skip_history,
                    &words,     &sync,   &too_old, &g0};
  e = cudaLaunchCooperativeKernel((const void*)history_grid_kernel, dim3(G),
                                  dim3(HIST_THREADS), params, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
