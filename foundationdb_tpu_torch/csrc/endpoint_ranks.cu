// K8 endpoint_ranks: the dense rank of each batch endpoint's key among
// all 2NR + 2NW endpoint keys, written at its endpoint index.
//
// Replaces: the endpoint ranks of foundationdb_tpu/ops/conflict.py
// `conflict_step` (:455-476): group starts over the sorted union, an
// exclusive count of batch elements, and two carried `cummax` scans over
// all N = K + 2NR + 2NW sorted elements. A state element "interleaves but
// contributes no rank", and the class does not enter the rank, so the rank
// of an endpoint is the number of key changes up to it in the sorted
// endpoints alone (K6's output): one inclusive sum over M = 2NR + 2NW
// flags, minus one.
//
// One cooperative launch, every CTA resident, each owning tiles of 512
// endpoints (one tile a CTA at every main-path shape):
//  1. each thread flags the key changes of the endpoints t, t + 256, ...
//     of its tile against the one before (every limb loaded before any is
//     compared, so a thread's loads issue together and a warp's are
//     coalesced; the key before from the lane before, by shuffle), warp
//     ballots hold them 32 a word, and the tile's count goes to `counts`;
//  2. one grid barrier (fdb_grid_sync);
//  3. each tile's prefix is the sum of the counts before it, and each
//     endpoint's rank that prefix plus the changes before it in its tile
//     (the words' prefix and a popcount).
// The single pass with decoupled look-back it replaces spent its time in
// a fixed chain (a ticket, the look-back, and a last-CTA reset behind two
// fences over each thread's scattered stores): 0.010 ms at every shape,
// 9-51x its bound on the H100. Here the scratch is `counts`, which every
// launch writes before it reads, and the barrier word, whose low bits the
// barrier leaves zero; nothing is reset.
//
// Bound on H100: bytes. It reads (L + 1) * M int32 and writes M int32:
// 1.6 MB at M = 65,536 and L = 5 (~0.5 us).
#include "common.cuh"

#define RANK_THREADS 256
#define RANK_RUN 2  // endpoints a thread a tile, striped
#define RANK_TILE (RANK_THREADS * RANK_RUN)
#define RANK_WORDS (RANK_TILE / 32)

// The key changes of tile `tile` as RANK_WORDS ballot words in `fmask`
// (bit b of word w: endpoint 32w + b of the tile differs from the one
// before; endpoint 0 always does); returns the tile's count to every
// thread. `fpre[w]` gets the changes in the words before w. Every limb of
// every endpoint of the thread is loaded before any is compared (one
// round trip, not one an endpoint), and the endpoint before comes from the
// lane before (lane 0 loads it).
__device__ __forceinline__ int rank_tile_flags(
    const int32_t* __restrict__ keys, int L, int M, int tile,
    unsigned int* fmask, int* fpre, int* sh_total) {
  const int lane = threadIdx.x & 31;
  const long long i0 = (long long)tile * RANK_TILE;
  long long at[RANK_RUN], before[RANK_RUN];
#pragma unroll
  for (int r = 0; r < RANK_RUN; ++r) {
    const long long i = i0 + r * RANK_THREADS + threadIdx.x;
    at[r] = i < M ? i : M - 1;  // in bounds, discarded past M
    before[r] = lane == 0 && at[r] > 0 ? at[r] - 1 : at[r];
  }
  unsigned int differ[RANK_RUN];
#pragma unroll
  for (int r = 0; r < RANK_RUN; ++r) differ[r] = 0u;
  for (int l = 0; l < L; ++l) {
    const int32_t* row = keys + (long long)l * M;
    int32_t x[RANK_RUN], y[RANK_RUN];
#pragma unroll
    for (int r = 0; r < RANK_RUN; ++r) {
      x[r] = __ldg(row + at[r]);
      y[r] = __ldg(row + before[r]);  // lane 0's; the others' from a shuffle
    }
#pragma unroll
    for (int r = 0; r < RANK_RUN; ++r) {
      const int32_t up = __shfl_up_sync(0xffffffffu, x[r], 1);
      differ[r] |= (unsigned int)(x[r] ^ (lane == 0 ? y[r] : up));
    }
  }
#pragma unroll
  for (int r = 0; r < RANK_RUN; ++r) {
    const long long i = i0 + r * RANK_THREADS + threadIdx.x;
    const bool c = i < M && (i == 0 || differ[r] != 0u);
    const unsigned int w = __ballot_sync(0xffffffffu, c);
    if (lane == 0) fmask[(r * RANK_THREADS + threadIdx.x) >> 5] = w;
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // warp 0 scans the words' counts
    constexpr int PER = (RANK_WORDS + 31) / 32;
    int sum = 0;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int w = lane * PER + u;
      if (w < RANK_WORDS) sum += __popc(fmask[w]);
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    int run = incl - sum;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int w = lane * PER + u;
      if (w < RANK_WORDS) {
        fpre[w] = run;
        run += __popc(fmask[w]);
      }
    }
    if (lane == 31) *sh_total = incl;
  }
  __syncthreads();
  return *sh_total;
}

__global__ void __launch_bounds__(RANK_THREADS)
endpoint_ranks_kernel(const int32_t* __restrict__ keys,
                      const int32_t* __restrict__ ids, int L, int M,
                      int n_tiles, int32_t* counts, unsigned int* sync,
                      int32_t* qranks) {
  __shared__ unsigned int fmask[RANK_WORDS];
  __shared__ int fpre[RANK_WORDS];
  __shared__ int sh_total, sh_base[32];
  // 1. the counts (the flags of a CTA's only tile stay in fmask, and its
  // ids are loaded before the barrier)
  const bool one_tile = blockIdx.x + gridDim.x >= n_tiles;
  int id[RANK_RUN];
#pragma unroll
  for (int r = 0; r < RANK_RUN; ++r) {
    const long long i =
        (long long)blockIdx.x * RANK_TILE + r * RANK_THREADS + threadIdx.x;
    id[r] = i < M ? __ldg(&ids[i]) : 0;
  }
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int total = rank_tile_flags(keys, L, M, t, fmask, fpre, &sh_total);
    if (threadIdx.x == 0) counts[t] = total;
    if (t + (int)gridDim.x < n_tiles) __syncthreads();
  }
  // 2.
  fdb_grid_sync(sync);
  // 3. the ranks, tile by tile
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    if (!one_tile)  // fmask holds the last tile's flags: flags again
      rank_tile_flags(keys, L, M, t, fmask, fpre, &sh_total);
    int base = 0;  // the counts of the tiles before t
    for (int u = threadIdx.x; u < t; u += RANK_THREADS)
      base += __ldcg(&counts[u]);
    base = __reduce_add_sync(0xffffffffu, base);
    if ((threadIdx.x & 31) == 0) sh_base[threadIdx.x >> 5] = base;
    __syncthreads();
    base = 0;
#pragma unroll
    for (int w = 0; w < RANK_THREADS / 32; ++w) base += sh_base[w];
    const long long i0 = (long long)t * RANK_TILE;
#pragma unroll
    for (int r = 0; r < RANK_RUN; ++r) {
      const int k = r * RANK_THREADS + threadIdx.x;
      const long long i = i0 + k;
      const unsigned int upto = (2u << (k & 31)) - 1u;  // bits 0..k&31
      if (i < M)
        qranks[t == (int)blockIdx.x ? id[r] : __ldg(&ids[i])] =
            base + fpre[k >> 5] + __popc(fmask[k >> 5] & upto) - 1;
    }
    __syncthreads();  // before fmask, fpre or sh_base are written again
  }
}

// Co-resident CTAs an SM of each device, read once.
static int g_rank_per_sm[64];

// keys (L, M) and ids (M) are K6's sorted endpoints; qranks (M) the
// output. counts: ceil(M / RANK_TILE) int32, written before read; sync: 1
// uint32 whose low 31 bits are zero on entry, and stay so. One cooperative
// launch on `stream`.
extern "C" int fdb_endpoint_ranks(const int32_t* keys, const int32_t* ids,
                                  int L, int M, int32_t* counts,
                                  unsigned int* sync, int32_t* qranks,
                                  void* stream) {
  if (M < 1 || L < 1) return (int)cudaErrorInvalidValue;
  int dev = 0;
  FdbDeviceLimits lim;
  cudaError_t e = fdb_device_limits(&dev, &lim);
  if (e != cudaSuccess) return (int)e;
  if (g_rank_per_sm[dev] == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &g_rank_per_sm[dev], endpoint_ranks_kernel, RANK_THREADS, 0);
    if (e != cudaSuccess) {
      g_rank_per_sm[dev] = 0;
      return (int)e;
    }
    if (g_rank_per_sm[dev] < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  int n_tiles = (M + RANK_TILE - 1) / RANK_TILE;
  const long long cap = (long long)lim.sms * g_rank_per_sm[dev];
  const int G = (int)(n_tiles < cap ? n_tiles : cap);
  void* params[] = {&keys,    &ids,  &L,     &M,
                    &n_tiles, &counts, &sync, &qranks};
  e = cudaLaunchCooperativeKernel((const void*)endpoint_ranks_kernel,
                                  dim3(G), dim3(RANK_THREADS), params, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
