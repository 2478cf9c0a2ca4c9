// K10 shard_clip: every range of a batch clipped to every shard's key range.
//
// Replaces: foundationdb_tpu/parallel/sharded_conflict.py `_clip_ranges`
// (:111-121), which `local_step` (:180-186) of the jitted shard_map step
// runs on each shard for the reads and again for the writes. For shard d,
// owning [lo_d, hi_d), and every column j:
//   begin' = lo_d if begin <lex lo_d else begin
//   end'   = hi_d if hi_d <lex end   else end
// over L int32 limbs (sign-flipped, so signed order is key order). A range
// the shard does not own comes out empty or inverted (begin' >= end'), and
// every phase of the step ignores it. Padding columns (the all-ones key)
// never sort below lo or above hi, so they stay padding.
//
// Inputs rb, re (L, NR) and wb, we (L, NW), limb-major; lo, hi (W, L).
// Outputs four (W, L, N) arrays, shard d's (L, N) slice contiguous, so it
// feeds that shard's step as it is. The pooled and the strided layouts
// both come here: the kernel sees only (L, N).
//
// Bound on H100: bytes. Each input limb is read once and written W times:
// 4 L (2 NR + 2 NW)(1 + W) bytes, 2.29 MB in phase 8a's chunk (W = 4,
// NR = NW = 4,096, L = 7: 0.68 us at 3.35 TB/s) and 9.2 MB at the sharded
// bench's T = 16,384 (2.7 us). The comparisons, at most L a column and
// shard, are far below the integer rate. At 8a's size one launch's floor
// (probe_add on one element, about 1 us of device time) is above the
// bytes' time, so the kernel is held to floor plus bytes.
//
// Design. A thread loads one column of one array, its L limbs
// (L a template parameter, 1 to 17: the limbs sit in L registers and no
// loop carries a predicate), compares it with each of its shards' bounds
// and writes each shard's clipped copy. The grid is (column tile, array,
// shard group): blockIdx.y names the array, so a block knows whether it
// clips begins (to lo) or ends (to hi) and no thread branches on it or
// divides to find it; a block copies its group's bound rows into shared
// memory while its key loads are in flight. Indexing is 32-bit within a
// shard's slice (the host refuses L x N past 2^31). The launch's shape is
// fixed and asks the device nothing: CLIP_THREADS a block, every shard in
// one thread (so each key is read once), split into groups only where
// the bounds would pass 48 KB of shared memory.
//
// What was measured (chip_smoke --time-floor, device ms, H100 80GB HBM3
// at 700 W): the parent kernel (a thread per (shard, column), 64-bit
// division, L a run-time bound of 17 predicated limbs) took 0.0027 at 8a
// and 0.0052 at 8c. A first redesign kept L a run-time bound: with a
// key's 17 int4 limbs in registers (122 of them), a thread writing all
// its shards left most SMs idle (0.0061 at 8a), and no launch shape beat
// the parent at 8a by more than 3%. The time went to the registers and
// predicates of the run-time L, not to the bytes. With L a template
// parameter, 4-byte columns (no vector path, so no alignment or
// multiple-of-4 case) and every shard in one thread took 0.00187 at 8a
// and 0.00336-0.00356 at 8c. A sweep of launch shapes (64 to 512
// threads a block, one to four shard groups) found none better than this
// one by more than 0.00003 at 8a (256 threads, 2 groups: 0.00184) or
// 0.00015 at 8c (512 threads, 1 group: 0.00341); one shard a group (a
// key read W times) took 0.00193-0.00221 at 8a and 0.0039-0.0043 at 8c.
// PERF.md §6 has the times beside the parent's, the bound and one
// launch's floor.
#include "common.cuh"

#define CLIP_THREADS 128
#define CLIP_MAX_L 17
#define CLIP_SMEM_INTS 12288  // bound limbs a block keeps: 48 KB, no opt-in

struct ClipArrays {
  const int32_t* src[4];  // rb, re, wb, we
  int32_t* dst[4];        // their (W, L, N) outputs
  const int32_t* lo;
  const int32_t* hi;
  int nr, nw;
};

// L limbs a key, known at compile time (one instantiation for each L the
// encoder can give, 1 to CLIP_MAX_L), so that a key's limbs sit in L
// registers and every loop unrolls without a predicate. blockIdx.y: the
// array (0 rb, 1 re, 2 wb, 3 we); blockIdx.z: the shard group
// [z S, min(W, z S + S)); a thread the column blockIdx.x * blockDim.x +
// threadIdx.x. Dynamic shared memory: S x L ints, the group's bound rows.
template <int L>
__global__ void __launch_bounds__(CLIP_THREADS)
shard_clip_kernel(const ClipArrays p, int W, int S) {
  extern __shared__ int32_t sh_bound[];
  // the block's array, picked by selects (a parameter array indexed at
  // run time could go through local memory)
  const int a = blockIdx.y;
  const bool begin = (a & 1) == 0;
  const bool reads = a < 2;
  const int n = reads ? p.nr : p.nw;
  const int32_t* __restrict__ src =
      reads ? (begin ? p.src[0] : p.src[1]) : (begin ? p.src[2] : p.src[3]);
  int32_t* __restrict__ dst =
      reads ? (begin ? p.dst[0] : p.dst[1]) : (begin ? p.dst[2] : p.dst[3]);
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = j < n;
  const int d0 = blockIdx.z * S;
  const int nd = min(S, W - d0);

  // the key's limbs first, so that their latency hides behind the bounds'
  int32_t key[L];
#pragma unroll
  for (int l = 0; l < L; ++l) key[l] = live ? src[l * n + j] : 0;
  const int32_t* __restrict__ bound = (begin ? p.lo : p.hi) + (size_t)d0 * L;
  for (int i = threadIdx.x; i < nd * L; i += blockDim.x) sh_bound[i] = bound[i];
  __syncthreads();
  if (!live) return;

  dst += (size_t)d0 * L * n;
  for (int d = 0; d < nd; ++d, dst += (size_t)L * n) {
    const int32_t* b = sh_bound + d * L;
    int32_t y[L];
    int r = 0;  // the key against the bound: -1, 0 or 1
#pragma unroll
    for (int l = 0; l < L; ++l) {
      y[l] = b[l];
      const int c = (key[l] > y[l]) - (key[l] < y[l]);
      r = r != 0 ? r : c;
    }
    const bool take = begin ? r < 0 : r > 0;
#pragma unroll
    for (int l = 0; l < L; ++l) dst[l * n + j] = take ? y[l] : key[l];
  }
}

template <int L>
static void clip_launch_l(const ClipArrays& p, int W, int S, dim3 grid,
                          cudaStream_t stream) {
  shard_clip_kernel<L><<<grid, CLIP_THREADS, (size_t)S * L * sizeof(int32_t),
                         stream>>>(p, W, S);
}

// One launch on `stream` for all four arrays and all W shards; nothing to
// do (no columns) launches nothing. CLIP_THREADS a block and every shard
// in one group, so each key is read once; more groups only where W L
// passes CLIP_SMEM_INTS.
extern "C" int fdb_shard_clip(const int32_t* rb, const int32_t* re,
                              const int32_t* wb, const int32_t* we,
                              const int32_t* lo, const int32_t* hi, int L,
                              int NR, int NW, int W, int32_t* orb,
                              int32_t* ore, int32_t* owb, int32_t* owe,
                              void* stream) {
  if (L < 1 || L > CLIP_MAX_L || NR < 0 || NW < 0 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int N = NR > NW ? NR : NW;
  if ((long long)L * N >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const ClipArrays p{{rb, re, wb, we}, {orb, ore, owb, owe}, lo, hi, NR, NW};
  const int most = CLIP_SMEM_INTS / L;  // shards a group's bounds may hold
  const int S = W < most ? W : most;    // shards a group
  const int G = (W + S - 1) / S;
  if (G > 65535) return (int)cudaErrorInvalidValue;
  const int tiles = (N + CLIP_THREADS - 1) / CLIP_THREADS;
  if (tiles == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)tiles, 4, (unsigned)G);
  cudaStream_t st = (cudaStream_t)stream;
  switch (L) {
#define CLIP_CASE(LL) \
  case LL:            \
    clip_launch_l<LL>(p, W, S, grid, st); \
    break;
    CLIP_CASE(1) CLIP_CASE(2) CLIP_CASE(3) CLIP_CASE(4) CLIP_CASE(5)
    CLIP_CASE(6) CLIP_CASE(7) CLIP_CASE(8) CLIP_CASE(9) CLIP_CASE(10)
    CLIP_CASE(11) CLIP_CASE(12) CLIP_CASE(13) CLIP_CASE(14) CLIP_CASE(15)
    CLIP_CASE(16) CLIP_CASE(17)
#undef CLIP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
