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
// 4 L (2 NR + 2 NW)(1 + W) bytes, 9.2 MB at the kernel bench's T = 16,384
// with W = 4 and L = 7 (2.7 us at 3.35 TB/s). The comparisons, at most L
// a column and shard, are far below the integer rate.
//
// Design. One launch for the four arrays and all W shards: a thread per
// (shard, column), grid-strided with the column fastest, so a warp loads
// and stores 32 neighbouring columns of one limb row (coalesced) and reads
// one shard's bound, a broadcast. A thread keeps its key's limbs in
// registers (L <= 17, the widest key the encoder takes).
#include "common.cuh"

#define CLIP_THREADS 256
#define CLIP_MAX_L 17

__global__ void __launch_bounds__(CLIP_THREADS)
shard_clip_kernel(const int32_t* __restrict__ rb,
                  const int32_t* __restrict__ re,
                  const int32_t* __restrict__ wb,
                  const int32_t* __restrict__ we,
                  const int32_t* __restrict__ lo,
                  const int32_t* __restrict__ hi, int L, int NR, int NW,
                  int W, int32_t* __restrict__ orb, int32_t* __restrict__ ore,
                  int32_t* __restrict__ owb, int32_t* __restrict__ owe) {
  const long long M = 2LL * NR + 2LL * NW;
  const long long total = (long long)W * M;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int d = (int)(i / M);
    long long j = i - (long long)d * M;
    const int32_t* src;
    int32_t* dst;
    long long n;
    bool begin;
    if (j < NR) {
      src = rb, dst = orb, n = NR, begin = true;
    } else if (j < 2LL * NR) {
      j -= NR;
      src = re, dst = ore, n = NR, begin = false;
    } else if (j < 2LL * NR + NW) {
      j -= 2LL * NR;
      src = wb, dst = owb, n = NW, begin = true;
    } else {
      j -= 2LL * NR + NW;
      src = we, dst = owe, n = NW, begin = false;
    }
    const int32_t* bound = (begin ? lo : hi) + (long long)d * L;
    int32_t key[CLIP_MAX_L];
    int cmp = 0;  // key against the bound: -1, 0 or 1
#pragma unroll
    for (int l = 0; l < CLIP_MAX_L; ++l) {
      if (l < L) {
        key[l] = src[l * n + j];
        if (cmp == 0) {
          const int32_t b = bound[l];
          cmp = key[l] < b ? -1 : (key[l] > b ? 1 : 0);
        }
      }
    }
    const bool take = begin ? cmp < 0 : cmp > 0;
    int32_t* out = dst + (long long)d * L * n;
#pragma unroll
    for (int l = 0; l < CLIP_MAX_L; ++l)
      if (l < L) out[l * n + j] = take ? bound[l] : key[l];
  }
}

// One launch on `stream` for all four arrays and all W shards; nothing to
// do (no columns) launches nothing.
extern "C" int fdb_shard_clip(const int32_t* rb, const int32_t* re,
                              const int32_t* wb, const int32_t* we,
                              const int32_t* lo, const int32_t* hi, int L,
                              int NR, int NW, int W, int32_t* orb,
                              int32_t* ore, int32_t* owb, int32_t* owe,
                              void* stream) {
  if (L < 1 || L > CLIP_MAX_L || NR < 0 || NW < 0 || W < 1)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)W * (2LL * NR + 2LL * NW);
  if (total == 0) return (int)cudaSuccess;
  int dev = 0;
  FdbDeviceLimits lim;
  const cudaError_t e = fdb_device_limits(&dev, &lim);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (total + CLIP_THREADS - 1) / CLIP_THREADS;
  const long long cap = (long long)lim.sms * 16;
  if (blocks > cap) blocks = cap;
  shard_clip_kernel<<<(int)blocks, CLIP_THREADS, 0, (cudaStream_t)stream>>>(
      rb, re, wb, we, lo, hi, L, NR, NW, W, orb, ore, owb, owe);
  return (int)cudaGetLastError();
}
