// Shared device helpers of the conflict-engine kernels (sm_90a).
//
// Each kernel file compiles on its own (one nvcc per source, in parallel)
// and the objects link into one shared library with a plain C interface,
// bound with ctypes from ops/kernels.py. Launches go on the caller's
// stream, nothing is allocated here, and every entry point returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define FDB_NEG (-(1 << 30))  // "no version" (ops/conflict_ref.py NEG)
#define FDB_PAD_LIMB 0x7FFFFFFF  // padding key limb, sign-flipped 0xFFFFFFFF
#define FDB_EMPTY_LIMB INT_MIN  // encode(b"") limb, sign-flipped 0

// Lexicographic a < b over L int32 limbs stored limb-major with stride n.
__device__ __forceinline__ bool fdb_key_lt(const int32_t* a, const int32_t* b,
                                           int L, long long n, long long i) {
  for (int l = 0; l < L; ++l) {
    const int32_t x = a[l * n + i], y = b[l * n + i];
    if (x != y) return x < y;
  }
  return false;
}

// Exclusive scan of one value per thread across the block under an
// associative `op(earlier, later)` with identity `id`. T needs
// `static __device__ T shfl_up(T, int)`. blockDim.x is a multiple of 32.
// `sh` holds 32 T in shared memory. *total gets the block aggregate. Ends
// with a barrier, so `sh` may be reused at once.
template <typename T, typename Op>
__device__ __forceinline__ T fdb_block_exclusive_scan(T x, Op op, T id, T* sh,
                                                      T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  T incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T y = T::shfl_up(incl, d);
    if (lane >= d) incl = op(y, incl);
  }
  T excl = T::shfl_up(incl, 1);
  if (lane == 0) excl = id;
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarps ? sh[lane] : id;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T y = T::shfl_up(w, d);
      if (lane >= d) w = op(y, w);
    }
    sh[lane] = w;
  }
  __syncthreads();
  if (warp > 0) excl = op(sh[warp - 1], excl);
  *total = sh[nwarps - 1];
  __syncthreads();
  return excl;
}

__device__ __forceinline__ int fdb_shfl_up(int v, int d) {
  return __shfl_up_sync(0xffffffffu, v, d);
}

// Integer sum, the simplest scan element.
struct FdbSum {
  int v;
  static __device__ __forceinline__ FdbSum shfl_up(FdbSum x, int d) {
    return {fdb_shfl_up(x.v, d)};
  }
};
struct FdbSumOp {
  __device__ __forceinline__ FdbSum operator()(FdbSum a, FdbSum b) const {
    return {a.v + b.v};
  }
};

// "Latest flagged value": the value at the latest position with has=1
// (`_carry_last_flagged`'s monoid).
struct FdbLast {
  int v;
  int has;
  static __device__ __forceinline__ FdbLast shfl_up(FdbLast x, int d) {
    return {fdb_shfl_up(x.v, d), fdb_shfl_up(x.has, d)};
  }
};
struct FdbLastOp {
  __device__ __forceinline__ FdbLast operator()(FdbLast a, FdbLast b) const {
    return {b.has ? b.v : a.v, a.has | b.has};
  }
};
