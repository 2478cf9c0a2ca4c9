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

// Lexicographic comparison of two keys of L int32 limbs, each stored
// limb-major with its own stride (global or shared memory): -1, 0 or 1.
__device__ __forceinline__ int fdb_key_cmp(const int32_t* a, long long sa,
                                           const int32_t* b, long long sb,
                                           int L) {
  for (int l = 0; l < L; ++l) {
    const int32_t x = a[l * sa], y = b[l * sb];
    if (x != y) return x < y ? -1 : 1;
  }
  return 0;
}

// fdb_key_cmp with the limbs loaded W at a time: a comparison that reaches
// limb l waits for l / W + 1 loads instead of l + 1, for keys where equal
// limbs are common. With SELECTS every load of a batch is needed whatever
// the earlier limbs hold, so the W loads issue together: a limb past L
// loads limb L - 1 again (in bounds, and equal whenever the comparison
// gets that far), and the batch is reduced by selects. Without it a limb
// past L is not loaded and the first limb that differs returns. Which is
// faster depends on the caller, so each call site takes the one measured
// faster on the H100: K7's probes (nvcc sank each limb's load into the
// branch of the early return there, a dependent round trip a limb) and
// K6's shared-memory merge take SELECTS, K6's warp-wide co-rank search
// does not. With CG the loads bypass L1 (__ldcg), for global memory that
// other CTAs may have written earlier in the same launch.
template <int W, bool CG = false, bool SELECTS = true>
__device__ __forceinline__ int fdb_key_cmp_wide(const int32_t* a,
                                                long long sa,
                                                const int32_t* b,
                                                long long sb, int L) {
  for (int l0 = 0; l0 < L; l0 += W) {
    int32_t x[W], y[W];
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const bool in = SELECTS || l0 + u < L;
      const int l = SELECTS ? min(l0 + u, L - 1) : l0 + u;
      const int32_t* pa = a + l * sa;
      const int32_t* pb = b + l * sb;
      x[u] = in ? (CG ? __ldcg(pa) : *pa) : 0;
      y[u] = in ? (CG ? __ldcg(pb) : *pb) : 0;
    }
    if (SELECTS) {
      int r = 0;
#pragma unroll
      for (int u = 0; u < W; ++u) {
        const int d = (x[u] > y[u]) - (x[u] < y[u]);
        r = r != 0 ? r : d;
      }
      if (r != 0) return r;
    } else {
#pragma unroll
      for (int u = 0; u < W; ++u)
        if (x[u] != y[u]) return x[u] < y[u] ? -1 : 1;
    }
  }
  return 0;
}

// Class of batch endpoint j of [rb | re | wb | we] at equal keys: a read
// end 0, the rest 2 (a state element's class is 1).
__device__ __forceinline__ int fdb_endpoint_cls(int j, int NR) {
  return (j >= NR && j < 2 * NR) ? 0 : 2;
}

// The first limb on which the n keys held limb-major in shared memory
// (stride `stride`) are not all equal, or L if they are all equal. Every
// key shares the limbs before it, so comparisons among these keys may
// start there. L <= 32. Called by every thread of the block after the
// keys are stored; its barriers make them visible.
__device__ __forceinline__ int fdb_first_varying_limb(const int32_t* sk,
                                                      int stride, int n,
                                                      int L,
                                                      unsigned int* sh_mask) {
  if (threadIdx.x == 0) *sh_mask = 0u;
  __syncthreads();
  unsigned int first = 0u;  // bit l: some key's first difference is limb l
  for (int x = threadIdx.x; x < n; x += blockDim.x)
    for (int l = 0; l < L; ++l)
      if (sk[l * stride + x] != sk[l * stride]) {
        first |= 1u << l;
        break;
      }
  if (first) atomicOr(sh_mask, first);
  __syncthreads();
  const unsigned int m = *sh_mask;
  return m ? __ffs(m) - 1 : L;
}

// Merge-path co-rank: how many elements of A are among the first q of the
// merge of A (nA elements) and B (nB), where before(i, k) says A[i]
// precedes B[k] in the merge's order. It is the least i in
// [max(0, q - nB), min(q, nA)] with !before(i, q - i - 1); the predicate is
// monotone (true, then false) in i, and is only asked at 0 <= i < nA,
// 0 <= k < nB. One thread, by bisection.
template <typename Before>
__device__ __forceinline__ int fdb_corank(int q, int nA, int nB,
                                          Before before) {
  int lo = max(0, q - nB), hi = min(q, nA);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(mid, q - mid - 1)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The same co-rank found by a whole warp: each round its 32 lanes probe 32
// evenly spaced points of the interval, so 2^20 candidates take 4 rounds
// of dependent loads instead of 20. Every lane returns the answer.
template <typename Before>
__device__ __forceinline__ int fdb_warp_corank(int q, int nA, int nB,
                                               Before before) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, q - nB), hi = min(q, nA);
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int x = lo + lane * step;
    const bool p = x < hi && before(x, q - x - 1);
    const int c = __popc(__ballot_sync(0xffffffffu, p));  // a prefix is true
    if (c == 0) {
      hi = lo;
    } else {
      const int next = lo + c * step;  // the first probe that is false
      lo = lo + (c - 1) * step + 1;
      hi = min(hi, next);
    }
  }
  return lo;
}

// Launch limits of a device: its SM count and the most shared memory a
// block may opt in to.
struct FdbDeviceLimits {
  int sms;
  int smem_optin;
};

// The current device and its limits, read once a device (each kernel file
// keeps its own copy of the cache).
static inline cudaError_t fdb_device_limits(int* dev,
                                            FdbDeviceLimits* lim) {
  static FdbDeviceLimits cache[64];
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  const int d = *dev;
  if (d < 0 || d >= 64) return cudaErrorInvalidDevice;
  if (cache[d].sms == 0) {
    FdbDeviceLimits r;
    e = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount, d);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&r.smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, d);
    if (e != cudaSuccess) return e;
    cache[d] = r;
  }
  *lim = cache[d];
  return cudaSuccess;
}

// Let `kernel` take `bytes` of dynamic shared memory on device `dev`. A
// kernel whose dynamic and static shared memory pass 48 KB must ask first,
// even when the dynamic part alone is 48 KB. `granted` is the kernel's own
// per-device record of the most already allowed (64 ints, zero at first),
// so the attribute is set only when a launch needs more than before.
template <typename Kernel>
static cudaError_t fdb_allow_smem(Kernel kernel, int dev, size_t bytes,
                                  int* granted) {
  if ((long long)bytes <= granted[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) granted[dev] = (int)bytes;
  return e;
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

// Integer max with identity INT_MIN.
struct FdbMax {
  int v;
  static __device__ __forceinline__ FdbMax shfl_up(FdbMax x, int d) {
    return {fdb_shfl_up(x.v, d)};
  }
};
struct FdbMaxOp {
  __device__ __forceinline__ FdbMax operator()(FdbMax a, FdbMax b) const {
    return {max(a.v, b.v)};
  }
};

__device__ __forceinline__ unsigned int fdb_ld_volatile(const unsigned int* p) {
  return *(const volatile unsigned int*)p;
}

// Grid-wide barrier of a cooperative launch (every CTA co-resident).
// CTA 0 adds 2^31 - (G - 1), every other CTA adds 1, so the arrivals of one
// barrier add exactly 2^31: the top bit of *sync flips when the last CTA
// arrives, and the low bits stay zero between barriers (and launches). One
// atomic a CTA, no reset; *sync's low 31 bits must be zero on entry.
__device__ __forceinline__ void fdb_grid_sync(unsigned int* sync) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(sync, add);
    while (((old ^ fdb_ld_volatile(sync)) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

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

// ---------------------------------------------------------------------------
// Single-pass scan with decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016).
// Each tile has a descriptor of `desc_words` int32 in global scratch: for
// monoid m, a status word at m (0 none, 1 aggregate, 2 inclusive prefix)
// and the monoid's aggregate and inclusive prefix at offsets the caller
// names. Tiles are taken from an atomic ticket, so every earlier tile has
// started and the look-back cannot deadlock.
// ---------------------------------------------------------------------------

#define FDB_ST_AGG 1
#define FDB_ST_INCL 2

__device__ __forceinline__ void desc_put(volatile int32_t* w, FdbLast x) {
  w[0] = x.v;
  w[1] = x.has;
}
__device__ __forceinline__ void desc_get(const volatile int32_t* w,
                                         FdbLast* x) {
  *x = {w[0], w[1]};
}
__device__ __forceinline__ void desc_put(volatile int32_t* w, FdbSum x) {
  w[0] = x.v;
}
__device__ __forceinline__ void desc_get(const volatile int32_t* w,
                                         FdbSum* x) {
  *x = {w[0]};
}

// Values first, then the status with release semantics; a reader that
// acquires the status sees the values.
__device__ __forceinline__ int fdb_ld_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
template <typename V>
__device__ __forceinline__ void fdb_desc_publish(int32_t* d, int m, int off,
                                                 V v, int status) {
  desc_put(d + off, v);
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(d + m), "r"(status)
               : "memory");
}

// The exclusive prefix of `tile` under monoid m, by decoupled look-back
// over the predecessors' descriptors, a window of blockDim.x tiles at a
// time: thread k examines tile p - (blockDim.x - 1) + k. One round trip to
// L2 covers blockDim.x predecessors. Called by every thread; the result is
// the same in all of them.
template <typename V, typename Op>
__device__ V fdb_look_back(const int32_t* desc, int desc_words, int tile,
                           int m, int agg_off, int incl_off, Op op, V id,
                           V* sh_scan, int* sh_first) {
  V excl = id;
  for (int p = tile - 1;; p -= blockDim.x) {
    const int q = p - (int)(blockDim.x - 1) + (int)threadIdx.x;
    int st = FDB_ST_INCL;  // before tile 0: the identity, as a full prefix
    V v = id;
    if (q >= 0) {
      const int32_t* dq = desc + (long long)q * desc_words;
      do {
        st = fdb_ld_acquire(dq + m);
      } while (st == 0);
      desc_get(dq + (st == FDB_ST_INCL ? incl_off : agg_off), &v);
    }
    // fold the window in tile order from its latest inclusive prefix on
    if (threadIdx.x == 0) *sh_first = -1;
    __syncthreads();
    if (st == FDB_ST_INCL) atomicMax(sh_first, (int)threadIdx.x);
    __syncthreads();
    const int first = *sh_first;
    if ((int)threadIdx.x < first) v = id;
    V window;
    fdb_block_exclusive_scan(v, op, id, sh_scan, &window);
    excl = op(window, excl);
    if (first >= 0) break;
  }
  return excl;
}

// Publish this tile's aggregate `total` under monoid m, look back, publish
// the inclusive prefix; returns the exclusive prefix to every thread.
template <typename V, typename Op>
__device__ V fdb_tile_prefix(int32_t* desc, int desc_words, int tile, int m,
                             int agg_off, int incl_off, V total, Op op, V id,
                             V* sh_scan, int* sh_first) {
  int32_t* d = desc + (long long)tile * desc_words;
  if (tile == 0) {
    if (threadIdx.x == 0) fdb_desc_publish(d, m, incl_off, total, FDB_ST_INCL);
    return id;
  }
  if (threadIdx.x == 0) fdb_desc_publish(d, m, agg_off, total, FDB_ST_AGG);
  const V excl = fdb_look_back(desc, desc_words, tile, m, agg_off, incl_off,
                               op, id, sh_scan, sh_first);
  if (threadIdx.x == 0)
    fdb_desc_publish(d, m, incl_off, op(excl, total), FDB_ST_INCL);
  return excl;
}
