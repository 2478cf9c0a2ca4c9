// The A/B probe kernels: counterparts of the six Pallas kernels of
// scripts/ab_pallas.py and scripts/ab_pallas2.py, which time a streaming
// pass and a co-partitioned rank join over a 2^18-row key state.
//
//   probe_add      add_kernel (ab_pallas.py:37)       out = x + 1
//   probe_stream   stream_kernel (ab_pallas.py:49)    per-limb max of a
//                  stream_kernel (ab_pallas2.py:39)   (rows, limbs) state,
//                                                     row- or limb-major
//   probe_rank     join_kernel (ab_pallas.py:80)      per state tile: each
//                  lexjoin_kernel (ab_pallas2.py:64)  query's count of the
//                                                     tile's rows below it
//   probe_dynwrite dynwrite_kernel (ab_pallas.py:112) rows at a device-held
//                                                     offset, placed as
//                                                     the Pallas slice
//                                                     places them
//
// A TPU grid runs its steps in order on one core, and the Pallas stream
// carries its maximum across them in the output block; here blocks run in
// parallel, so each reduces its rows in registers and shared memory and
// folds into the output with one atomic max per limb. The uint32 probes of
// ab_pallas.py pass their bits as int32 and compare unsigned
// (`is_unsigned`).
//
// The rank join is a sort and a search per tile, not the Pallas bodies'
// all-pairs compare (QT x TILE pairs a tile, 2.7e8 for lexjoin). One CTA
// a tile sorts the tile's QT queries, the smaller side at the scripts'
// shapes (256 and 1,024 queries against 2,048 rows), and streams the rows
// past them. Every limb is mapped to an order-preserving uint32 (signed
// limbs with the sign bit flipped); a key is a 64-bit primary key (limbs
// 0 and 1, kept as two words) and the limbs past the second, the
// tiebreak, kept in shared memory by query index. The queries sort by
// merging runs in pairs, ceil(log2 QT) rounds: a query's place in the
// merged run is its index in its own run plus its rank in the other, found
// by bisection, so a round is one barrier and a short chain of dependent
// loads. Each row (its limbs loaded before the sort, so that their latency
// hides behind it) finds by bisection u, the count of sorted queries at or
// below it, and adds one to bin u of a histogram in shared memory: the row
// is below exactly the sorted queries from u on. So the count of sorted
// query i is the histogram's prefix sum to i, exact under any ties; a
// block scan forms it, and the counts go out in query order. Bisection
// compares load the high words first (4 bytes), which decide almost
// every step.
// Bitonic networks, timed on the H100 (device ms, join / lexjoin): the
// 2,048 rows sorted in shared memory and a search a query, 0.027 / 0.030;
// the queries sorted in shared memory, 0.016 / 0.023, and no faster with
// the elements in registers and warp shuffles. Their 36 to 66 dependent
// stages, each a few hundred cycles, cost more than the rest of the
// kernel; the merge rounds are 8 and 10.
//
// Bounds on H100 at the scripts' shapes (K = 2^18 rows, L = 8 limbs,
// TILE = 2,048): the stream pass reads 8 MB, 2.5 us of HBM time; the rank
// join reads what it compares and writes the counts: for join the whole
// row-major rows of the state and the queries (a row is one 32-byte
// sector), 9.6 MB; for lexjoin only the LK = 5 limb rows of the limb-major
// state and queries, 8.4 MB. That is 2.9 and 2.5 us, far more than its
// sort and searches cost in operations, so it is bound by bytes; add and
// dynwrite are launch latency.
//
// dynwrite, redesigned. Its 32 KB output is under a launch's
// floor (probe_add on one element: 0.00101-0.00104 ms of device time,
// chip_smoke --time-floor on the H100 80GB HBM3 at 700 W), so what it can
// save is what it adds to the floor. The parent (32 blocks of 256 threads,
// a 64-bit division and a load of *off by every thread, 4-byte stores)
// took 0.00131-0.00136 ms. Here *off is read once a block into shared
// memory, a warp writes a row, 16 bytes a thread, with no division, and
// the rows are split over blocks of DYN_BLOCK_BYTES (16 blocks at the
// script's shape). A sweep of 1 to 64 blocks: one block took 0.00201 (a
// single SM's stores), 2 and 4 took 0.0016 and 0.00139, 8 to 64
// 0.00126-0.00133, 16 the least (0.00126-0.00127); copying x into shared memory beside the read of *off, so that no
// load waits for it, took longer (0.00141-0.00144 at 8 to 64 blocks).
#include "common.cuh"

#define PROBE_THREADS 256
#define PROBE_MAX_L 8

// a thread's VEC neighbouring int32 columns
template <int VEC>
struct ProbeVec {
  typedef int4 T;
};
template <>
struct ProbeVec<1> {
  typedef int32_t T;
};

template <bool U>
__device__ __forceinline__ bool probe_lt(int32_t a, int32_t b) {
  return U ? (uint32_t)a < (uint32_t)b : a < b;
}

__global__ void probe_add_kernel(const int32_t* __restrict__ x,
                                 int32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + 1;
}

// out[l] (zero on entry) = max(out[l], max_r s(r, l)), s(r, l) at
// r * s_row + l * s_limb
template <bool U>
__global__ void __launch_bounds__(PROBE_THREADS)
probe_stream_kernel(const int32_t* __restrict__ s, int K, int L,
                    long long s_row, long long s_limb, int32_t* out) {
  __shared__ int32_t sh[PROBE_THREADS / 32][PROBE_MAX_L];
  int32_t acc[PROBE_MAX_L];
#pragma unroll
  for (int l = 0; l < PROBE_MAX_L; ++l) acc[l] = 0;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < K;
       r += gridDim.x * blockDim.x) {
#pragma unroll
    for (int l = 0; l < PROBE_MAX_L; ++l) {
      if (l < L) {
        const int32_t v = s[r * s_row + l * s_limb];
        if (probe_lt<U>(acc[l], v)) acc[l] = v;
      }
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int l = 0; l < PROBE_MAX_L; ++l) {
    for (int d = 16; d > 0; d >>= 1) {
      const int32_t v = __shfl_down_sync(0xffffffffu, acc[l], d);
      if (probe_lt<U>(acc[l], v)) acc[l] = v;
    }
    if (lane == 0) sh[warp][l] = acc[l];
  }
  __syncthreads();
  if (threadIdx.x < L) {
    int32_t m = sh[0][threadIdx.x];
    for (int w = 1; w < PROBE_THREADS / 32; ++w)
      if (probe_lt<U>(m, sh[w][threadIdx.x])) m = sh[w][threadIdx.x];
    if (U)
      atomicMax(reinterpret_cast<unsigned int*>(out) + threadIdx.x,
                (unsigned int)m);
    else
      atomicMax(out + threadIdx.x, m);
  }
}

// The rank join: a CTA of RANK_THREADS a tile. Its shared memory: two
// buffers of the queries' primary keys (high words, then low words), the
// (LK - 2) x QT tail limbs, QT + 1 histogram bins, and two buffers of
// query indices.
#define RANK_PRIMARY 2  // limbs in the primary key
#define RANK_THREADS 1024
#define RANK_MAX_QT 65535  // query indices are 16 bits
#define RANK_ROWS 2  // rows a thread loads before the sort

__device__ __forceinline__ uint32_t rank_ord(int32_t v, uint32_t flip) {
  return (uint32_t)v ^ flip;
}

// A key's LK limbs from `base` at stride `limb`, order-mapped, into v.
__device__ __forceinline__ void rank_load(const int32_t* __restrict__ p,
                                          long long base, long long limb,
                                          int LK, uint32_t flip,
                                          uint32_t (&v)[PROBE_MAX_L]) {
#pragma unroll
  for (int l = 0; l < PROBE_MAX_L; ++l)
    v[l] = l < LK ? rank_ord(p[base + l * limb], flip) : 0u;
}

// Queries sorted in shared memory: the primary key's two words and the
// query's index a position, its tail limbs (limbs past the second) by
// index.
struct RankRun {
  const uint32_t* hi;
  const uint32_t* lo;
  const uint16_t* idx;
  const uint32_t* tail;
  int QT, ntail;
};

// Whether the query at position p of `r` is below a key (strictly, or
// also when equal: `or_equal`). The key is (h, l) and its tail limbs:
// query ki's in `r.tail` for ki >= 0, else v[RANK_PRIMARY..]. The high
// words decide almost every compare, so a compare loads 4 bytes.
__device__ __forceinline__ bool rank_below(const RankRun& r, int p,
                                           uint32_t h, uint32_t l,
                                           const uint32_t (&v)[PROBE_MAX_L],
                                           int ki, bool or_equal) {
  const uint32_t qh = r.hi[p];
  if (qh != h) return qh < h;
  const uint32_t ql = r.lo[p];
  if (ql != l) return ql < l;
  const int i = r.idx[p];
#pragma unroll
  for (int c = 0; c < PROBE_MAX_L - RANK_PRIMARY; ++c) {
    if (c < r.ntail) {
      const uint32_t x = r.tail[c * r.QT + i];
      const uint32_t y = ki >= 0 ? r.tail[c * r.QT + ki]
                                 : v[c + RANK_PRIMARY];
      if (x != y) return x < y;
    }
  }
  return or_equal;
}

// The count of positions in [lo, lo + n) of `r` (sorted) whose query is
// below the key (`rank_below`), by a bisection that halves the window by
// a select each step.
__device__ __forceinline__ int rank_count(const RankRun& r, int lo, int n,
                                          uint32_t h, uint32_t l,
                                          const uint32_t (&v)[PROBE_MAX_L],
                                          int ki, bool or_equal) {
  int base = lo;
  while (n > 1) {
    const int half = n >> 1;
    base = rank_below(r, base + half - 1, h, l, v, ki, or_equal) ? base + half
                                                                  : base;
    n -= half;
  }
  if (n == 1 && rank_below(r, base, h, l, v, ki, or_equal)) ++base;
  return base - lo;
}

// out[t * QT + q] = #{i < TILE : key(s row t * TILE + i) < key(query t, q)}
// over the first LK limbs; a CTA a tile t. Row i's limb l at
// (t * TILE + i) * s_row + l * s_limb, query (t, q)'s at
// t * q_tile + q * q_q + l * q_limb.
__global__ void __launch_bounds__(RANK_THREADS)
probe_rank_kernel(const int32_t* __restrict__ s, const int32_t* __restrict__ q,
                  int TILE, int QT, int LK, long long s_row, long long s_limb,
                  long long q_tile, long long q_q, long long q_limb,
                  uint32_t flip, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char rank_smem[];
  __shared__ FdbSum sh_scan[32];
  const int ntail = LK > RANK_PRIMARY ? LK - RANK_PRIMARY : 0;
  // buffer b's high words at b * 2 * QT, its low words QT further, its
  // indices at b * QT of `ix`
  uint32_t* const keys = reinterpret_cast<uint32_t*>(rank_smem);
  uint32_t* const tail = keys + 4 * QT;
  int* const hist = reinterpret_cast<int*>(tail + (long long)ntail * QT);
  uint16_t* const ix = reinterpret_cast<uint16_t*>(hist + QT + 1);
  const long long t = blockIdx.x;
  const int tid = threadIdx.x;
  const long long row0 = t * TILE;

  // this thread's first rows, loaded now so that their latency hides
  // behind the sort
  uint32_t rv[RANK_ROWS][PROBE_MAX_L];
#pragma unroll
  for (int u = 0; u < RANK_ROWS; ++u) {
    const int i = tid + u * RANK_THREADS;
    if (i < TILE) rank_load(s, (row0 + i) * s_row, s_limb, LK, flip, rv[u]);
  }

  // the queries in their order, each a run of one; the histogram zeroed
  for (int e = tid; e < QT; e += RANK_THREADS) {
    uint32_t v[PROBE_MAX_L];
    rank_load(q, t * q_tile + e * q_q, q_limb, LK, flip, v);
    keys[e] = v[0];
    keys[QT + e] = LK > 1 ? v[1] : 0u;
    ix[e] = (uint16_t)e;
#pragma unroll
    for (int l = 0; l < PROBE_MAX_L - RANK_PRIMARY; ++l)
      if (l < ntail) tail[l * QT + e] = v[l + RANK_PRIMARY];
  }
  for (int i = tid; i <= QT; i += RANK_THREADS) hist[i] = 0;
  __syncthreads();

  // merge sort by ranks: each round merges runs of w in pairs, every query
  // moving to its own index in its run plus its rank in the other run
  // (left runs count the other's queries strictly below them, right runs
  // those at or below, so equal keys keep their order and positions stay
  // distinct)
  int b = 0;
  for (int w = 1; w < QT; w <<= 1, b ^= 1) {
    const RankRun src = {keys + b * 2 * QT, keys + b * 2 * QT + QT,
                         ix + b * QT, tail, QT, ntail};
    uint32_t* const dhi = keys + (b ^ 1) * 2 * QT;
    uint16_t* const dix = ix + (b ^ 1) * QT;
    for (int e = tid; e < QT; e += RANK_THREADS) {
      const int base = e & ~(2 * w - 1);
      const bool left = e - base < w;
      const int other = left ? base + w : base;
      const int n = left ? min(w, QT - other) : w;
      const uint32_t none[PROBE_MAX_L] = {};
      const int i = src.idx[e];
      const uint32_t h = src.hi[e], l = src.lo[e];
      const int pos =
          (left ? e : e - w) +
          (n > 0 ? rank_count(src, other, n, h, l, none, i, !left) : 0);
      dhi[pos] = h;
      dhi[QT + pos] = l;
      dix[pos] = (uint16_t)i;
    }
    __syncthreads();
  }
  const RankRun sorted = {keys + b * 2 * QT, keys + b * 2 * QT + QT,
                          ix + b * QT, tail, QT, ntail};

  // each row: below exactly the sorted queries from its upper bound on
#pragma unroll
  for (int u = 0; u < RANK_ROWS; ++u) {
    if (tid + u * RANK_THREADS < TILE)
      atomicAdd(&hist[rank_count(sorted, 0, QT, rv[u][0],
                                 LK > 1 ? rv[u][1] : 0u, rv[u], -1, true)],
                1);
  }
  for (int i = tid + RANK_ROWS * RANK_THREADS; i < TILE; i += RANK_THREADS) {
    uint32_t v[PROBE_MAX_L];
    rank_load(s, (row0 + i) * s_row, s_limb, LK, flip, v);
    atomicAdd(&hist[rank_count(sorted, 0, QT, v[0], LK > 1 ? v[1] : 0u, v,
                               -1, true)],
              1);
  }
  __syncthreads();

  // sorted query i's count: the histogram's prefix sum to i; each thread
  // scans a run of bins
  const int per = (QT + RANK_THREADS - 1) / RANK_THREADS;
  const int b0 = min(tid * per, QT), b1 = min(b0 + per, QT);
  int sum = 0;
  for (int k = b0; k < b1; ++k) sum += hist[k];
  FdbSum total;
  int run = fdb_block_exclusive_scan(FdbSum{sum}, FdbSumOp(), FdbSum{0},
                                     sh_scan, &total).v;
  for (int k = b0; k < b1; ++k) {
    run += hist[k];
    out[t * QT + sorted.idx[k]] = run;
  }
}

// out (R, C) = zeros with x (NX, C) written from row start: the offset
// *off (plus R where it is negative), clamped to [0, R - NX], which is
// where the Pallas body's dynamic slice `o_ref[pl.ds(off, 8), :]` writes
// its rows (a dynamic update slice normalises a negative start and clamps
// it so that the rows fit). A block writes rows [r0, r1) of out, a row a
// warp at a time (blockDim (DYN_TX, DYN_TY)), VEC columns a thread: no
// division on the element's path, and *off read once a block, by one
// thread, into shared memory.
#define DYN_TX 32
#define DYN_TY 8

template <int VEC>
__global__ void __launch_bounds__(DYN_TX * DYN_TY)
probe_dynwrite_kernel(const int32_t* __restrict__ off,
                      const int32_t* __restrict__ x, int NX, int R, int C,
                      int rows_per_block, int32_t* __restrict__ out) {
  typedef typename ProbeVec<VEC>::T T;
  __shared__ int sh_start;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const int o = *off;
    const int s = o < 0 ? o + R : o;  // no overflow: o < 0 <= R
    sh_start = max(0, min(s, R - NX));
  }
  __syncthreads();
  const int start = sh_start;
  const int cv = C / VEC;  // VEC divides C (the host checks)
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  const T zero{};
  for (int r = r0 + threadIdx.y; r < r1; r += DYN_TY) {
    const int k = r - start;  // start in [0, R - NX], so no overflow
    T* dst = reinterpret_cast<T*>(out + (size_t)r * C);
    if (k >= 0 && k < NX) {
      const T* src = reinterpret_cast<const T*>(x + (size_t)k * C);
      for (int c = threadIdx.x; c < cv; c += DYN_TX) dst[c] = src[c];
    } else {
      for (int c = threadIdx.x; c < cv; c += DYN_TX) dst[c] = zero;
    }
  }
}

static int probe_blocks(long long n) {
  return (int)((n + PROBE_THREADS - 1) / PROBE_THREADS);
}

extern "C" int fdb_probe_add(const int32_t* x, int32_t* out, long long n,
                             void* stream) {
  if (n > 0)
    probe_add_kernel<<<probe_blocks(n), PROBE_THREADS, 0,
                       (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

// out: L int32, zero on entry
extern "C" int fdb_probe_stream(const int32_t* s, int K, int L,
                                long long s_row, long long s_limb,
                                int is_unsigned, int32_t* out, void* stream) {
  // a couple of blocks per SM, each looping over its rows
  const int want = probe_blocks(K);
  const int blocks = want < 1 ? 1 : (want > 2 * 132 ? 2 * 132 : want);
  if (is_unsigned)
    probe_stream_kernel<true><<<blocks, PROBE_THREADS, 0,
                                (cudaStream_t)stream>>>(s, K, L, s_row,
                                                        s_limb, out);
  else
    probe_stream_kernel<false><<<blocks, PROBE_THREADS, 0,
                                 (cudaStream_t)stream>>>(s, K, L, s_row,
                                                         s_limb, out);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a rank-join CTA takes: two buffers of QT keys (8
// bytes) and indices (2), QT x (LK - 2) tail limbs and QT + 1 bins (4).
static size_t rank_smem_bytes(int QT, int LK) {
  const int ntail = LK > RANK_PRIMARY ? LK - RANK_PRIMARY : 0;
  return (size_t)QT * 2 * (2 * sizeof(uint32_t) + sizeof(uint16_t)) +
         ((size_t)ntail * QT + QT + 1) * sizeof(uint32_t);
}
static int g_rank_smem[64];

// One CTA of RANK_THREADS a tile (NT of them); the wrapper refuses queries
// that do not fit (more than RANK_MAX_QT, or rank_smem_bytes past the
// device's opt-in shared memory).
extern "C" int fdb_probe_rank(const int32_t* s, const int32_t* q, int NT,
                              int TILE, int QT, int LK, long long s_row,
                              long long s_limb, long long q_tile,
                              long long q_q, long long q_limb,
                              int is_unsigned, int32_t* out, void* stream) {
  if (NT < 0 || TILE < 0 || QT < 0 || QT > RANK_MAX_QT || LK < 1 ||
      LK > PROBE_MAX_L)
    return (int)cudaErrorInvalidValue;
  if (NT == 0 || QT == 0) return (int)cudaSuccess;
  const size_t smem = rank_smem_bytes(QT, LK);
  int dev = 0;
  FdbDeviceLimits lim;
  cudaError_t e = fdb_device_limits(&dev, &lim);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)lim.smem_optin) return (int)cudaErrorInvalidValue;
  e = fdb_allow_smem(probe_rank_kernel, dev, smem, g_rank_smem);
  if (e != cudaSuccess) return (int)e;
  probe_rank_kernel<<<NT, RANK_THREADS, smem, (cudaStream_t)stream>>>(
      s, q, TILE, QT, LK, s_row, s_limb, q_tile, q_q, q_limb,
      is_unsigned ? 0u : 0x80000000u, out);
  return (int)cudaGetLastError();
}

// As many blocks as keep a block's rows to DYN_BLOCK_BYTES of output (16
// at the script's 32 KB), 16-byte columns where C is a multiple of 4 and
// both pointers are 16-byte aligned. NX may not pass R (the Pallas slice
// cannot either).
#define DYN_BLOCK_BYTES 2048

extern "C" int fdb_probe_dynwrite(const int32_t* off, const int32_t* x,
                                  int NX, int R, int C, int32_t* out,
                                  void* stream) {
  if (NX < 0 || R < 0 || C < 0 || NX > R) return (int)cudaErrorInvalidValue;
  if ((long long)R * C == 0) return (int)cudaSuccess;
  long long b = ((long long)R * C * 4 + DYN_BLOCK_BYTES - 1) /
                DYN_BLOCK_BYTES;
  if (b > R) b = R;
  const int rows_per_block = (int)((R + b - 1) / b);
  const int blocks = (R + rows_per_block - 1) / rows_per_block;
  const bool vec4 = C % 4 == 0 && ((uintptr_t)x & 15u) == 0 &&
                    ((uintptr_t)out & 15u) == 0;
  const dim3 threads(DYN_TX, DYN_TY);
  if (vec4)
    probe_dynwrite_kernel<4><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        off, x, NX, R, C, rows_per_block, out);
  else
    probe_dynwrite_kernel<1><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        off, x, NX, R, C, rows_per_block, out);
  return (int)cudaGetLastError();
}
