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
//                                                     offset
//
// A TPU grid runs its steps in order on one core, and the Pallas stream
// carries its maximum across them in the output block; here blocks run in
// parallel, so each reduces its rows in registers and shared memory and
// folds into the output with one atomic max per limb. The rank join stages
// a state tile in shared memory (limb-major, so every thread of a warp reads
// the same word) and gives each thread one query; the lexicographic compare
// stops at the first limb that differs. The uint32 probes of ab_pallas.py
// pass their bits as int32 and compare unsigned (`is_unsigned`).
//
// Bounds on H100 at the scripts' shapes (K = 2^18 rows, L = 8 limbs,
// TILE = 2,048): the stream pass reads 8 MB, 2.5 us of HBM time; join does
// 6.7e7 one-limb compares on 9 MB; lexjoin does 2.7e8 pair compares
// (about 1e9 operations with the first limb deciding almost every pair) on
// 12.6 MB, so it is bound by operations; add and dynwrite are launch
// latency.
#include "common.cuh"

#define PROBE_THREADS 256
#define PROBE_MAX_L 8

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

// out[t * QT + q] = #{i < TILE : key(s row t * TILE + i) < key(query t, q)}
// over the first LK limbs; block (query chunk, tile t), state tile staged
// limb-major in dynamic shared memory (LK * TILE int32)
template <bool U>
__global__ void __launch_bounds__(PROBE_THREADS)
probe_rank_kernel(const int32_t* __restrict__ s, const int32_t* __restrict__ q,
                  int TILE, int QT, int LK, long long s_row, long long s_limb,
                  long long q_tile, long long q_q, long long q_limb,
                  int32_t* __restrict__ out) {
  extern __shared__ int32_t sm[];
  const long long t = blockIdx.y;
  for (int idx = threadIdx.x; idx < TILE * LK; idx += blockDim.x) {
    const int l = idx / TILE, i = idx - l * TILE;
    sm[idx] = s[(t * TILE + i) * s_row + l * s_limb];
  }
  __syncthreads();
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= QT) return;
  int32_t qv[PROBE_MAX_L];
#pragma unroll
  for (int l = 0; l < PROBE_MAX_L; ++l)
    qv[l] = l < LK ? q[t * q_tile + qi * q_q + l * q_limb] : 0;
  int count = 0;
  for (int i = 0; i < TILE; ++i) {
    bool lt = false;
#pragma unroll
    for (int l = 0; l < PROBE_MAX_L; ++l) {
      if (l < LK) {
        const int32_t a = sm[l * TILE + i];
        if (a != qv[l]) {
          lt = probe_lt<U>(a, qv[l]);
          break;
        }
      }
    }
    count += lt;
  }
  out[t * QT + qi] = count;
}

// out (R, C) = zeros with rows [*off, *off + NX) taken from x (NX, C); rows
// that fall outside [0, R) are dropped
__global__ void probe_dynwrite_kernel(const int32_t* __restrict__ off,
                                      const int32_t* __restrict__ x, int NX,
                                      int R, int C, int32_t* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)R * C) return;
  const int r = (int)(idx / C), col = (int)(idx - (long long)r * C);
  const int k = r - *off;
  out[idx] = (k >= 0 && k < NX) ? x[(long long)k * C + col] : 0;
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

extern "C" int fdb_probe_rank(const int32_t* s, const int32_t* q, int NT,
                              int TILE, int QT, int LK, long long s_row,
                              long long s_limb, long long q_tile,
                              long long q_q, long long q_limb,
                              int is_unsigned, int32_t* out, void* stream) {
  const dim3 grid(probe_blocks(QT), NT);
  const size_t smem = (size_t)TILE * LK * sizeof(int32_t);
  if (is_unsigned)
    probe_rank_kernel<true><<<grid, PROBE_THREADS, smem,
                              (cudaStream_t)stream>>>(
        s, q, TILE, QT, LK, s_row, s_limb, q_tile, q_q, q_limb, out);
  else
    probe_rank_kernel<false><<<grid, PROBE_THREADS, smem,
                               (cudaStream_t)stream>>>(
        s, q, TILE, QT, LK, s_row, s_limb, q_tile, q_q, q_limb, out);
  return (int)cudaGetLastError();
}

extern "C" int fdb_probe_dynwrite(const int32_t* off, const int32_t* x,
                                  int NX, int R, int C, int32_t* out,
                                  void* stream) {
  const long long n = (long long)R * C;
  if (n > 0)
    probe_dynwrite_kernel<<<probe_blocks(n), PROBE_THREADS, 0,
                            (cudaStream_t)stream>>>(off, x, NX, R, C, out);
  return (int)cudaGetLastError();
}
