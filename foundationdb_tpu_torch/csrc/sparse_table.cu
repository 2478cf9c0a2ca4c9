// K1 sparse_table: the (LEVELS, K) power-of-two window maxima of the
// conflict state's segment versions.
//
// Replaces: foundationdb_tpu/ops/conflict.py `_build_table` (:145-160), the
// XLA program the JAX step runs after every merge (`_merge_phase` :691),
// in `rebase_state` (:707-718) and in `init_state`.
//   table[l][i] = max(vals[i .. i + 2^l)), FDB_NEG past K.
//
// Bound on H100: bytes. It reads K int32 and writes LEVELS*K int32 (4.5 MB
// at K = 65,536): ~1.3 us of HBM traffic, so launch count and latency
// dominate. Design: one launch builds levels 0..10 per 1,024-column tile in
// shared memory (the tile plus a 1,024-column halo is loaded once, each
// level doubles the window in place with a barrier between read and
// write); the remaining levels (11..LEVELS-1, six at K = 65,536) are one
// small doubling launch each from the previous row, which stays in L2.
#include "common.cuh"

#define TILE 1024

__global__ void __launch_bounds__(TILE)
table_low_kernel(const int32_t* __restrict__ vals, int32_t* __restrict__ table,
                 int K, int lmax) {
  __shared__ int32_t a[2 * TILE];
  const long long c0 = (long long)blockIdx.x * TILE;
  const int t = threadIdx.x;
  for (int j = t; j < 2 * TILE; j += TILE) {
    const long long i = c0 + j;
    a[j] = i < K ? vals[i] : FDB_NEG;
  }
  __syncthreads();
  const long long i = c0 + t;
  if (i < K) table[i] = a[t];
  // after level l, a[p] is exact for p <= 2*TILE - 2^l (so for every
  // output column p < TILE while l <= 10)
  for (int l = 1; l <= lmax; ++l) {
    const int s = 1 << (l - 1);
    const int j0 = t, j1 = t + TILE;
    const int32_t v0 = j0 + s < 2 * TILE ? max(a[j0], a[j0 + s]) : a[j0];
    const int32_t v1 = j1 + s < 2 * TILE ? max(a[j1], a[j1 + s]) : a[j1];
    __syncthreads();
    a[j0] = v0;
    a[j1] = v1;
    __syncthreads();
    if (i < K) table[(long long)l * K + i] = a[t];
  }
}

__global__ void table_level_kernel(int32_t* __restrict__ table, int K, int l) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K) return;
  const long long s = 1LL << (l - 1);
  const int32_t* prev = table + (long long)(l - 1) * K;
  const int32_t right = i + s < K ? prev[i + s] : FDB_NEG;
  table[(long long)l * K + i] = max(prev[i], right);
}

extern "C" int fdb_sparse_table(const int32_t* vals, int32_t* table, int K,
                                int levels, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int lmax = levels - 1 < 10 ? levels - 1 : 10;
  table_low_kernel<<<(K + TILE - 1) / TILE, TILE, 0, st>>>(vals, table, K,
                                                           lmax);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  for (int l = 11; l < levels; ++l) {
    table_level_kernel<<<(K + 255) / 256, 256, 0, st>>>(table, K, l);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
