// K1 sparse_table: the (LEVELS, K) power-of-two window maxima of the
// conflict state's segment versions.
//
// Replaces: foundationdb_tpu/ops/conflict.py `_build_table` (:145-160), the
// XLA program the JAX step runs after every merge (`_merge_phase` :691),
// in `rebase_state` (:707-718) and in `init_state`.
//   table[l][i] = max(vals[i .. i + 2^l)), FDB_NEG past K
// (a window that runs past K also takes FDB_NEG into its max). With the
// rebase (`rebase_state`, `_compiled_rebase` :761-768) folded in, the first
// launch shifts each value as it loads it, v' = max(v - delta, FDB_NEG)
// (0 <= delta <= 2^30, in 64 bits), writes v' out beside row 0, and builds
// the table of v'; CTA 0 shifts the 0-dim `oldest` the same way. So a
// rebase is the same at most two launches as a table build.
//
// Bound on H100: bytes. It reads K int32 and writes LEVELS * K int32: 20 MB
// at K = 2^18 (~6.3 us of HBM time), 92 MB at 2^20 (~27 us), 4.5 MB at
// 2^16 (~1.4 us, where two launches cost more than the bytes).
//
// Design: at most two launches for any K, every row written once.
//   1. table_low_kernel, a CTA per 1,024-column tile: the tile plus a
//      1,024-column halo is loaded once into shared memory, and each level
//      l <= 10 doubles the window in place (a barrier between read and
//      write). For K > 1,024 it also writes, per column, the maximum from
//      its tile's start (pre) and to its tile's end (suf), and each tile's
//      maximum (a block scan over the tile).
//   2. table_high_kernel, a CTA per tile, for the levels l >= 11 (only when
//      K > 1,024): a window of 2^l >= 2,048 columns starting at column i of
//      tile a ends at e = min(i + 2^l, K) - 1 in a later tile b, so its max
//      is max(suf[i], the whole tiles a+1 .. b-1, pre[e]). The CTA first
//      scans the maxima of the tiles after its own (a prefix max over at
//      most 2^(LEVELS-11) of them) and keeps the few prefixes its levels
//      ask for: index m - 3 (i at a tile start) and m - 2 (elsewhere) for
//      m = 2^(l-10), and the one that ends at the last tile, for windows
//      that K clips. If K clips a window inside tile a, suf[i] alone is its
//      max. Every thread then writes its column of every level l >= 11.
// Scratch (K > 1,024 only): pre and suf, K int32 each, and the tile
// maxima, all overwritten by launch 1 before launch 2 reads them. (A
// launch per level above 10, each reading the previous row, would make 8
// serial launches at K = 2^18 and 10 at 2^20.)
#include "common.cuh"

#define TILE 1024
#define LOW_LEVELS 11  // levels 0..10 come from launch 1

// The in-tile running maxima forward and backward, scanned together.
struct FdbMax2 {
  int fwd, bwd;
  static __device__ __forceinline__ FdbMax2 shfl_up(FdbMax2 x, int d) {
    return {fdb_shfl_up(x.fwd, d), fdb_shfl_up(x.bwd, d)};
  }
};
struct FdbMax2Op {
  __device__ __forceinline__ FdbMax2 operator()(FdbMax2 a, FdbMax2 b) const {
    return {max(a.fwd, b.fwd), max(a.bwd, b.bwd)};
  }
};

// v - delta, saturating at FDB_NEG.
__device__ __forceinline__ int32_t shift_down(int32_t v, long long delta) {
  const long long x = (long long)v - delta;
  return x < FDB_NEG ? FDB_NEG : (int32_t)x;
}

// Levels 0..lmax of one tile of the values shifted down by delta; with
// `pre` (K > 1,024) also pre, suf and the tile's maximum; with `shifted`
// the shifted values, and with `oldest` (CTA 0) the shifted oldest.
__global__ void __launch_bounds__(TILE)
table_low_kernel(const int32_t* __restrict__ vals, int32_t* __restrict__ table,
                 int K, int lmax, int32_t* __restrict__ pre,
                 int32_t* __restrict__ suf, int32_t* __restrict__ tile_max,
                 long long delta, const int32_t* __restrict__ oldest,
                 int32_t* __restrict__ shifted,
                 int32_t* __restrict__ oldest_out) {
  __shared__ int32_t a[2 * TILE];
  __shared__ FdbMax2 sh[32];
  const long long c0 = (long long)blockIdx.x * TILE;
  const int t = threadIdx.x;
  for (int j = t; j < 2 * TILE; j += TILE) {
    const long long i = c0 + j;
    a[j] = i < K ? shift_down(vals[i], delta) : FDB_NEG;
  }
  if (oldest != nullptr && blockIdx.x == 0 && t == 0)
    *oldest_out = shift_down(*oldest, delta);
  __syncthreads();
  const long long i = c0 + t;
  if (i < K) table[i] = a[t];
  if (shifted != nullptr && i < K) shifted[i] = a[t];
  if (pre != nullptr) {
    // thread t scans column t forward and column TILE - 1 - t backward;
    // columns past K hold FDB_NEG, which only the last tile's suf and
    // maximum see
    const FdbMax2 x = {a[t], a[TILE - 1 - t]};
    const FdbMax2Op op;
    FdbMax2 total;
    const FdbMax2 in =
        op(fdb_block_exclusive_scan(x, op, FdbMax2{INT_MIN, INT_MIN}, sh,
                                    &total),
           x);
    if (i < K) pre[i] = in.fwd;
    const long long ib = c0 + TILE - 1 - t;
    if (ib < K) suf[ib] = in.bwd;
    if (t == 0) tile_max[blockIdx.x] = total.fwd;
  }
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

// Levels LOW_LEVELS..levels-1 of one tile from launch 1's pre, suf and tile
// maxima.
__global__ void __launch_bounds__(TILE)
table_high_kernel(const int32_t* __restrict__ pre,
                  const int32_t* __restrict__ suf,
                  const int32_t* __restrict__ tile_max,
                  int32_t* __restrict__ table, int K, int levels) {
  // mid[0][j], mid[1][j]: max over the m - 2 and the m - 1 tiles after
  // this one (m = 2^(j+1), level l = LOW_LEVELS + j); mid_clip: over the
  // tiles between this one and the last; INT_MIN where there are none
  __shared__ int32_t mid[2][32];
  __shared__ int32_t mid_clip;
  __shared__ FdbMax sh[32];
  const int a = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int t = threadIdx.x;

  if (t < 32) mid[0][t] = mid[1][t] = INT_MIN;
  if (t == 0) mid_clip = INT_MIN;
  __syncthreads();
  // P[k] = max(tile_max[a + 1 .. a + 1 + k]); the levels ask for k up to
  // 2^(levels - LOW_LEVELS) - 2, and the clipped windows for n_tiles - a - 3
  const int n_mid = min(n_tiles - a - 1, (1 << (levels - LOW_LEVELS)) - 1);
  const FdbMaxOp op;
  int carry = INT_MIN;
  for (int k0 = 0; k0 < n_mid; k0 += TILE) {
    const int k = k0 + t;
    const FdbMax x = {k < n_mid ? tile_max[a + 1 + k] : INT_MIN};
    FdbMax total;
    const int p = max(carry, op(fdb_block_exclusive_scan(
                                    x, op, FdbMax{INT_MIN}, sh, &total),
                                x).v);
    if (k < n_mid) {
      const int k3 = k + 3, k2 = k + 2;  // k = m - 3 or k = m - 2
      if ((k3 & (k3 - 1)) == 0) mid[0][__ffs(k3) - 2] = p;
      if ((k2 & (k2 - 1)) == 0) mid[1][__ffs(k2) - 2] = p;
      if (k == n_tiles - a - 3) mid_clip = p;
    }
    carry = max(carry, total.v);
  }
  __syncthreads();
  const long long i = (long long)a * TILE + t;
  if (i >= K) return;

  const int32_t s = suf[i];
  for (int l = LOW_LEVELS; l < levels; ++l) {
    const long long end = i + (1LL << l);
    int32_t v;
    if (end > K) {
      // clipped: the window ends at column K - 1 and takes FDB_NEG in;
      // inside this tile suf alone covers it
      v = max(s, FDB_NEG);
      if ((K - 1) / TILE != a) v = max(v, max(mid_clip, pre[K - 1]));
    } else {
      v = max(s, max(mid[t != 0][l - LOW_LEVELS], pre[end - 1]));
    }
    table[(long long)l * K + i] = v;
  }
}

// scratch: 2 K + ceil(K / TILE) int32 when levels > LOW_LEVELS (else
// unused, may be NULL), overwritten. The table is of the values shifted
// down by delta (0 for a plain build); `oldest`, `shifted` (K int32) and
// `oldest_out` are all NULL, or all set for a rebase. One launch, or two
// for K > 1,024.
extern "C" int fdb_sparse_table(const int32_t* vals, int32_t* table, int K,
                                int levels, int32_t* scratch,
                                long long delta, const int32_t* oldest,
                                int32_t* shifted, int32_t* oldest_out,
                                void* stream) {
  if (K < 1 || levels < 1 || delta < 0 || delta > (1LL << 30) ||
      (oldest == nullptr) != (oldest_out == nullptr) ||
      (oldest == nullptr) != (shifted == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (K + TILE - 1) / TILE;
  const bool high = levels > LOW_LEVELS;
  if (high && scratch == nullptr) return (int)cudaErrorInvalidValue;
  int32_t* pre = high ? scratch : nullptr;
  int32_t* suf = high ? scratch + K : nullptr;
  int32_t* tile_max = high ? scratch + 2LL * K : nullptr;
  table_low_kernel<<<n_tiles, TILE, 0, st>>>(
      vals, table, K, high ? LOW_LEVELS - 1 : levels - 1, pre, suf, tile_max,
      delta, oldest, shifted, oldest_out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !high) return (int)e;
  table_high_kernel<<<n_tiles, TILE, 0, st>>>(pre, suf, tile_max, table, K,
                                              levels);
  return (int)cudaGetLastError();
}
