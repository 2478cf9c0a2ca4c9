// K6 endpoint_sort: the batch endpoints [rb | re | wb | we] sorted by
// (limb 0, ..., limb L-1, class, endpoint index), class re(0) < the rest(2).
//
// Replaces: the first half of foundationdb_tpu/ops/conflict.py
// `conflict_step` phase 0 (:397-421), the one `lax.sort` of
// [state | rb | re | wb | we]. The K state keys arrive sorted, so only the
// M = 2NR + 2NW endpoints are sorted here; K7 (state_merge.cu) merges them
// into the state. The order is total (the index breaks every tie), so the
// output is unique and equals the plain stable sort element for element.
//
// Two launches, on the caller's stream:
//   endpoint_tile_sort (one CTA per tile of 1,024 endpoints): the tile's
//       limbs go to shared memory in index order, eight loads in flight a
//       thread. Each element gets a 64-bit primary key, the two limbs from
//       the first limb on which the tile's keys differ (the limbs before it
//       are equal across the tile, so the order is unchanged), and a
//       bitonic network sorts the (primary key, index) pairs. Thread t
//       holds elements 2t and 2t + 1 in registers: a stage of stride 1 is
//       within the thread, strides 2 to 32 are shuffles between the lanes
//       of a warp, and only the 10 stages of stride 64 or more go through
//       shared memory with a block barrier. Where limbs remain past the
//       primary key, equal keys share an id, the index of the one that
//       claimed their slot of a hash table in shared memory first, so a
//       tie of the primary key reads the remaining limbs only when the keys
//       differ; equal keys go by class and index. The sorted run (keys and
//       endpoint indices) is written out. Padding past M sorts last and is
//       not written.
//   endpoint_merge (cooperative, persistent; only when there are two tiles
//       or more): every merge round of the sort, ceil(log2(tiles)) of
//       them (4 at M = 16,384, 6 at 65,536, 7 at 131,072), with a grid
//       barrier between rounds. A round merges pairs of sorted runs of
//       width w into runs of 2w, 512 outputs a CTA at a time: warps 0 and 1
//       find the merge-path co-ranks of the CTA's first and last output
//       (fdb_warp_corank over global memory); the two input slices go to
//       shared memory, many loads in flight a thread; the first limb on
//       which the slices vary comes from their ends (each slice is sorted),
//       and each slice element gets its 64-bit primary key from there, so
//       a comparison is one load a side unless the primary keys tie; each
//       thread finds the co-rank of its first of two consecutive outputs
//       there, takes both with one merge step more, and writes them, so the
//       writes are coalesced. Within a pair every index of the
//       left run is below every index of the right one: at equal (key,
//       class) the left element comes first. The rounds alternate between
//       the output and a scratch buffer, starting where the last round
//       lands in the output; the buffers are read past L1 (__ldcg), since
//       other CTAs rewrite them within the launch.
//
// Bound on H100: bytes. It reads the endpoints once (L * M int32) and
// writes (L + 1) * M int32: 2.9 MB at M = 65,536 and L = 5 (~0.9 us);
// each round moves that again through L2. Both kernels are latency bound:
// a round is a co-rank search and the slice loads (each a chain of L2
// round trips), the merge in shared memory and a grid barrier, in
// comparable shares. Runs sorted in one CTA past 1,024 endpoints, or by
// clusters of CTAs through distributed shared memory, were slower on an
// NVIDIA H100 80GB HBM3 (700 W) than the rounds they saved (PERF.md).
#include "common.cuh"

#define SORT_TILE 1024
#define SORT_THREADS (SORT_TILE / 2)
#define HASH_SLOTS (2 * SORT_TILE)
#define MERGE_THREADS 256
#define MERGE_TILE 512  // outputs per CTA a round; divides 2 * SORT_TILE
#define SORT_LOADS 8  // global loads in flight a thread

// Limb l of endpoint j of [rb | re | wb | we].
__device__ __forceinline__ int32_t endpoint_limb(
    const int32_t* __restrict__ rb, const int32_t* __restrict__ re,
    const int32_t* __restrict__ wb, const int32_t* __restrict__ we, int NR,
    int NW, int l, int j) {
  if (j < NR) return rb[(long long)l * NR + j];
  if (j < 2 * NR) return re[(long long)l * NR + j - NR];
  if (j < 2 * NR + NW) return wb[(long long)l * NW + j - 2 * NR];
  return we[(long long)l * NW + j - 2 * NR - NW];
}

// n int32 from `load(i)` into shared memory `dst[i]`, SORT_LOADS loads in
// flight a thread: a load and a store a step would wait out each load.
template <typename Load>
__device__ __forceinline__ void batched_load(int32_t* dst, int n, Load load) {
  for (int i0 = threadIdx.x; i0 < n; i0 += SORT_LOADS * blockDim.x) {
    int32_t v[SORT_LOADS];
#pragma unroll
    for (int u = 0; u < SORT_LOADS; ++u) {
      const int i = i0 + u * blockDim.x;
      v[u] = i < n ? load(i) : 0;
    }
#pragma unroll
    for (int u = 0; u < SORT_LOADS; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) dst[i] = v[u];
    }
  }
}

// Order-preserving 64-bit primary key of a tile element: limbs f and f + 1
// (the first limb on which the tile varies, and the next), unsigned.
__device__ __forceinline__ unsigned long long primary_key(const int32_t* sk,
                                                          int L, int f,
                                                          int x) {
  if (f >= L) return 0ull;
  const unsigned int hi = (unsigned int)sk[f * SORT_TILE + x] ^ 0x80000000u;
  const unsigned int lo =
      f + 1 < L ? (unsigned int)sk[(f + 1) * SORT_TILE + x] ^ 0x80000000u
                : 0u;
  return ((unsigned long long)hi << 32) | lo;
}

__global__ void __launch_bounds__(SORT_THREADS)
endpoint_tile_sort_kernel(const int32_t* __restrict__ rb,
                          const int32_t* __restrict__ re,
                          const int32_t* __restrict__ wb,
                          const int32_t* __restrict__ we, int L, int NR,
                          int NW, int M, int32_t* out_keys,
                          int32_t* out_ids) {
  extern __shared__ int32_t sh[];
  int32_t* sk = sh;  // L * SORT_TILE limbs, by tile-local index
  unsigned long long* sp =
      reinterpret_cast<unsigned long long*>(sh + L * SORT_TILE);
  int32_t* sid = reinterpret_cast<int32_t*>(sp + SORT_TILE);
  int32_t* sdup = sid + SORT_TILE;  // an id shared by equal keys
  int32_t* slot = sdup + SORT_TILE;  // hash table of HASH_SLOTS
  __shared__ unsigned int sh_mask;
  const int base = blockIdx.x * SORT_TILE;
  const int cnt = min(SORT_TILE, M - base);
  for (int x = threadIdx.x; x < HASH_SLOTS; x += blockDim.x) slot[x] = -1;
  batched_load(sk, L * SORT_TILE, [=](int i) -> int32_t {
    const int l = i / SORT_TILE, x = i - l * SORT_TILE;
    return x < cnt ? endpoint_limb(rb, re, wb, we, NR, NW, l, base + x) : 0;
  });
  const int f = fdb_first_varying_limb(sk, SORT_TILE, cnt, L, &sh_mask);
  const int rest = max(0, L - f - 2);  // limbs past the primary key
  // equal keys get the index of the one that claimed their hash slot
  // first, so a tie of equal keys costs two loads, not 2 L (without limbs
  // past the primary key, equal primary keys are equal keys)
  for (int x = threadIdx.x; rest > 0 && x < cnt; x += blockDim.x) {
    unsigned int h = 0x811C9DC5u;
    for (int l = f; l < L; ++l)
      h = (h ^ (unsigned int)sk[l * SORT_TILE + x]) * 0x01000193u;
    for (int q = (int)(h & (HASH_SLOTS - 1));;
         q = (q + 1) & (HASH_SLOTS - 1)) {
      const int owner = atomicCAS(&slot[q], -1, x);
      if (owner < 0) {
        sdup[x] = x;
        break;
      }
      if (fdb_key_cmp(sk + f * SORT_TILE + owner, SORT_TILE,
                      sk + f * SORT_TILE + x, SORT_TILE, L - f) == 0) {
        sdup[x] = owner;
        break;
      }
    }
  }
  for (int x = threadIdx.x; x < SORT_TILE; x += blockDim.x) {
    sid[x] = x;  // >= cnt: padding, after every element
    sp[x] = x < cnt ? primary_key(sk, L, f, x) : ~0ull;
  }
  __syncthreads();
  // (pa, a) after (pb, b): primary key, the limbs after it, class, index
  const int32_t* sk_rest = sk + (long long)min(f + 2, L) * SORT_TILE;
  auto after = [&](unsigned long long pa, int a, unsigned long long pb,
                   int b) -> bool {
    if (pa != pb) return pa > pb;
    if (a >= cnt || b >= cnt) return a >= cnt && (b < cnt || a > b);
    if (rest > 0 && sdup[a] != sdup[b])  // keys that differ past it
      return fdb_key_cmp(sk_rest + a, SORT_TILE, sk_rest + b, SORT_TILE,
                         rest) > 0;
    const int ca = fdb_endpoint_cls(base + a, NR);
    const int cb = fdb_endpoint_cls(base + b, NR);
    return ca != cb ? ca > cb : a > b;
  };
  // bitonic network over the (primary key, index) pairs. Thread t holds
  // elements 2t and 2t + 1 in registers: a stage of stride 1 is within
  // the thread, one of stride 2 to 32 between lanes of a warp (a
  // shuffle), and only the strides of 64 and more go through shared
  // memory with a block barrier (10 of the 55 stages)
  const int t = threadIdx.x;
  unsigned long long p[2] = {sp[2 * t], sp[2 * t + 1]};
  int id[2] = {sid[2 * t], sid[2 * t + 1]};
  for (int k = 2; k <= SORT_TILE; k <<= 1) {
    if (k >= 128) {  // strides k / 2 .. 64 in shared memory
      sp[2 * t] = p[0];
      sp[2 * t + 1] = p[1];
      sid[2 * t] = id[0];
      sid[2 * t + 1] = id[1];
      __syncthreads();
      for (int s = k >> 1; s >= 64; s >>= 1) {
        const int i = ((t & ~(s - 1)) << 1) | (t & (s - 1));
        const unsigned long long pa = sp[i], pb = sp[i + s];
        const int a = sid[i], b = sid[i + s];
        if (after(pa, a, pb, b) == ((i & k) == 0)) {
          sp[i] = pb;
          sp[i + s] = pa;
          sid[i] = b;
          sid[i + s] = a;
        }
        __syncthreads();
      }
      p[0] = sp[2 * t];
      p[1] = sp[2 * t + 1];
      id[0] = sid[2 * t];
      id[1] = sid[2 * t + 1];
      __syncthreads();
    }
    for (int s = min(k >> 1, 32); s >= 2; s >>= 1) {  // between lanes
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 2 * t + h;  // its partner e ^ s is in lane t ^ s/2
        const unsigned long long q =
            __shfl_xor_sync(0xffffffffu, p[h], s >> 1);
        const int qid = __shfl_xor_sync(0xffffffffu, id[h], s >> 1);
        // the lower position of the pair takes the first of the two in
        // the pair's direction (ascending where (lower & k) == 0)
        const bool lower = (e & s) == 0;
        const bool up = ((lower ? e : e ^ s) & k) == 0;
        const bool mine_after = after(p[h], id[h], q, qid);
        if (mine_after == (lower == up)) {
          p[h] = q;
          id[h] = qid;
        }
      }
    }
    // stride 1: within the thread
    if (after(p[0], id[0], p[1], id[1]) == (((2 * t) & k) == 0)) {
      const unsigned long long tp = p[0];
      const int ti = id[0];
      p[0] = p[1];
      id[0] = id[1];
      p[1] = tp;
      id[1] = ti;
    }
  }
  sp[2 * t] = p[0];
  sp[2 * t + 1] = p[1];
  sid[2 * t] = id[0];
  sid[2 * t + 1] = id[1];
  __syncthreads();
  for (int x = threadIdx.x; x < cnt; x += blockDim.x) {
    const int p = sid[x];
    out_ids[base + x] = base + p;
    for (int l = 0; l < L; ++l)
      out_keys[(long long)l * M + base + x] = sk[l * SORT_TILE + p];
  }
}

// One CTA's share of a merge round: outputs [q0, q0 + MERGE_TILE) of the
// pair of runs of width w that holds output tile `tile`.
__device__ void merge_tile(const int32_t* in_keys, const int32_t* in_ids,
                           int L, int M, int NR, int w, int tile,
                           int32_t* out_keys, int32_t* out_ids, int32_t* sk,
                           int32_t* sid, unsigned long long* sp,
                           int* s_corank, int* s_f) {
  const int o_begin = tile * MERGE_TILE;
  const int base = o_begin / (2 * w) * (2 * w);  // the pair holding the tile
  const int nA = min(w, M - base);
  const int nB = max(0, min(w, M - base - w));
  const int q0 = o_begin - base;
  const int q1 = min(q0 + MERGE_TILE, nA + nB);
  const int32_t* A = in_keys + base;
  const int32_t* B = A + w;
  const int32_t* idA = in_ids + base;
  const int32_t* idB = idA + w;
  // A[i] before B[k]: (key, class) not above B's (A's indices are lower);
  // the compare returns at the first limb that differs (SELECTS off: the
  // faster here)
  auto before = [&](int i, int k) -> bool {
    const int ja = __ldcg(idA + i), jb = __ldcg(idB + k);  // with the keys
    const int c = fdb_key_cmp_wide<8, true, false>(A + i, M, B + k, M, L);
    if (c != 0) return c < 0;
    return fdb_endpoint_cls(ja, NR) <= fdb_endpoint_cls(jb, NR);
  };
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int c = fdb_warp_corank(warp == 0 ? q0 : q1, nA, nB, before);
    if ((threadIdx.x & 31) == 0) s_corank[warp] = c;
  }
  __syncthreads();
  const int a0 = s_corank[0], a1 = s_corank[1];
  const int b0 = q0 - a0, b1 = q1 - a1;
  const int na = a1 - a0, nb = b1 - b0;
  // the two slices, A's then B's, many loads in flight a thread
  auto src = [=](int x) -> long long {
    return base + (x < na ? a0 + x : w + b0 + (x - na));
  };
  batched_load(sid, na + nb, [=](int x) { return __ldcg(in_ids + src(x)); });
  batched_load(sk, L * MERGE_TILE, [=](int i) -> int32_t {
    const int l = i / MERGE_TILE, x = i - l * MERGE_TILE;
    return x < na + nb ? __ldcg(in_keys + (long long)l * M + src(x)) : 0;
  });
  __syncthreads();
  // f: the limbs before it are equal across both slices. Each slice is
  // sorted, so that holds when it holds for the ends of both
  const int n = na + nb;
  if (threadIdx.x < 32) {  // lane l looks at limb l (L <= 32)
    const int32_t* row = sk + threadIdx.x * MERGE_TILE;
    const bool differ =
        (int)threadIdx.x < L &&
        (row[n - 1] != row[0] || (na > 0 && row[na - 1] != row[0]) ||
         (nb > 0 && row[na] != row[0]));
    const unsigned int d = __ballot_sync(0xffffffffu, differ);
    if (threadIdx.x == 0) *s_f = d ? __ffs(d) - 1 : L;
  }
  __syncthreads();
  const int f = *s_f;
  // each slice element's 64-bit primary key: limbs f and f + 1, unsigned
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    const unsigned int hi =
        f < L ? (unsigned int)sk[f * MERGE_TILE + x] ^ 0x80000000u : 0u;
    const unsigned int lo = f + 1 < L
        ? (unsigned int)sk[(f + 1) * MERGE_TILE + x] ^ 0x80000000u : 0u;
    sp[x] = ((unsigned long long)hi << 32) | lo;
  }
  __syncthreads();
  const int32_t* skr = sk + (long long)min(f + 2, L) * MERGE_TILE;
  const int rest = max(0, L - f - 2);
  // A's slice element i before B's k: the primary key, the limbs after it,
  // the class (A's indices are lower)
  auto local_before = [=](int i, int k) -> bool {
    const int y = na + k;
    if (sp[i] != sp[y]) return sp[i] < sp[y];
    const int c = fdb_key_cmp_wide<4>(skr + i, MERGE_TILE, skr + y,
                                      MERGE_TILE, rest);
    if (c != 0) return c < 0;
    return fdb_endpoint_cls(sid[i], NR) <= fdb_endpoint_cls(sid[y], NR);
  };
  // each thread two consecutive outputs: one co-rank, then a merge step
  for (int q = 2 * threadIdx.x; q < n; q += 2 * blockDim.x) {
    int i = fdb_corank(q, na, nb, local_before);
    int k = q - i;
    for (int u = q; u < min(q + 2, n); ++u) {
      const int src =
          (i < na && (k >= nb || local_before(i, k))) ? i++ : na + k++;
      const long long o = (long long)base + q0 + u;
      out_ids[o] = sid[src];
      for (int l = 0; l < L; ++l)
        out_keys[(long long)l * M + o] = sk[l * MERGE_TILE + src];
    }
  }
  __syncthreads();  // the shared slices are free for the next tile
}

// Every merge round: round r reads buffer (first + r) % 2 and writes the
// other one; a grid barrier separates the rounds.
__global__ void __launch_bounds__(MERGE_THREADS)
endpoint_merge_kernel(int32_t* keys0, int32_t* ids0, int32_t* keys1,
                      int32_t* ids1, int L, int M, int NR, int rounds,
                      int first, unsigned int* sync) {
  extern __shared__ int32_t sh[];
  int32_t* sk = sh;                    // L * MERGE_TILE: A's slice, then B's
  int32_t* sid = sh + L * MERGE_TILE;  // MERGE_TILE indices, same order
  // MERGE_TILE primary keys, same order
  unsigned long long* sp =
      reinterpret_cast<unsigned long long*>(sid + MERGE_TILE);
  __shared__ int s_corank[2];
  __shared__ int s_f;
  const int n_tiles = (M + MERGE_TILE - 1) / MERGE_TILE;
  for (int r = 0; r < rounds; ++r) {
    const bool from1 = ((first + r) & 1) != 0;
    const int w = SORT_TILE << r;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
      merge_tile(from1 ? keys1 : keys0, from1 ? ids1 : ids0, L, M, NR, w,
                 tile, from1 ? keys0 : keys1, from1 ? ids0 : ids1, sk, sid,
                 sp, s_corank, &s_f);
    if (r + 1 < rounds) fdb_grid_sync(sync);
  }
}

// Dynamic shared memory granted to each kernel, per device.
static int g_sort_smem[64], g_merge_smem[64];

// rb, re: (L, NR); wb, we: (L, NW). The sorted endpoints land in out_keys
// (L, M) and out_ids (M); tmp_keys/tmp_ids are scratch of the same sizes;
// sync is one zeroed word (the merge's grid barrier leaves its low bits
// zero). M = 2NR + 2NW >= 1. One launch, or two when M > 1,024.
extern "C" int fdb_endpoint_sort(const int32_t* rb, const int32_t* re,
                                 const int32_t* wb, const int32_t* we, int L,
                                 int NR, int NW, int32_t* out_keys,
                                 int32_t* out_ids, int32_t* tmp_keys,
                                 int32_t* tmp_ids, unsigned int* sync,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M = 2 * NR + 2 * NW;
  if (L < 1 || L > 32 || M < 1) return (int)cudaErrorInvalidValue;
  const int n_tiles = (M + SORT_TILE - 1) / SORT_TILE;
  int rounds = 0;
  while ((1 << rounds) < n_tiles) ++rounds;
  const int first = rounds % 2;  // so that the last round writes the output
  int32_t* keys[2] = {out_keys, tmp_keys};
  int32_t* ids[2] = {out_ids, tmp_ids};
  const size_t sort_smem =
      ((size_t)(L + 4) * SORT_TILE + HASH_SLOTS) * sizeof(int32_t);
  int dev = 0;
  FdbDeviceLimits lim;
  cudaError_t e = fdb_device_limits(&dev, &lim);
  if (e == cudaSuccess)
    e = fdb_allow_smem(endpoint_tile_sort_kernel, dev, sort_smem,
                       g_sort_smem);
  if (e != cudaSuccess) return (int)e;
  endpoint_tile_sort_kernel<<<n_tiles, SORT_THREADS, sort_smem, st>>>(
      rb, re, wb, we, L, NR, NW, M, keys[first], ids[first]);
  e = cudaGetLastError();
  if (e != cudaSuccess || rounds == 0) return (int)e;

  // limbs and ids (L + 1 rows), then the primary keys (2 rows)
  const size_t merge_smem = (size_t)(L + 3) * MERGE_TILE * sizeof(int32_t);
  e = fdb_allow_smem(endpoint_merge_kernel, dev, merge_smem, g_merge_smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, endpoint_merge_kernel, MERGE_THREADS, merge_smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int want = (M + MERGE_TILE - 1) / MERGE_TILE;
  const int cap = lim.sms * per_sm;
  const int G = want < cap ? want : cap;
  void* params[] = {&keys[0], &ids[0], &keys[1], &ids[1], (void*)&L,
                    (void*)&M, (void*)&NR, &rounds, (void*)&first, &sync};
  e = cudaLaunchCooperativeKernel((const void*)endpoint_merge_kernel,
                                  dim3(G), dim3(MERGE_THREADS), params,
                                  merge_smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
