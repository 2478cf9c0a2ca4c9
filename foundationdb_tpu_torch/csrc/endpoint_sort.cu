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
// Every path starts with the tile sort (tile_sort, one CTA per tile of
// 1,024 endpoints): the tile's limbs go to shared memory in index order,
// eight loads in flight a thread. Each element gets a 64-bit primary key,
// the two limbs from the first limb on which the tile's keys differ (the
// limbs before it are equal across the tile, so the order is unchanged),
// and a bitonic network sorts the (primary key, index) pairs. Thread t
// holds elements 2t and 2t + 1 in registers: a stage of stride 1 is within
// the thread, strides 2 to 32 are shuffles between the lanes of a warp,
// and only the 10 stages of stride 64 or more go through shared memory
// with a block barrier. Where limbs remain past the primary key, equal
// keys share an id, the index of the one that claimed their slot of a hash
// table in shared memory first, so a tie of the primary key reads the
// remaining limbs only when the keys differ; equal keys go by class and
// index. Padding past M sorts last and is not written.
//
// The host picks the path from the shape (kernels.sort_plan, which passes
// the samples a tile, 0 for the tile and rounds paths, and the tie limit),
// and the sample path's kernel picks between the sample sort and the
// merge rounds from the data:
//   tile (M <= 1,024): the rounds path's launch with no round: the tile
//       sort, into the output.
//   sample (from SORT_SAMPLE_MIN_TILES tiles where it fits): ONE
//       cooperative launch, a CTA a tile and a bucket, P = ceil(M / 1,024)
//       of them, and as many again where they fit (2P, as endpoint_merge
//       has), which only merge where the kernel turns to the rounds:
//       1. the tile sort; s samples of the run (positions g - 1, 2g - 1,
//          ..., 1,023, g = 1,024 / s; a position past the tile's end is
//          padding, after every endpoint) with their full keys go to the
//          sample array, and the run's ties (its endpoints whose primary
//          key is their predecessor's) to a word of the tile. Grid
//          barrier. Every CTA sums the ties. Past `tie_limit` (duplicate
//          keys, as under zipfian traffic, where the sample sort's
//          comparisons fall through to more limbs, class and index, and
//          it loses to the rounds), every CTA writes its run and takes
//          the merge rounds below (MERGE_TILE outputs a CTA a round with
//          2P CTAs, else 1,024). Else the sample sort, two more grid
//          barriers; the sorted run goes to the scratch runs;
//       2. each CTA loads every sample's 64-bit key (limbs F and F + 1,
//          F the first limb on which the samples vary) into shared memory
//          and ranks its own s against every other tile's sorted list by
//          bisection (no CTA ranks all of them; a tie of the keys reads
//          the ids and later limbs from L2); the sample of rank j s - 1
//          is splitter j (j = 1 .. P - 1), which its CTA writes out;
//       3. each CTA finds every splitter in its own run, still in shared
//          memory, by bisection: row b of the P x P matrix of how many of
//          run b's endpoints are at or below each splitter;
//       4. CTA j gathers bucket j, the pieces (splitter j, splitter j + 1]
//          of every run: its offset is the column sum of the matrix at
//          splitter j, so no scan is needed. The pieces go to shared
//          memory; the first limb on which they vary gives each element a
//          64-bit primary key; ceil(log2 P) merge rounds in shared memory
//          (each element bisects its partner run for its position) leave
//          them in order; the bucket is written at its offset, coalesced.
//       The bucket cap: the order is total, so regular sampling bounds a
//       bucket. Run i contributes a contiguous range holding c_i of the
//       bucket's samples, at most (c_i + 1) g - 1 endpoints (the gap below
//       its first sample and g a sample, and no gap above a run's last
//       sample), and the run holding the upper splitter at most c_i g, its
//       range ending there; the c_i sum to s, so a bucket holds at most
//       cap = (s + P - 1) g - P + 1 (padding included, counting the padded
//       tiles), which one tile of 1,024 and the first g - 1 endpoints of
//       every other tile attain. Shared memory is sized from the cap, so
//       no bucket can outgrow it.
//   rounds (a shape the sample path cannot hold: more tiles than SMs, or
//       a cap or samples past a CTA's shared memory at large L; or fewer
//       than SORT_SAMPLE_MIN_TILES tiles): endpoint_merge, one
//       cooperative persistent launch of the tile sort of every tile, a
//       grid barrier, then every merge-path round (ceil(log2(tiles)) of
//       them) with a grid barrier between rounds. A round merges pairs of
//       sorted runs of width w into runs of 2w, 512 outputs a CTA at a
//       time: warps 0 and 1 find the co-ranks of the CTA's first and last
//       output (fdb_warp_corank over global memory); the two input slices
//       go to shared memory; their first varying limb comes from their
//       ends, so a comparison is one 64-bit load a side unless the primary
//       keys tie; each thread takes two consecutive outputs. The rounds
//       alternate between the output and a scratch buffer, starting where
//       the last round lands in the output; the buffers are read past L1
//       (__ldcg), since other CTAs rewrite them within the launch.
//
// Bound on H100: bytes. It reads the endpoints once (L * M int32) and
// writes (L + 1) * M int32: 2.9 MB at M = 65,536 and L = 5 (~0.9 us). The
// kernel is latency bound: the tile sort's block barriers, the grid
// barriers, and chains of shared-memory bisection; the sample sort keeps
// the number of grid barriers at three whatever M is and has no co-rank
// search in L2.
#include "common.cuh"

#define SORT_TILE 1024
#define SORT_THREADS (SORT_TILE / 2)
#define HASH_SLOTS (2 * SORT_TILE)
#define MERGE_TILE 512  // outputs per CTA a round; divides 2 * SORT_TILE
#define SORT_LOADS 8  // global loads in flight a thread
#define SS_MAX_SAMPLES 64  // samples a tile, at most (a power of two)
#define SS_MIN_SAMPLES 8  // samples a tile, at least
#define SS_SAMPLE_BUDGET 8192  // samples of all tiles together, at most
#define SS_SMEM_MAX (227 * 1024 - 1024)  // dynamic shared memory, at most

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

// Order-preserving 64-bit key of limbs f and f + 1 (unsigned) of the key
// held limb-major at `k` with stride `stride`; 0 past the last limb.
__device__ __forceinline__ unsigned long long limb_pair(const int32_t* k,
                                                        long long stride,
                                                        int L, int f) {
  if (f >= L) return 0ull;
  const unsigned int hi = (unsigned int)k[f * stride] ^ 0x80000000u;
  const unsigned int lo =
      f + 1 < L ? (unsigned int)k[(f + 1) * stride] ^ 0x80000000u : 0u;
  return ((unsigned long long)hi << 32) | lo;
}

// Endpoint ia (class by NR) before ib at equal keys.
__device__ __forceinline__ bool index_before(int ia, int ib, int NR) {
  const int ca = fdb_endpoint_cls(ia, NR), cb = fdb_endpoint_cls(ib, NR);
  return ca != cb ? ca < cb : ia < ib;
}

// The tile sort of endpoints [base, base + cnt) in shared memory: on
// return (after a barrier) sk holds the tile's limbs by tile-local index
// (L * SORT_TILE), sp the sorted primary keys and sid the sorted
// tile-local indices (padding, >= cnt, last). sdup (SORT_TILE) and slot
// (HASH_SLOTS) are free again. Returns f, the first limb on which the
// tile's keys vary (L if they are all equal).
__device__ int tile_sort(const int32_t* __restrict__ rb,
                         const int32_t* __restrict__ re,
                         const int32_t* __restrict__ wb,
                         const int32_t* __restrict__ we, int L, int NR,
                         int NW, int base, int cnt, int32_t* sk,
                         unsigned long long* sp, int32_t* sid, int32_t* sdup,
                         int32_t* slot, unsigned int* sh_mask) {
  for (int x = threadIdx.x; x < HASH_SLOTS; x += blockDim.x) slot[x] = -1;
  batched_load(sk, L * SORT_TILE, [=](int i) -> int32_t {
    const int l = i / SORT_TILE, x = i - l * SORT_TILE;
    return x < cnt ? endpoint_limb(rb, re, wb, we, NR, NW, l, base + x) : 0;
  });
  const int f = fdb_first_varying_limb(sk, SORT_TILE, cnt, L, sh_mask);
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
    sp[x] = x < cnt ? limb_pair(sk + x, SORT_TILE, L, f) : ~0ull;
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
    return index_before(base + b, base + a, NR);
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
  return f;
}

// One CTA's share of a merge round: outputs [q0, q0 + MT) of the pair of
// runs of width w that holds output tile `tile` (MT divides 2 SORT_TILE).
template <int MT>
__device__ void merge_tile(const int32_t* in_keys, const int32_t* in_ids,
                           int L, int M, int NR, int w, int tile,
                           int32_t* out_keys, int32_t* out_ids, int32_t* sk,
                           int32_t* sid, unsigned long long* sp,
                           int* s_corank, int* s_f) {
  const int o_begin = tile * MT;
  const int base = o_begin / (2 * w) * (2 * w);  // the pair holding the tile
  const int nA = min(w, M - base);
  const int nB = max(0, min(w, M - base - w));
  const int q0 = o_begin - base;
  const int q1 = min(q0 + MT, nA + nB);
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
  batched_load(sk, L * MT, [=](int i) -> int32_t {
    const int l = i / MT, x = i - l * MT;
    return x < na + nb ? __ldcg(in_keys + (long long)l * M + src(x)) : 0;
  });
  __syncthreads();
  // f: the limbs before it are equal across both slices. Each slice is
  // sorted, so that holds when it holds for the ends of both
  const int n = na + nb;
  if (threadIdx.x < 32) {  // lane l looks at limb l (L <= 32)
    const int32_t* row = sk + threadIdx.x * MT;
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
  for (int x = threadIdx.x; x < n; x += blockDim.x)
    sp[x] = limb_pair(sk + x, MT, L, f);
  __syncthreads();
  const int32_t* skr = sk + (long long)min(f + 2, L) * MT;
  const int rest = max(0, L - f - 2);
  // A's slice element i before B's k: the primary key, the limbs after it,
  // the class (A's indices are lower)
  auto local_before = [=](int i, int k) -> bool {
    const int y = na + k;
    if (sp[i] != sp[y]) return sp[i] < sp[y];
    const int c = fdb_key_cmp_wide<4>(skr + i, MT, skr + y,
                                      MT, rest);
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
        out_keys[(long long)l * M + o] = sk[l * MT + src];
    }
  }
  __syncthreads();  // the shared slices are free for the next tile
}

// Every merge round after the runs of SORT_TILE: round r reads buffer
// (first + r) % 2 and writes the other one, MT outputs a CTA at a time; a
// grid barrier separates the rounds. `sh` holds (L + 3) MT int32.
template <int MT>
__device__ void merge_rounds(int32_t* keys0, int32_t* ids0, int32_t* keys1,
                             int32_t* ids1, int L, int M, int NR, int rounds,
                             int first, int32_t* sh, unsigned int* sync) {
  __shared__ int s_corank[2];
  __shared__ int s_f;
  int32_t* sk = sh;            // L * MT: A's slice, then B's
  int32_t* sid = sh + L * MT;  // MT indices, same order
  // MT primary keys, same order
  unsigned long long* sp = reinterpret_cast<unsigned long long*>(sid + MT);
  const int n_tiles = (M + MT - 1) / MT;
  for (int r = 0; r < rounds; ++r) {
    const bool from1 = ((first + r) & 1) != 0;
    const int w = SORT_TILE << r;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
      merge_tile<MT>(from1 ? keys1 : keys0, from1 ? ids1 : ids0, L, M, NR, w,
                     tile, from1 ? keys0 : keys1, from1 ? ids0 : ids1, sk,
                     sid, sp, s_corank, &s_f);
    if (r + 1 < rounds) fdb_grid_sync(sync);
  }
}

// Bucket cap of the sample path: P tiles, s samples a tile.
__host__ __device__ __forceinline__ int ss_cap(int P, int s) {
  return (s + P - 1) * (SORT_TILE / s) - P + 1;
}

// Dynamic shared memory of the sample path, in int32 words: the tile sort
// and the run it leaves (sk, sp, sid), beside the larger of its hash
// table, the samples' keys, ids and ranks, and the splitters; or the
// bucket (two orders of keys and slots, limbs, ids, positions' pieces) and
// its pieces' offsets, whichever is larger.
__host__ __device__ __forceinline__ long long ss_smem_words(int L, int P,
                                                            int s) {
  const long long run = (long long)(L + 3) * SORT_TILE;
  const long long ns = (long long)P * s;
  long long extra = 3 * SORT_TILE;
  if (2 * ns + s > extra) extra = 2 * ns + s;
  const long long splitters = (long long)(L + 1) * (P - 1);
  if (splitters > extra) extra = splitters;
  const long long bucket = (long long)(L + 8) * ss_cap(P, s) + 2 * P + 1;
  return run + extra > bucket ? run + extra : bucket;
}

// The sample path: one cooperative launch, a CTA a tile and a bucket;
// `runs_*` and `scratch` are scratch. Where more than `tie_limit` of the
// runs' endpoints tie their predecessor's primary key, the merge rounds
// instead, from the runs.
__global__ void __launch_bounds__(SORT_THREADS, 1)
endpoint_sample_kernel(const int32_t* __restrict__ rb,
                       const int32_t* __restrict__ re,
                       const int32_t* __restrict__ wb,
                       const int32_t* __restrict__ we, int L, int NR,
                       int NW, int M, int s, int tie_limit,
                       int32_t* runs_keys, int32_t* runs_ids,
                       int32_t* scratch, int32_t* out_keys, int32_t* out_ids,
                       unsigned int* sync) {
  extern __shared__ int32_t sh[];
  int32_t* sk = sh;  // L * SORT_TILE limbs, by tile-local index
  unsigned long long* sp =
      reinterpret_cast<unsigned long long*>(sh + L * SORT_TILE);
  int32_t* sid = reinterpret_cast<int32_t*>(sp + SORT_TILE);
  int32_t* extra = sid + SORT_TILE;  // the hash table, samples, splitters
  __shared__ unsigned int sh_mask;
  __shared__ int sh_total, sh_offset, sh_first;
  __shared__ unsigned int sh_ties;
  const int b = blockIdx.x;
  const int P = (M + SORT_TILE - 1) / SORT_TILE;  // tiles, and buckets
  const bool tiled = b < P;  // CTAs past P only merge, where turned
  const int base = b * SORT_TILE;
  const int cnt = tiled ? min(SORT_TILE, M - base) : 0;
  // the sorted run out, into `keys` and `ids` (L x M, M)
  auto run_out = [&](int32_t* keys, int32_t* ids) {
    for (int x = threadIdx.x; x < cnt; x += blockDim.x) {
      const int p = sid[x];
      ids[base + x] = base + p;
      for (int l = 0; l < L; ++l)
        keys[(long long)l * M + base + x] = sk[l * SORT_TILE + p];
    }
  };

  // scratch: the samples (L x NS limbs, NS ids), the splitters (L x (P -
  // 1) limbs, P - 1 ids), the P x P counts, each tile's first limb on
  // which its samples leave endpoint 0's key, each run's ties
  const int NS = P * s;
  const int g = SORT_TILE / s;
  int32_t* samp_keys = scratch;
  int32_t* samp_ids = samp_keys + (long long)L * NS;
  int32_t* spl_keys = samp_ids + NS;
  int32_t* spl_ids = spl_keys + (long long)L * (P - 1);
  int32_t* counts = spl_ids + (P - 1);
  int32_t* firsts = counts + (long long)P * P;
  int32_t* ties = firsts + P;
  // 1. s samples of the run: positions g - 1, 2g - 1, ...; one past the
  // tile's end is padding, with a virtual index >= M. The run's ties: its
  // endpoints whose primary key is their predecessor's (equal keys, or
  // keys that differ only past the primary key), which the sample ranking
  // and the bucket merge settle from more limbs, class and index
  int f = L;
  if (tiled) {
    f = tile_sort(rb, re, wb, we, L, NR, NW, base, cnt, sk, sp, sid, extra,
                  extra + SORT_TILE, &sh_mask);
    if (threadIdx.x == 0) {
      sh_first = L;
      sh_ties = 0u;
    }
    __syncthreads();
    unsigned int t = 0u;
    for (int x = threadIdx.x + 1; x < cnt; x += blockDim.x)
      t += sp[x] == sp[x - 1];
    t = __reduce_add_sync(0xffffffffu, t);
    if ((threadIdx.x & 31) == 0 && t) atomicAdd(&sh_ties, t);
    for (int i = threadIdx.x; i < (L + 1) * s; i += blockDim.x) {
      const int l = i / s, k = i - l * s;
      const int pos = (k + 1) * g - 1;
      const int q = b * s + k;
      if (l == L) {
        samp_ids[q] = pos < cnt ? base + sid[pos] : M + base + pos;
      } else {
        const int32_t v =
            pos < cnt ? sk[l * SORT_TILE + sid[pos]] : INT_MAX;
        samp_keys[(long long)l * NS + q] = v;
        if (pos < cnt && v != endpoint_limb(rb, re, wb, we, NR, NW, l, 0))
          atomicMin(&sh_first, l);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      firsts[b] = sh_first;
      ties[b] = (int32_t)sh_ties;
    }
  }
  fdb_grid_sync(sync);

  // 2. every sample's 64-bit key (limbs F and F + 1, F the first limb on
  // which the samples vary: the limbs before it equal endpoint 0's in
  // every sample; padding's is ~0) into shared memory, each CTA starting
  // at its own offset; rank this tile's s samples against every other
  // tile's sorted list by bisection, each thread one of ours against a
  // share of the tiles, four bisections in step. A tie of the keys reads
  // the ids and the limbs after them from L2.
  unsigned long long* spk = reinterpret_cast<unsigned long long*>(extra);
  int* srank = reinterpret_cast<int*>(spk + NS);  // s
  if (threadIdx.x == 0) {
    sh_first = L;
    sh_ties = 0u;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    atomicMin(&sh_first, __ldcg(firsts + i));
    atomicAdd(&sh_ties, (unsigned int)__ldcg(ties + i));
  }
  for (int k = threadIdx.x; k < s; k += blockDim.x) srank[k] = 0;
  __syncthreads();
  if ((long long)sh_ties > (long long)tie_limit) {
    // every CTA read the same sum: all take the merge rounds, from the
    // runs, in the buffer that leaves the last round in the output
    // (a launch of 2P CTAs takes tiles of MERGE_TILE, as endpoint_merge)
    const int rounds = 32 - __clz(P - 1);
    const int first = rounds & 1;
    run_out(first ? runs_keys : out_keys, first ? runs_ids : out_ids);
    fdb_grid_sync(sync);
    if ((int)gridDim.x >= 2 * P)
      merge_rounds<MERGE_TILE>(out_keys, out_ids, runs_keys, runs_ids, L, M,
                               NR, rounds, first, sh, sync);
    else
      merge_rounds<SORT_TILE>(out_keys, out_ids, runs_keys, runs_ids, L, M,
                              NR, rounds, first, sh, sync);
    return;
  }
  if (!tiled) {  // the sample sort's two other grid barriers, then done
    fdb_grid_sync(sync);
    fdb_grid_sync(sync);
    return;
  }
  run_out(runs_keys, runs_ids);  // read by the buckets after barrier 3
  const int F = sh_first;
  // each CTA starts at its own offset: all of them read the same lines
  const int rot = (int)(((long long)b * NS / P) & ~31);
  const int32_t* rowF = samp_keys + (long long)F * NS;
  const int32_t* rowG = rowF + NS;
  for (int x0 = threadIdx.x; x0 < NS; x0 += 4 * blockDim.x) {
    int32_t hi[4], lo[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int y = x0 + u * blockDim.x + rot;
      y = y >= NS ? y - NS : y;
      const bool in = x0 + u * blockDim.x < NS;
      hi[u] = in && F < L ? __ldcg(rowF + y) : (int32_t)0x80000000;
      lo[u] = in && F + 1 < L ? __ldcg(rowG + y) : (int32_t)0x80000000;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int y = x0 + u * blockDim.x + rot;
      y = y >= NS ? y - NS : y;
      if (x0 + u * blockDim.x < NS)
        spk[y] = ((unsigned long long)((unsigned int)hi[u] ^ 0x80000000u)
                  << 32) | ((unsigned int)lo[u] ^ 0x80000000u);
    }
  }
  __syncthreads();
  const int srest = max(0, L - F - 2);
  const int32_t* samp_rest = samp_keys + (long long)min(F + 2, L) * NS;
  {
    const int k = threadIdx.x % s;  // our sample k
    const int lanes = blockDim.x / s;  // threads a sample of ours
    const int x = b * s + k;
    const unsigned long long kx = spk[x];
    const int ix = __ldcg(samp_ids + x);
    // sample y (key ky) before ours
    auto below = [=](int y, unsigned long long ky) -> bool {
      if (ky != kx) return ky < kx;
      const int iy = __ldcg(samp_ids + y);
      if (ix >= M || iy >= M) return ix >= M && (iy < M || iy < ix);
      const int c = fdb_key_cmp_wide<4, true>(samp_rest + y, NS,
                                              samp_rest + x, NS, srest);
      return c != 0 ? c < 0 : index_before(iy, ix, NR);
    };
    int count = threadIdx.x < s ? k : 0;  // ours below it
    for (int t0 = threadIdx.x / s; t0 < P; t0 += 4 * lanes) {
      int lo[4];
      bool on[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + u * lanes;
        on[u] = t < P && t != b;
        lo[u] = t * s;
      }
      unsigned long long ky[4];
      for (int h = s; h > 1; h >>= 1) {
        const int half = h >> 1;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          ky[u] = on[u] ? spk[lo[u] + half - 1] : 0ull;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (on[u] && below(lo[u] + half - 1, ky[u])) lo[u] += half;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        ky[u] = on[u] ? spk[lo[u]] : 0ull;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (on[u])
          count += lo[u] + below(lo[u], ky[u]) - (t0 + u * lanes) * s;
    }
    atomicAdd(&srank[k], count);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (L + 1) * s; i += blockDim.x) {
    const int l = i / s, k = i - l * s;
    const int r = srank[k] + 1;
    if (r % s != 0 || r == NS) continue;  // not a splitter
    const int j = r / s - 1;
    const int x = b * s + k;
    if (l == L)
      spl_ids[j] = __ldcg(samp_ids + x);
    else
      spl_keys[(long long)l * (P - 1) + j] =
          __ldcg(samp_keys + (long long)l * NS + x);
  }
  fdb_grid_sync(sync);

  // 3. each splitter in this run, still in shared memory: how many of the
  // run's endpoints are at or below it
  int32_t* splk = extra;              // L x (P - 1)
  int32_t* splid = splk + L * (P - 1);  // P - 1
  batched_load(splk, L * (P - 1), [=](int i) { return __ldcg(spl_keys + i); });
  batched_load(splid, P - 1, [=](int i) { return __ldcg(spl_ids + i); });
  __syncthreads();
  const int rest = max(0, L - f - 2);
  const int32_t* sk_rest = sk + (long long)min(f + 2, L) * SORT_TILE;
  for (int j = threadIdx.x; j < P; j += blockDim.x) {
    int c = cnt;  // the last column: the whole run
    const int id = j < P - 1 ? splid[j] : M;
    if (id < M) {
      // the limbs before f are the run's common prefix
      const int32_t* key = splk + j;
      const int pre = fdb_key_cmp(key, P - 1, sk, SORT_TILE, f);
      if (pre != 0) {
        c = pre < 0 ? 0 : cnt;
      } else {
        const unsigned long long pk = limb_pair(key, P - 1, L, f);
        const int32_t* key_rest = key + (long long)min(f + 2, L) * (P - 1);
        int lo = 0, hi = cnt;  // bisect for the first endpoint above it
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          const unsigned long long pm = sp[mid];
          bool le;
          if (pm != pk) {
            le = pm < pk;
          } else {
            const int e = sid[mid];
            const int cr = fdb_key_cmp_wide<4>(sk_rest + e, SORT_TILE,
                                               key_rest, P - 1, rest);
            le = cr != 0 ? cr < 0 : !index_before(id, base + e, NR);
          }
          if (le) lo = mid + 1; else hi = mid;
        }
        c = lo;
      }
    }
    counts[(long long)b * P + j] = c;
  }
  fdb_grid_sync(sync);

  // 4. bucket b: from each run i its piece [counts[i][b - 1], counts[i][b])
  const int cap = ss_cap(P, s);
  unsigned long long* pk0 = reinterpret_cast<unsigned long long*>(sh);
  unsigned long long* pk1 = pk0 + cap;  // keys by position, two orders
  int32_t* slot0 = reinterpret_cast<int32_t*>(pk1 + cap);
  int32_t* slot1 = slot0 + cap;  // slots by position, two orders
  int32_t* bk = slot1 + cap;               // L x cap limbs, by slot
  int32_t* bid = bk + (long long)L * cap;  // cap: ids, by slot
  int32_t* ppos = bid + cap;  // cap: the piece whose positions hold x
  int32_t* pre = ppos + cap;  // P + 1: the pieces' offsets in the bucket
  int32_t* plo = pre + P + 1;  // P: each piece's start in its run
  if (threadIdx.x == 0) sh_offset = 0;
  __syncthreads();
  int len = 0;
  if ((int)threadIdx.x < P) {
    const int32_t* row = counts + (long long)threadIdx.x * P;
    const int lo_i = b > 0 ? __ldcg(row + b - 1) : 0;
    len = __ldcg(row + b) - lo_i;
    plo[threadIdx.x] = lo_i;
    if (lo_i) atomicAdd(&sh_offset, lo_i);
  }
  __shared__ FdbSum sh_scan[32];
  FdbSum total;
  const FdbSum excl = fdb_block_exclusive_scan(FdbSum{len}, FdbSumOp(),
                                               FdbSum{0}, sh_scan, &total);
  if ((int)threadIdx.x < P) pre[threadIdx.x] = excl.v;
  if (threadIdx.x == 0) {
    pre[P] = total.v;
    sh_total = total.v;
  }
  __syncthreads();
  const int n = sh_total;
  const long long offset = sh_offset;
  if (n == 0) return;
  // each position's piece and source in the runs (in slot1 for now)
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    int lo = 0, hi = P;  // the last piece starting at or before x
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (pre[mid] <= x) lo = mid; else hi = mid;
    }
    ppos[x] = lo;
    slot1[x] = lo * SORT_TILE + plo[lo] + (x - pre[lo]);
  }
  __syncthreads();
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    const int src = slot1[x];
    bid[x] = __ldcg(runs_ids + src);
    for (int l0 = 0; l0 < L; l0 += 8) {  // eight limbs in flight
      int32_t v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = l0 + u < L ? __ldcg(runs_keys + (long long)(l0 + u) * M + src)
                          : 0;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (l0 + u < L) bk[(long long)(l0 + u) * cap + x] = v[u];
    }
  }
  const int fb = fdb_first_varying_limb(bk, cap, n, L, &sh_mask);
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    pk0[x] = limb_pair(bk + x, cap, L, fb);
    slot0[x] = x;
  }
  __syncthreads();
  const int brest = max(0, L - fb - 2);
  const int32_t* bk_rest = bk + (long long)min(fb + 2, L) * cap;
  // slot a (key ka) before slot c (key kc): the keys, then the limbs past
  // them, class and index
  auto before = [=](unsigned long long ka, int a, unsigned long long kc,
                    int c) -> bool {
    if (ka != kc) return ka < kc;
    const int r = fdb_key_cmp_wide<4>(bk_rest + a, cap, bk_rest + c, cap,
                                      brest);
    return r != 0 ? r < 0 : index_before(bid[a], bid[c], NR);
  };
  // merge rounds: in round r the runs are 2^r pieces wide; each element
  // bisects its partner run for the elements before it
  unsigned long long* kcur = pk0;
  unsigned long long* knxt = pk1;
  int32_t* cur = slot0;
  int32_t* nxt = slot1;
  for (int r = 0; (1 << r) < P; ++r) {
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
      const int m = ppos[x] >> r;
      const unsigned long long ke = kcur[x];
      const int e = cur[x];
      int out = x;
      if (((m ^ 1) << r) < P) {
        const int os = pre[m << r];
        const int pa = pre[(m ^ 1) << r];
        const int pb = pre[min(((m ^ 1) + 1) << r, P)];
        int lo = pa, hi = pb;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (before(kcur[mid], cur[mid], ke, e)) lo = mid + 1; else hi = mid;
        }
        out = min(os, pa) + (x - os) + (lo - pa);
      }
      knxt[out] = ke;
      nxt[out] = e;
    }
    __syncthreads();
    unsigned long long* kt = kcur;
    kcur = knxt;
    knxt = kt;
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int x = threadIdx.x; x < n; x += blockDim.x)
    out_ids[offset + x] = bid[cur[x]];
  for (int l = 0; l < L; ++l)
    for (int x = threadIdx.x; x < n; x += blockDim.x)
      out_keys[(long long)l * M + offset + x] = bk[(long long)l * cap + cur[x]];
}

// The tile and rounds paths in one cooperative launch: the tile sort of
// every tile (CTAs take tiles by a stride) into buffer `first`, a grid
// barrier, then
// every merge round: round r reads buffer (first + r) % 2 and writes the
// other one; a grid barrier separates the rounds.
__global__ void __launch_bounds__(SORT_THREADS)
endpoint_merge_kernel(const int32_t* __restrict__ rb,
                      const int32_t* __restrict__ re,
                      const int32_t* __restrict__ wb,
                      const int32_t* __restrict__ we, int NR, int NW,
                      int32_t* keys0, int32_t* ids0, int32_t* keys1,
                      int32_t* ids1, int L, int M, int rounds, int first,
                      unsigned int* sync) {
  extern __shared__ int32_t sh[];
  __shared__ unsigned int sh_mask;
  {  // the tile sort, as endpoint_sample_kernel's
    int32_t* sk = sh;
    unsigned long long* sp =
        reinterpret_cast<unsigned long long*>(sh + L * SORT_TILE);
    int32_t* sid = reinterpret_cast<int32_t*>(sp + SORT_TILE);
    int32_t* keys = first ? keys1 : keys0;
    int32_t* ids = first ? ids1 : ids0;
    const int n_tiles = (M + SORT_TILE - 1) / SORT_TILE;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int base = tile * SORT_TILE;
      const int cnt = min(SORT_TILE, M - base);
      tile_sort(rb, re, wb, we, L, NR, NW, base, cnt, sk, sp, sid,
                sid + SORT_TILE, sid + 2 * SORT_TILE, &sh_mask);
      for (int x = threadIdx.x; x < cnt; x += blockDim.x) {
        const int p = sid[x];
        ids[base + x] = base + p;
        for (int l = 0; l < L; ++l)
          keys[(long long)l * M + base + x] = sk[l * SORT_TILE + p];
      }
      __syncthreads();  // the shared tile is free for the next one
    }
  }
  if (rounds == 0) return;  // one tile: it is the output
  fdb_grid_sync(sync);
  merge_rounds<MERGE_TILE>(keys0, ids0, keys1, ids1, L, M, NR, rounds, first,
                           sh, sync);
}

// Dynamic shared memory granted to each kernel, per device.
static int g_sample_smem[64], g_merge_smem[64];

// The sample path: one cooperative launch of up to 2P CTAs, P tiles of s
// samples.
static cudaError_t launch_sample_sort(const int32_t* rb, const int32_t* re,
                                      const int32_t* wb, const int32_t* we,
                                      int L, int NR, int NW, int M, int s,
                                      int tie_limit, int32_t* out_keys,
                                      int32_t* out_ids,
                                      int32_t* tmp_keys, int32_t* tmp_ids,
                                      int32_t* scratch, unsigned int* sync,
                                      int dev, const FdbDeviceLimits& lim,
                                      cudaStream_t st) {
  const int P = (M + SORT_TILE - 1) / SORT_TILE;
  if (P < 2 || s < SS_MIN_SAMPLES || s > SS_MAX_SAMPLES || (s & (s - 1)) ||
      (long long)P * s > SS_SAMPLE_BUDGET || P > lim.sms)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)ss_smem_words(L, P, s) * sizeof(int32_t);
  if (smem > SS_SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e =
      fdb_allow_smem(endpoint_sample_kernel, dev, smem, g_sample_smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, endpoint_sample_kernel, SORT_THREADS, smem);
  if (e != cudaSuccess) return e;
  if ((long long)per_sm * lim.sms < P)
    return cudaErrorCooperativeLaunchTooLarge;
  // 2P CTAs where they fit: the merge rounds, where the kernel turns to
  // them, then take tiles of MERGE_TILE on as many SMs as endpoint_merge
  const int G = 2 * P < per_sm * lim.sms ? 2 * P : per_sm * lim.sms;
  void* params[] = {(void*)&rb, (void*)&re, (void*)&wb, (void*)&we,
                    (void*)&L, (void*)&NR, (void*)&NW, (void*)&M, (void*)&s,
                    (void*)&tie_limit, &tmp_keys, &tmp_ids, &scratch,
                    &out_keys, &out_ids, &sync};
  return cudaLaunchCooperativeKernel((const void*)endpoint_sample_kernel,
                                     dim3(G), dim3(SORT_THREADS), params,
                                     smem, st);
}

// rb, re: (L, NR); wb, we: (L, NW). The sorted endpoints land in out_keys
// (L, M) and out_ids (M); tmp_keys/tmp_ids are scratch of the same sizes;
// sync is one zeroed word (the grid barriers leave its low bits zero).
// M = 2NR + 2NW >= 1. `samples` > 0 takes the sample path with that many
// samples a tile (scratch: (L + 1)(P s + P - 1) + P^2 + 2P int32, P
// the tiles), which turns to the merge rounds where more than `tie_limit`
// endpoints tie (-1: always; INT_MAX: never). 0: the tile sort alone when
// M <= 1,024, else the tile sort and the merge rounds. One launch on
// every path.
extern "C" int fdb_endpoint_sort(const int32_t* rb, const int32_t* re,
                                 const int32_t* wb, const int32_t* we, int L,
                                 int NR, int NW, int samples, int tie_limit,
                                 int32_t* out_keys, int32_t* out_ids,
                                 int32_t* tmp_keys, int32_t* tmp_ids,
                                 int32_t* scratch, unsigned int* sync,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M = 2 * NR + 2 * NW;
  if (L < 1 || L > 32 || M < 1) return (int)cudaErrorInvalidValue;
  int dev = 0;
  FdbDeviceLimits lim;
  cudaError_t e = fdb_device_limits(&dev, &lim);
  if (e != cudaSuccess) return (int)e;
  if (samples > 0) {
    e = launch_sample_sort(rb, re, wb, we, L, NR, NW, M, samples, tie_limit,
                           out_keys, out_ids, tmp_keys, tmp_ids, scratch,
                           sync, dev, lim, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  const int n_tiles = (M + SORT_TILE - 1) / SORT_TILE;
  const size_t sort_smem =
      ((size_t)(L + 4) * SORT_TILE + HASH_SLOTS) * sizeof(int32_t);
  int rounds = 0;
  while ((1 << rounds) < n_tiles) ++rounds;
  int first = rounds % 2;  // so that the last round writes the output
  int32_t* keys[2] = {out_keys, tmp_keys};
  int32_t* ids[2] = {out_ids, tmp_ids};
  // the tile sort's shared memory holds a merge tile's too
  e = fdb_allow_smem(endpoint_merge_kernel, dev, sort_smem, g_merge_smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, endpoint_merge_kernel, SORT_THREADS, sort_smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int want = (M + MERGE_TILE - 1) / MERGE_TILE;
  const int cap = lim.sms * per_sm;
  const int G = want < cap ? want : cap;
  void* params[] = {(void*)&rb, (void*)&re, (void*)&wb, (void*)&we,
                    (void*)&NR, (void*)&NW, &keys[0], &ids[0], &keys[1],
                    &ids[1], (void*)&L, (void*)&M, &rounds, &first, &sync};
  e = cudaLaunchCooperativeKernel((const void*)endpoint_merge_kernel,
                                  dim3(G), dim3(SORT_THREADS), params,
                                  sort_smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
