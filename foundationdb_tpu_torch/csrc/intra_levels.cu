// K9 intra_levels: the sweep-invariant level geometry of the scan
// evaluator, every level of a step in one persistent, cooperative launch.
//
// Replaces: foundationdb_tpu/ops/conflict.py `_intra_scan_levels`
// (:243-292), one `lax.sort` of M = NW + 2 NR elements a level, an
// inverse-permutation scatter and gathers. Level l (l < max(1,
// bit_length(T - 1))) orders the elements by (block, rank, class, index):
//   write i (index i < NW):      block wtxn_c[i] >> l, rank wbr[i], class 0;
//   lo query of read j (NW + j): block (rtxn[j] >> l) - 1, rbr[j], class 1;
//   hi query of read j (NW+NR+j): block (rtxn[j] >> l) - 1, rer[j], class -1;
// and writes, at each output position p of level l, src (the write, else
// NW - 1), is_w, werl (wer of the write, else -1) and bnd (p starts a
// block), and qlo[l][j] / qhi[l][j], the positions of read j's queries. The
// order is total, so the arrays equal conflict_ref.intra_levels (a stable
// sort) exactly. Owners may come in any order; they must lie in [0, T - 1]
// (writes) and [0, T] (reads, T = padding): values outside are clamped to
// [0, T] so that no access leaves the arrays.
//
// Bound on H100: bytes. It writes 10 B per level element and 8 B per read
// and level, and reads 4 (NW + NR) int32: 1.56 MB at the resolver's
// M = 12,288 (10 levels, ~0.47 us of HBM time), 8.7 MB at the kernel
// bench's T = 16,384 (14 levels, ~2.6 us), 18.7 MB at T = 32,768 (~5.6 us).
//
// Design: a bottom-up merge sort over the txn index, with no radix sort.
// Writes and queries are two run sets. W_l holds the writes sorted by
// (wtxn_c >> l, wbr, i), Q_l the queries by (rtxn >> l, rank, is_lo, j);
// both carry (owner, 64-bit key) pairs, key = rank << 32 | (i, or is_lo <<
// 31 | j), unique, so no tie needs a rule. Writes of txn block b at level l
// sit in W_l[WC[b << l], WC[(b + 1) << l]), WC[x] = writes with owner < x;
// queries of txn block c in Q_l[QC[c << l], QC[(c + 1) << l]).
//   1. tile sort: each CTA sorts 1,024-element tiles of W_0 and Q_0 by
//      (owner, key) in shared memory, ranking merges (every element finds
//      its place in the sibling run by bisection) from runs of 1 to 1,024;
//   2. merge rounds over global memory, runs of 1,024 doubling, the same
//      ranking, both sets in one pass; a grid barrier after each;
//   3. WC and QC, each entry x by bisection of the sorted owners;
//   4. a pass a level, a thread an element of W_l or Q_l:
//      - a write of block b: its output position is its place in W_l plus
//        the queries of blocks before b (QC[(b + 1) << l]) plus those of
//        block b that it follows (rank < its rank, or equal and hi), by
//        bisection of Q_l's txn block b + 1; a query of block b = (rtxn >>
//        l) - 1 alike against W_l's block b (wbr < rank for hi, <= for lo);
//        bnd is "position == WC[b << l] + QC[(b + 1) << l]";
//      - for the next level, blocks 2k and 2k + 1 of W_l merge into block
//        k of W_{l+1}: each element's new place is its place in its block
//        plus the sibling block's elements below its key (bisection);
//        likewise for Q. The two bisections run interleaved.
//      A grid barrier between levels.
// Work is O(M log M) in step 2 and O(M log(block)) a level, in
// log2(M / 1,024) + n_levels + 1 barriers. It is bound by the bisections'
// scattered L2 loads, not by the barriers: a version that ran two levels
// a pass and merged four runs a round (half the barriers, 1.5x the
// bisections) took the same time on the H100. None of it is a radix pass.
// Scratch (global): two buffers of (owner, key) for each set, WC and QC
// (T + 2 int32 each), and a zeroed barrier word.
#include "common.cuh"

#define LV_THREADS 512
#define LV_TILE 1024  // elements a CTA sorts in shared memory (2 a thread)

typedef unsigned long long u64;

struct LvArgs {
  const int32_t* wtxn_c;
  const int32_t* rtxn;
  const int32_t* rbr;
  const int32_t* rer;
  const int32_t* wbr;
  const int32_t* wer;
  int T, NW, NR, n_levels;
  int n[2];             // elements of each set: NW writes, 2 NR queries
  int32_t* own[2][2];   // [set][buffer] owners
  u64* key[2][2];       // [set][buffer] keys
  int32_t* cnt[2];      // WC, QC: T + 2 each
  unsigned int* sync;   // grid barrier word (low 31 bits zero)
  int32_t* src;
  uint8_t* is_w;
  int32_t* werl;
  uint8_t* bnd;
  int32_t* qlo;
  int32_t* qhi;
};

__device__ __forceinline__ int lv_clamp_owner(int o, int T) {
  return o < 0 ? 0 : (o > T ? T : o);
}

// Element e of set s (0 writes, 1 queries) as (owner, key), from the
// inputs. Query e < NR is the lo query of read e, else the hi query of
// read e - NR.
__device__ __forceinline__ void lv_element(const LvArgs& a, int s, int e,
                                           int* own, u64* key) {
  if (s == 0) {
    *own = lv_clamp_owner(__ldg(&a.wtxn_c[e]), a.T);
    *key = ((u64)(unsigned)__ldg(&a.wbr[e]) << 32) | (unsigned)e;
  } else {
    const bool lo = e < a.NR;
    const int j = lo ? e : e - a.NR;
    *own = lv_clamp_owner(__ldg(&a.rtxn[j]), a.T);
    const unsigned rank = (unsigned)__ldg(lo ? &a.rbr[j] : &a.rer[j]);
    *key = ((u64)rank << 32) | (lo ? 0x80000000u : 0u) | (unsigned)j;
  }
}

__device__ __forceinline__ bool lv_less(int oa, u64 ka, int ob, u64 kb) {
  return oa != ob ? oa < ob : ka < kb;
}

// Elements of [lo, hi) of a run sorted by (owner, key) below (o, k).
template <bool CG>
__device__ __forceinline__ int lv_rank_in(const int32_t* own, const u64* key,
                                          int lo, int hi, int o, u64 k) {
  const int base = lo;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int om = CG ? __ldcg(&own[mid]) : own[mid];
    const u64 km = CG ? __ldcg(&key[mid]) : key[mid];
    if (lv_less(om, km, o, k)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - base;
}

// One ranking-merge round: runs of width w (by position, the last may be
// short) of `n` elements merge pairwise into runs of 2w. Element x's new
// place is its place in its run plus the sibling run's elements below it.
template <bool CG>
__device__ __forceinline__ void lv_merge_one(const int32_t* own,
                                             const u64* key, int32_t* own2,
                                             u64* key2, int n, int w, int x) {
  const int r = x / w;
  const int sib = r ^ 1;
  const int o = CG ? __ldcg(&own[x]) : own[x];
  const u64 k = CG ? __ldcg(&key[x]) : key[x];
  int below = 0;
  if ((long long)sib * w < n) {
    const int a = sib * w;
    const int b = (int)min((long long)a + w, (long long)n);
    below = lv_rank_in<CG>(own, key, a, b, o, k);
  }
  const int p = (r & ~1) * w + (x - r * w) + below;
  own2[p] = o;
  key2[p] = k;
}

// cnt at the first txn of block b of level l (b may be -1; the txn index
// is clamped to [0, T + 1]).
__device__ __forceinline__ int lv_count(const int32_t* cnt, int b, int l,
                                        int T) {
  long long x = (long long)b * (1LL << l);
  x = x < 0 ? 0 : (x > T + 1 ? T + 1 : x);
  return __ldcg(&cnt[x]);
}

// Two bisections at once, so that their loads overlap: the elements of
// A[a0, a1) below t0 and of B[b0, b1) below t1 (both sorted by key).
__device__ __forceinline__ void lv_two_ranks(const u64* A, int a0, int a1,
                                             u64 t0, const u64* B, int b0,
                                             int b1, u64 t1, int* r0,
                                             int* r1) {
  int lo0 = a0, hi0 = a1, lo1 = b0, hi1 = b1;
  while (lo0 < hi0 || lo1 < hi1) {
    const int m0 = (lo0 + hi0) >> 1, m1 = (lo1 + hi1) >> 1;
    const u64 k0 = lo0 < hi0 ? __ldcg(&A[m0]) : 0ull;
    const u64 k1 = lo1 < hi1 ? __ldcg(&B[m1]) : 0ull;
    if (lo0 < hi0) {
      if (k0 < t0) lo0 = m0 + 1; else hi0 = m0;
    }
    if (lo1 < hi1) {
      if (k1 < t1) lo1 = m1 + 1; else hi1 = m1;
    }
  }
  *r0 = lo0 - a0;
  *r1 = lo1 - b0;
}

__global__ void __launch_bounds__(LV_THREADS, 2)
intra_levels_kernel(LvArgs a) {
  __shared__ int32_t s_own[2][LV_TILE];
  __shared__ u64 s_key[2][LV_TILE];
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gstride = gridDim.x * blockDim.x;
  const int T = a.T;

  // 1. tile sort of W_0 and Q_0 into buffer 0
  const int tiles0 = (a.n[0] + LV_TILE - 1) / LV_TILE;
  const int tiles = tiles0 + (a.n[1] + LV_TILE - 1) / LV_TILE;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int s = tile < tiles0 ? 0 : 1;
    const int base = (s == 0 ? tile : tile - tiles0) * LV_TILE;
    const int n = min(LV_TILE, a.n[s] - base);
    for (int x = threadIdx.x; x < n; x += blockDim.x)
      lv_element(a, s, base + x, &s_own[0][x], &s_key[0][x]);
    __syncthreads();
    int from = 0;
    for (int w = 1; w < n; w *= 2) {
      for (int x = threadIdx.x; x < n; x += blockDim.x)
        lv_merge_one<false>(s_own[from], s_key[from], s_own[from ^ 1],
                            s_key[from ^ 1], n, w, x);
      from ^= 1;
      __syncthreads();
    }
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
      a.own[s][0][base + x] = s_own[from][x];
      a.key[s][0][base + x] = s_key[from][x];
    }
    __syncthreads();
  }
  fdb_grid_sync(a.sync);

  // 2. merge rounds over global memory, both sets in each pass
  int cur[2] = {0, 0};
  for (int w = LV_TILE; w < max(a.n[0], a.n[1]); w *= 2) {
    for (int s = 0; s < 2; ++s) {
      if (w >= a.n[s]) continue;
      const int c = cur[s];
      for (int x = gtid; x < a.n[s]; x += gstride)
        lv_merge_one<true>(a.own[s][c], a.key[s][c], a.own[s][c ^ 1],
                           a.key[s][c ^ 1], a.n[s], w, x);
      cur[s] ^= 1;
    }
    fdb_grid_sync(a.sync);
  }

  // 3. WC[x], QC[x] = elements with owner < x, x in [0, T + 1]
  for (int s = 0; s < 2; ++s) {
    const int32_t* own = a.own[s][cur[s]];
    for (int x = gtid; x < T + 2; x += gstride) {
      int lo = 0, hi = a.n[s];
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldcg(&own[mid]) < x) lo = mid + 1; else hi = mid;
      }
      a.cnt[s][x] = lo;
    }
  }
  fdb_grid_sync(a.sync);

  // 4. a pass a level
  const int32_t* WC = a.cnt[0];
  const int32_t* QC = a.cnt[1];
  const long long M = (long long)a.NW + 2LL * a.NR;
  for (int l = 0; l < a.n_levels; ++l) {
    const bool next = l + 1 < a.n_levels;
    const int32_t* wown = a.own[0][cur[0]];
    const u64* wkey = a.key[0][cur[0]];
    const int32_t* qown = a.own[1][cur[1]];
    const u64* qkey = a.key[1][cur[1]];
    int32_t* src = a.src + l * M;
    uint8_t* is_w = a.is_w + l * M;
    int32_t* werl = a.werl + l * M;
    uint8_t* bnd = a.bnd + l * M;
    for (int e = gtid; e < a.n[0] + a.n[1]; e += gstride) {
      const bool wr = e < a.n[0];
      const int p = wr ? e : e - a.n[0];
      const int o = __ldcg(&(wr ? wown : qown)[p]);
      const u64 k = __ldcg(&(wr ? wkey : qkey)[p]);
      const unsigned rank = (unsigned)(k >> 32);
      // c: this element's txn block at level l; b: its level block
      const int c = o >> l;
      const int b = wr ? c : c - 1;
      const int w_lo = lv_count(WC, b, l, T);
      const int q_lo = lv_count(QC, b + 1, l, T);
      const int start = w_lo + q_lo;
      // the other set's block b: for a write Q_l's txn block b + 1, for a
      // query W_l's txn block b (empty for b = -1)
      int o0, o1;
      u64 target;
      const u64* other;
      if (wr) {
        o0 = q_lo;
        o1 = lv_count(QC, b + 2, l, T);
        target = ((u64)rank << 32) | 0x80000000u;  // ranks below, and hi
        other = qkey;
      } else {
        const bool lo = (k >> 31) & 1u;
        o0 = b < 0 ? 0 : w_lo;
        o1 = b < 0 ? 0 : lv_count(WC, b + 1, l, T);
        target = (u64)(rank + (lo ? 1u : 0u)) << 32;  // wbr <= / < rank
        other = wkey;
      }
      // the sibling txn block of this level in the same set
      const int32_t* C = wr ? WC : QC;
      const u64* mine = wr ? wkey : qkey;
      const int own_lo = lv_count(C, c, l, T);
      const int s0 = next ? lv_count(C, c ^ 1, l, T) : 0;
      const int s1 = next ? lv_count(C, (c ^ 1) + 1, l, T) : 0;
      int before, below;
      lv_two_ranks(other, o0, o1, target, mine, s0, s1, k, &before, &below);
      const int pos = p + (wr ? q_lo : w_lo) + before;
      if (wr) {
        const int i = (int)(k & 0xffffffffu);
        src[pos] = i;
        is_w[pos] = 1;
        werl[pos] = __ldg(&a.wer[i]);
      } else {
        const int j = (int)(k & 0x7fffffffu);
        src[pos] = a.NW - 1;
        is_w[pos] = 0;
        werl[pos] = -1;
        ((k >> 31) & 1u ? a.qlo : a.qhi)[(long long)l * a.NR + j] = pos;
      }
      bnd[pos] = pos == start ? 1 : 0;
      if (next) {
        const int s = wr ? 0 : 1;
        const int np = lv_count(C, c & ~1, l, T) + (p - own_lo) + below;
        a.own[s][cur[s] ^ 1][np] = o;
        a.key[s][cur[s] ^ 1][np] = k;
      }
    }
    if (next) {
      cur[0] ^= 1;
      cur[1] ^= 1;
      fdb_grid_sync(a.sync);
    }
  }
}

static int g_lv_per_sm[64];

// wtxn_c, wbr, wer: NW int32; rtxn, rbr, rer: NR int32. Outputs: src, werl
// (n_levels, M) int32, is_w, bnd (n_levels, M) uint8, qlo, qhi (n_levels,
// NR) int32, M = NW + 2 NR >= 1. Scratch: keys, 2 * (NW + 2 NR) u64
// (8-byte aligned); owners, 2 * (NW + 2 NR) int32; counts, 2 * (T + 2)
// int32, all overwritten; sync, one word whose low 31 bits are zero on
// entry and are left so. One cooperative launch on `stream`.
extern "C" int fdb_intra_levels(
    const int32_t* wtxn_c, const int32_t* rtxn, const int32_t* rbr,
    const int32_t* rer, const int32_t* wbr, const int32_t* wer, int T,
    int NW, int NR, int n_levels, unsigned long long* keys, int32_t* owners,
    int32_t* counts, unsigned int* sync, int32_t* src, uint8_t* is_w,
    int32_t* werl, uint8_t* bnd, int32_t* qlo, int32_t* qhi, void* stream) {
  const long long M = (long long)NW + 2LL * NR;
  if (T < 1 || NW < 0 || NR < 0 || M < 1 || M >= (1LL << 30) ||
      n_levels < 1 || n_levels > 31 || (long long)n_levels * M >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  FdbDeviceLimits lim;
  cudaError_t e = fdb_device_limits(&dev, &lim);
  if (e != cudaSuccess) return (int)e;
  if (g_lv_per_sm[dev] == 0) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, intra_levels_kernel, LV_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    g_lv_per_sm[dev] = per_sm;
  }
  LvArgs a;
  a.wtxn_c = wtxn_c; a.rtxn = rtxn; a.rbr = rbr; a.rer = rer;
  a.wbr = wbr; a.wer = wer;
  a.T = T; a.NW = NW; a.NR = NR; a.n_levels = n_levels;
  a.n[0] = NW;
  a.n[1] = 2 * NR;
  a.key[0][0] = keys;
  a.key[0][1] = keys + NW;
  a.key[1][0] = keys + 2LL * NW;
  a.key[1][1] = keys + 2LL * NW + 2LL * NR;
  a.own[0][0] = owners;
  a.own[0][1] = owners + NW;
  a.own[1][0] = owners + 2LL * NW;
  a.own[1][1] = owners + 2LL * NW + 2LL * NR;
  a.cnt[0] = counts;
  a.cnt[1] = counts + T + 2;
  a.sync = sync;
  a.src = src; a.is_w = is_w; a.werl = werl; a.bnd = bnd;
  a.qlo = qlo; a.qhi = qhi;
  // enough CTAs for the tiles or the elements, at most what is co-resident
  const long long tiles = (NW + LV_TILE - 1) / LV_TILE +
                          (2LL * NR + LV_TILE - 1) / LV_TILE;
  const long long want_e = (M + LV_THREADS - 1) / LV_THREADS;
  const long long want = tiles > want_e ? tiles : want_e;
  const long long cap = (long long)lim.sms * g_lv_per_sm[dev];
  const int G = (int)(want < cap ? want : cap);
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)intra_levels_kernel, dim3(G),
                                  dim3(LV_THREADS), params, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
