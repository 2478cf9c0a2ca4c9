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
// Design. Writes and queries are two run sets. W_l holds the writes sorted
// by (wtxn_c >> l, wbr, i), Q_l the queries by (rtxn >> l, rank, is_lo, j);
// both carry (owner, 64-bit key) pairs, key = rank << 32 | (i, or is_lo <<
// 31 | j), unique, so no tie needs a rule. Writes of txn block b at level l
// sit in W_l[WC[b << l], WC[(b + 1) << l]), WC[x] = writes with owner < x;
// queries of txn block c in Q_l[QC[c << l], QC[(c + 1) << l]). At level l
// an element's output position is its place in its own run plus the other
// set's elements of its level block below it:
//   - a write of block b: its place in W_l plus the queries of blocks
//     before b (QC[(b + 1) << l]) plus those of block b that it follows
//     (rank < its rank, or equal and hi), in Q_l's txn block b + 1; a query
//     of block b = (rtxn >> l) - 1 alike against W_l's block b (wbr < rank
//     for hi, <= for lo); bnd is "position == WC[b << l] + QC[(b + 1) << l]";
//   - for the next level, blocks 2k and 2k + 1 of W_l merge into block k of
//     W_{l+1}: each element's new place is its place in its block plus the
//     sibling block's elements below its key; likewise for Q.
// Every place is found by bisection. The earlier design (the general path
// below) did every level as one grid pass of bisections over L2-resident
// runs, after a merge sort over global memory: ~20 grid barriers at the
// kernel bench's T = 16,384, each pass ~6 us of dependent L2 loads on the
// H100 (NVIDIA H100 80GB HBM3, 700 W).
//
// Pass 0 checks the owners on the device and picks one of two paths for
// the whole launch (a flag word, set by any CTA that finds a reason):
//
// Span path (owners in range and nondecreasing in both sets, as the
// pooled and the strided layouts give them, and no span overfull). Then
// WC[x] and QC[x] are lower bounds in the input owners, written in pass 0
// at every multiple of half a span (a warp runs four searches at once,
// eight probes each a round), and a span of 2^s txns owns every level
// block l < s whose writes lie in it. One CTA a span loads, into shared
// memory, the span's writes and the queries of the span and of the half
// span above it (level block b holds the queries of txn block b + 1),
// with its own counts of them below each txn; sorts each txn's elements
// by key (counting within the txn, or ranking merges where a txn holds
// more than 32); and does every level l < s there: the bisections run over
// shared memory and the CTA's barriers are block barriers. Its last merge
// writes the span's W_s and Q_s blocks out. Levels l >= s then run as grid
// passes over global memory. s comes from the host (kernels.level_plan:
// the largest span whose average load fills a quarter of LV_SPAN_CAP
// elements, at most 2^10 txns; a sweep of s on the H100 put the least time
// there); a span past LV_SPAN_CAP (a pooled txn owning thousands of
// ranges, a padding tail) sends the launch down the general path. At
// T = 16,384 (1 read, 1 write a txn) s = 8: 6 grid levels and 7 grid
// barriers in all, in place of ~20.
//
// General path (any other input: shuffled owners, the sharded engine's
// clipped calls, overfull spans), the earlier design:
//   1. tile sort: each CTA sorts 1,024-element tiles of W_0 and Q_0 by
//      (owner, key) in shared memory, ranking merges from runs of 1 to
//      1,024;
//   2. merge rounds over global memory, runs of 1,024 doubling; a grid
//      barrier after each;
//   3. WC and QC, each entry x by bisection of the sorted owners;
//   4. a grid pass a level (the same passes as the span path's levels >= s).
// A grid level first copies every ss-th key of both runs into each CTA's
// shared memory (at most 2,048 samples a run); an element's bisections
// then run over the samples there and over fewer than ss keys in L2.
// None of it is a radix pass. Scratch (global): two buffers of (owner,
// key) for each set, WC and QC (T + 2 int32 each), a zeroed barrier word
// and two zeroed flag words (the path flag and a count of the CTAs that
// read it; the last to read it zeroes both).
#include "common.cuh"

#define LV_THREADS 1024
#define LV_TILE 1024       // elements a CTA sorts in shared memory (general)
#define LV_SPAN_CAP 4096   // elements of a span in shared memory (span path)
#define LV_SPAN_LOG2_MAX 10  // txns of a span: at most 2^10
#define LV_SPAN_MAX (1 << LV_SPAN_LOG2_MAX)
#define LV_SAMPLES 2048    // samples of a set's runs a grid level holds
// dynamic shared memory: two buffers of (key, owner) for a span (which
// also hold the general path's tile and a grid level's samples) and the
// span's local counts of writes (span + 1) and of queries (1.5 span + 1)
// below each txn
#define LV_SMEM                                                        \
  (2 * LV_SPAN_CAP * (sizeof(unsigned long long) + sizeof(int)) +      \
   (LV_SPAN_MAX + 1 + LV_SPAN_MAX * 3 / 2 + 1) * sizeof(int))

typedef unsigned long long u64;

struct LvArgs {
  const int32_t* wtxn_c;
  const int32_t* rtxn;
  const int32_t* rbr;
  const int32_t* rer;
  const int32_t* wbr;
  const int32_t* wer;
  int T, NW, NR, n_levels;
  int span_log2;        // s: levels below it run in a span's CTA (0: none)
  int32_t* owners;      // [writes 0 | writes 1 | queries 0 | queries 1]
  u64* keys;            // the same layout
  int32_t* counts;      // WC, QC: T + 2 each
  unsigned int* sync;   // grid barrier word (low 31 bits zero)
  // [path flag, CTAs that read it] (zero on entry, left so), then the
  // launches that took the span path and the general path (counters
  // the host reads and resets) and the grid barriers of the last launch
  unsigned int* flag;
  int32_t* src;
  uint8_t* is_w;
  int32_t* werl;
  uint8_t* bnd;
  int32_t* qlo;
  int32_t* qhi;
};

// Elements of set s (0 writes, 1 queries), its buffer c (0, 1) of owners
// and of keys, and its counts (WC, QC).
__device__ __forceinline__ int lv_n(const LvArgs& a, int s) {
  return s ? 2 * a.NR : a.NW;
}
__device__ __forceinline__ long long lv_at(const LvArgs& a, int s, int c) {
  return s ? 2LL * a.NW + 2LL * c * a.NR : (long long)c * a.NW;
}
__device__ __forceinline__ int32_t* lv_own(const LvArgs& a, int s, int c) {
  return a.owners + lv_at(a, s, c);
}
__device__ __forceinline__ u64* lv_key(const LvArgs& a, int s, int c) {
  return a.keys + lv_at(a, s, c);
}
__device__ __forceinline__ int32_t* lv_cnt(const LvArgs& a, int s) {
  return a.counts + (long long)s * (a.T + 2);
}

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

// Elements of [lo, hi) of a run sorted by (owner, key) below (o, k). An
// element below the first or above the last costs two loads.
template <bool CG>
__device__ __forceinline__ int lv_rank_in(const int32_t* own, const u64* key,
                                          int lo, int hi, int o, u64 k) {
  if (lo >= hi) return 0;
  const int base = lo;
  {
    const int of = CG ? __ldcg(&own[lo]) : own[lo];
    const u64 kf = CG ? __ldcg(&key[lo]) : key[lo];
    if (!lv_less(of, kf, o, k)) return 0;
    const int ol = CG ? __ldcg(&own[hi - 1]) : own[hi - 1];
    const u64 kl = CG ? __ldcg(&key[hi - 1]) : key[hi - 1];
    if (lv_less(ol, kl, o, k)) return hi - lo;
  }
  ++lo;
  --hi;
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

// Two bisections at once, so that their loads overlap: the elements of
// A[a0, a1) below t0 and of B[b0, b1) below t1 (both sorted by key).
template <bool CG>
__device__ __forceinline__ void lv_two_ranks(const u64* A, int a0, int a1,
                                             u64 t0, const u64* B, int b0,
                                             int b1, u64 t1, int* r0,
                                             int* r1) {
  int lo0 = a0, hi0 = a1, lo1 = b0, hi1 = b1;
  while (lo0 < hi0 || lo1 < hi1) {
    const int m0 = (lo0 + hi0) >> 1, m1 = (lo1 + hi1) >> 1;
    const u64 k0 = lo0 < hi0 ? (CG ? __ldcg(&A[m0]) : A[m0]) : 0ull;
    const u64 k1 = lo1 < hi1 ? (CG ? __ldcg(&B[m1]) : B[m1]) : 0ull;
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

// The window of [lo, hi) of a run (sorted by key) that holds the place of
// target t, from the run's samples (samp[i] = key at position i * ss, in
// shared memory): [*w0, *w1) has fewer than ss positions.
__device__ __forceinline__ void lv_window(const u64* samp, int ss, int lo,
                                          int hi, u64 t, int* w0, int* w1) {
  int i0 = (lo + ss - 1) / ss, i1 = (hi + ss - 1) / ss;
  const int first = i0;
  while (i0 < i1) {
    const int mid = (i0 + i1) >> 1;
    if (samp[mid] < t) i0 = mid + 1; else i1 = mid;
  }
  // samples first .. i0 - 1 lie below t, sample i0 (if in range) does not
  *w0 = i0 > first ? (i0 - 1) * ss + 1 : lo;
  *w1 = min(hi, i0 * ss);
  if (*w1 < *w0) *w1 = *w0;
}

// The outputs of one element at level l and output position pos; werl is
// the write's end rank (loaded by the caller, early, so that the load
// overlaps its searches).
__device__ __forceinline__ void lv_write(const LvArgs& a, int l, bool wr,
                                         u64 k, int pos, int start,
                                         int werl) {
  const long long M = (long long)a.NW + 2LL * a.NR;
  const long long at = (long long)l * M + pos;
  if (wr) {
    const int i = (int)(k & 0xffffffffu);
    a.src[at] = i;
    a.is_w[at] = 1;
    a.werl[at] = werl;
  } else {
    const int j = (int)(k & 0x7fffffffu);
    a.src[at] = a.NW - 1;
    a.is_w[at] = 0;
    a.werl[at] = -1;
    ((k >> 31) & 1u ? a.qlo : a.qhi)[(long long)l * a.NR + j] = pos;
  }
  a.bnd[at] = pos == start ? 1 : 0;
}

// The target an element is ranked by in the other set's block: a write
// follows the queries of lower rank and the hi queries of its rank; a
// query follows the writes of lower rank, and a lo query those of its
// rank too.
__device__ __forceinline__ u64 lv_cross_target(bool wr, u64 k) {
  const unsigned rank = (unsigned)(k >> 32);
  if (wr) return ((u64)rank << 32) | 0x80000000u;
  return (u64)(rank + (((k >> 31) & 1u) ? 1u : 0u)) << 32;
}

// A grid barrier. CTA 0 counts them into flag[4] for the host to read
// (the launch's barriers, the plan's figure measured).
__device__ __forceinline__ void lv_sync(const LvArgs& a) {
  fdb_grid_sync(a.sync);
  if (blockIdx.x == 0 && threadIdx.x == 0) a.flag[4] += 1u;
}

// Levels l0 .. n_levels - 1 as grid passes over the global runs, which
// hold W_{l0} and Q_{l0} in buffers cw and cq, and WC, QC in the counts.
// Each pass first copies samples of both runs (every ss-th key) into
// shared memory; an element's two bisections then run over the samples
// there and only over a window of fewer than ss keys in L2.
__device__ __forceinline__ void lv_grid_levels(const LvArgs& a, int l0,
                                               int cw, int cq, u64* sm) {
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gstride = gridDim.x * blockDim.x;
  const int T = a.T;
  const int nw = lv_n(a, 0), nq = lv_n(a, 1);
  const int32_t* WC = lv_cnt(a, 0);
  const int32_t* QC = lv_cnt(a, 1);
  int ss = 32;  // sample stride: at most LV_SAMPLES samples a set
  while ((long long)ss * LV_SAMPLES < max(nw, nq)) ss *= 2;
  u64* wsamp = sm;
  u64* qsamp = sm + LV_SAMPLES;
  // WC or QC at the first txn of block b of level l (b may be -1; the
  // txn index is clamped to [0, T + 1])
  auto count = [=](bool w, int b, int l) -> int {
    long long x = (long long)b * (1LL << l);
    x = x < 0 ? 0 : (x > T + 1 ? T + 1 : x);
    return __ldcg(&(w ? WC : QC)[x]);
  };
  for (int l = l0; l < a.n_levels; ++l) {
    const bool next = l + 1 < a.n_levels;
    const u64* wkey = lv_key(a, 0, cw);
    const u64* qkey = lv_key(a, 1, cq);
    for (int i = threadIdx.x; i * ss < nw; i += blockDim.x)
      wsamp[i] = __ldcg(&wkey[i * ss]);
    for (int i = threadIdx.x; i * ss < nq; i += blockDim.x)
      qsamp[i] = __ldcg(&qkey[i * ss]);
    __syncthreads();
    for (int e = gtid; e < nw + nq; e += gstride) {
      const bool wr = e < nw;
      const int set = wr ? 0 : 1;
      const int p = wr ? e : e - nw;
      const int o = __ldcg(&lv_own(a, set, wr ? cw : cq)[p]);
      const u64 k = __ldcg(&(wr ? wkey : qkey)[p]);
      const int wv = wr ? __ldg(&a.wer[(int)(k & 0xffffffffu)]) : -1;
      // c: this element's txn block at level l; b: its level block
      const int c = o >> l;
      const int b = wr ? c : c - 1;
      const int w_lo = count(true, b, l);
      const int q_lo = count(false, b + 1, l);
      // the other set's block b: for a write Q_l's txn block b + 1, for a
      // query W_l's txn block b (empty for b = -1)
      int o0, o1;
      if (wr) {
        o0 = q_lo;
        o1 = count(false, b + 2, l);
      } else {
        o0 = b < 0 ? 0 : w_lo;
        o1 = b < 0 ? 0 : count(true, b + 1, l);
      }
      // the sibling txn block of this level in the same set
      const int own_lo = count(wr, c, l);
      const int s0 = next ? count(wr, c ^ 1, l) : 0;
      const int s1 = next ? count(wr, (c ^ 1) + 1, l) : 0;
      const u64 t = lv_cross_target(wr, k);
      int x0, x1, y0, y1;
      lv_window(wr ? qsamp : wsamp, ss, o0, o1, t, &x0, &x1);
      lv_window(wr ? wsamp : qsamp, ss, s0, s1, k, &y0, &y1);
      int before, below;
      lv_two_ranks<true>(wr ? qkey : wkey, x0, x1, t, wr ? wkey : qkey, y0,
                         y1, k, &before, &below);
      before += x0 - o0;
      below += y0 - s0;
      lv_write(a, l, wr, k, p + (wr ? q_lo : w_lo) + before, w_lo + q_lo,
               wv);
      if (next) {
        const int np = count(wr, c & ~1, l) + (p - own_lo) + below;
        const int to = (wr ? cw : cq) ^ 1;
        lv_own(a, set, to)[np] = o;
        lv_key(a, set, to)[np] = k;
      }
    }
    if (next) {
      cw ^= 1;
      cq ^= 1;
      lv_sync(a);  // also keeps the samples until all are done
    }
  }
}

// Elements of v[0, n) below x (v nondecreasing), four searches at once
// in a warp: lanes 8g .. 8g + 7 run search g (their own v, n, x), each
// round probing 8 evenly spaced points, so n = 2^15 takes 5 rounds of
// dependent loads for all four. Every lane returns its group's answer.
__device__ __forceinline__ int lv_group_lower_bound(const int32_t* v, int n,
                                                    long long x) {
  const int lane = threadIdx.x & 31, g = lane >> 3, j = lane & 7;
  int lo = 0, hi = n;
  while (__any_sync(0xffffffffu, lo < hi)) {
    const int step = (hi - lo + 7) >> 3;
    const int p = lo + j * step;
    const bool below = lo < hi && p < hi && __ldg(&v[p]) < x;
    const int c =
        __popc((__ballot_sync(0xffffffffu, below) >> (8 * g)) & 0xffu);
    if (lo < hi) {
      if (c == 0) {
        hi = lo;
      } else {
        const int next = lo + c * step;  // the first probe not below
        lo = lo + (c - 1) * step + 1;
        hi = min(hi, next);
      }
    }
  }
  return lo;
}

// Pass 0: true (in every thread of the CTA) if the span path cannot run:
// no span size, an owner out of range or out of order, or a span past
// LV_SPAN_CAP. Else WC[x] and QC[x] are written at every x that the span
// path reads: the multiples of half a span, and T + 1.
__device__ __forceinline__ bool lv_pass0(const LvArgs& a) {
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gstride = gridDim.x * blockDim.x;
  const int T = a.T, s = a.span_log2;
  bool bad = s < 1 || s > LV_SPAN_LOG2_MAX;
  for (int i = gtid; i < a.NW; i += gstride) {
    const int o = __ldg(&a.wtxn_c[i]);
    bad |= o < 0 || o > T - 1 || (i > 0 && __ldg(&a.wtxn_c[i - 1]) > o);
  }
  for (int j = gtid; j < a.NR; j += gstride) {
    const int o = __ldg(&a.rtxn[j]);
    bad |= o < 0 || o > T || (j > 0 && __ldg(&a.rtxn[j - 1]) > o);
  }
  // the same in every thread of the CTA: the warps below search together
  bad = __syncthreads_or(bad) != 0;
  if (!bad) {  // (another CTA may have found unsorted owners: it flags)
    int32_t* WC = lv_cnt(a, 0);
    int32_t* QC = lv_cnt(a, 1);
    const int half = 1 << (s - 1);
    const int points = (T + 1) / half + 2;  // k * half <= T + 1, and T + 1
    const int warp = gtid >> 5, warps = gstride >> 5;
    for (int k = warp; k < points; k += warps) {
      const long long x = k + 1 < points ? (long long)k * half : T + 1;
      if (x > T + 1) continue;
      // groups: WC[x], QC[x] / 2; at a span's start also its ends, the
      // writes up to a span on and the reads up to a span and a half
      const long long span = 1LL << s;
      const bool start = x <= T && (x & (span - 1)) == 0;
      const int g = (threadIdx.x & 31) >> 3;
      const long long xg =
          g < 2 ? x
                : min(x + span + (g == 3 ? span / 2 : 0), (long long)T + 1);
      const int n = g < 2 || start ? (g & 1 ? a.NR : a.NW) : 0;
      const int r = lv_group_lower_bound(g & 1 ? a.rtxn : a.wtxn_c, n, xg);
      const int wc = __shfl_sync(0xffffffffu, r, 0);
      const int qc = 2 * __shfl_sync(0xffffffffu, r, 8);
      const int we = __shfl_sync(0xffffffffu, r, 16);
      const int qe = 2 * __shfl_sync(0xffffffffu, r, 24);
      if ((threadIdx.x & 31) == 0) {
        WC[x] = wc;
        QC[x] = qc;
      }
      if (start) bad |= (we - wc) + (qe - qc) > LV_SPAN_CAP;
    }
  }
  return __syncthreads_or(bad) != 0;
}

// Elements of v[0, n) below x (v nondecreasing, in shared memory).
__device__ __forceinline__ int lv_smem_lower_bound(const int32_t* v, int n,
                                                   long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Local count lc[y] at txn x = x0 + y, y clamped to [0, lim].
__device__ __forceinline__ int lv_lc(const int32_t* lc, long long x,
                                     long long x0, int lim) {
  const long long y = x - x0;
  return lc[y < 0 ? 0 : (y > lim ? lim : y)];
}

// The span path's levels 0 .. min(s, n_levels) - 1 for span S, in one CTA.
// Shared memory: two buffers of LV_SPAN_CAP (key, owner), the writes at
// [0, nw), the queries at [nw, nw + nq); the local counts lcw and lcq
// (the span's writes, its queries, below each txn). Each level is the
// grid level's pass with every run and count in shared memory.
__device__ __forceinline__ void lv_span(const LvArgs& a, int S, u64* sk,
                                        int32_t* so, int32_t* lcw,
                                        int32_t* lcq) {
  const int T = a.T, s = a.span_log2;
  const int32_t* WC = lv_cnt(a, 0);
  const int32_t* QC = lv_cnt(a, 1);
  const int span = 1 << s;
  const int qspan = span + span / 2;  // the queries a span reads
  const long long x0 = (long long)S << s;
  const int wlo = __ldcg(&WC[x0]);
  const int whi = __ldcg(&WC[min(x0 + span, (long long)T + 1)]);
  const int qlo = __ldcg(&QC[x0]);
  const int qhi = __ldcg(&QC[min(x0 + qspan, (long long)T + 1)]);
  const int nw = whi - wlo, nq = qhi - qlo, n = nw + nq;
  u64* key0 = sk;
  u64* key1 = sk + LV_SPAN_CAP;
  int32_t* own0 = so;
  int32_t* own1 = so + LV_SPAN_CAP;
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    if (x < nw) {
      lv_element(a, 0, wlo + x, &own1[x], &key1[x]);
    } else {
      const int y = x - nw;  // read qlo / 2 + y / 2, lo query first
      const int j = qlo / 2 + y / 2;
      lv_element(a, 1, (y & 1) ? a.NR + j : j, &own1[x], &key1[x]);
    }
  }
  __syncthreads();
  // local counts (the owners arrive nondecreasing)
  for (int y = threadIdx.x; y <= span; y += blockDim.x)
    lcw[y] = lv_smem_lower_bound(own1, nw, x0 + y);
  for (int y = threadIdx.x; y <= qspan; y += blockDim.x)
    lcq[y] = lv_smem_lower_bound(own1 + nw, nq, x0 + y);
  __syncthreads();
  // level 0's runs: each txn's elements sorted by key, by counting within
  // the txn where txns are small, else by ranking merges over each set
  bool big = false;
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    const long long o = own1[x];
    const int32_t* lc = x < nw ? lcw : lcq;
    const int lim = x < nw ? span : qspan;
    big |= lv_lc(lc, o + 1, x0, lim) - lv_lc(lc, o, x0, lim) > 32;
  }
  int cur = 0;  // the buffer that holds the runs
  if (!__syncthreads_or(big)) {
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
      const long long o = own1[x];
      const int g0 = x < nw ? lv_lc(lcw, o, x0, span)
                            : nw + lv_lc(lcq, o, x0, qspan);
      const int g1 = x < nw ? lv_lc(lcw, o + 1, x0, span)
                            : nw + lv_lc(lcq, o + 1, x0, qspan);
      const u64 k = key1[x];
      int r = g0;
      for (int y = g0; y < g1; ++y) r += key1[y] < k;
      own0[r] = (int)o;
      key0[r] = k;
    }
  } else {
    cur = 1;
    for (int w = 1; w < max(nw, nq); w *= 2) {
      const int32_t* oi = cur ? own1 : own0;
      const u64* ki = cur ? key1 : key0;
      int32_t* oo = cur ? own0 : own1;
      u64* ko = cur ? key0 : key1;
      for (int x = threadIdx.x; x < n; x += blockDim.x) {
        const int base = x < nw ? 0 : nw;
        lv_merge_one<false>(oi + base, ki + base, oo + base, ko + base,
                            x < nw ? nw : nq, w, x - base);
      }
      cur ^= 1;
      __syncthreads();
    }
  }
  __syncthreads();
  const int top = min(s, a.n_levels);
  for (int l = 0; l < top; ++l) {
    const bool merge = l + 1 < a.n_levels;  // W_{l+1}, Q_{l+1} wanted
    const bool out = l + 1 == s;            // ... in global memory
    const long long bw = 1LL << l;          // txns of a block
    const int32_t* O = cur ? own1 : own0;
    const u64* K = cur ? key1 : key0;
    int32_t* O2 = cur ? own0 : own1;
    u64* K2 = cur ? key0 : key1;
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
      const bool wr = x < nw;
      const int p = wr ? x : x - nw;  // place in its set, in the span
      const int o = O[x];
      const u64 k = K[x];
      const int c = o >> l;
      const long long first = (long long)c * bw;
      // a query of txn block c belongs to level block c - 1: this span's
      // when that block's writes lie in it (c == 0: block -1, span 0's)
      const bool mine = wr || (first > x0 && first <= x0 + span) || c == 0;
      const int wv =
          wr && mine ? __ldg(&a.wer[(int)(k & 0xffffffffu)]) : -1;
      const int b = wr ? c : c - 1;
      const int32_t* lc = wr ? lcw : lcq;
      const int lim = wr ? span : qspan;
      const int base = wr ? 0 : nw;
      const bool merges = merge && (!out || (o >> s) == S);
      int o0 = 0, o1 = 0, s0 = 0, s1 = 0;
      if (mine) {
        if (wr) {
          o0 = nw + lv_lc(lcq, (b + 1) * bw, x0, qspan);
          o1 = nw + lv_lc(lcq, (b + 2) * bw, x0, qspan);
        } else if (b >= 0) {
          o0 = lv_lc(lcw, b * bw, x0, span);
          o1 = lv_lc(lcw, (b + 1) * bw, x0, span);
        }
      }
      if (merges) {
        s0 = base + lv_lc(lc, (c ^ 1) * bw, x0, lim);
        s1 = base + lv_lc(lc, ((c ^ 1) + 1) * bw, x0, lim);
      }
      int before, below;
      lv_two_ranks<false>(K, o0, o1, lv_cross_target(wr, k), K, s0, s1, k,
                          &before, &below);
      if (mine) {
        const int w_lo = wlo + lv_lc(lcw, b * bw, x0, span);
        const int q_lo = qlo + lv_lc(lcq, (b + 1) * bw, x0, qspan);
        const int pos = (wr ? wlo + p + q_lo : w_lo + qlo + p) + before;
        lv_write(a, l, wr, k, pos, w_lo + q_lo, wv);
      }
      if (merges) {
        const int np = lv_lc(lc, (c & ~1) * bw, x0, lim) +
                       (p - lv_lc(lc, c * bw, x0, lim)) + below;
        if (out) {  // W_s, Q_s: this span's block of each
          const int set = wr ? 0 : 1;
          lv_own(a, set, 0)[(wr ? wlo : qlo) + np] = o;
          lv_key(a, set, 0)[(wr ? wlo : qlo) + np] = k;
        } else {
          O2[base + np] = o;
          K2[base + np] = k;
        }
      }
    }
    cur ^= 1;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(LV_THREADS, 1)
intra_levels_kernel(LvArgs a) {
  extern __shared__ u64 lv_smem[];
  __shared__ int s_general;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gstride = gridDim.x * blockDim.x;
  const int T = a.T;

  // 0. the path: the flag is read by every CTA after the barrier; the
  // last CTA to read it zeroes it and the count for the next launch
  if (blockIdx.x == 0 && threadIdx.x == 0) a.flag[4] = 0u;
  if (lv_pass0(a) && threadIdx.x == 0) atomicOr(&a.flag[0], 1u);
  lv_sync(a);
  if (threadIdx.x == 0) {
    s_general = fdb_ld_volatile(&a.flag[0]) != 0u;
    __threadfence();
    if (atomicAdd(&a.flag[1], 1u) == gridDim.x - 1) {
      a.flag[0] = 0u;
      a.flag[1] = 0u;
    }
    if (blockIdx.x == 0) a.flag[s_general ? 3 : 2] += 1u;
  }
  __syncthreads();

  if (!s_general) {
    // span path: levels below s in shared memory, a CTA a span
    int32_t* so = reinterpret_cast<int32_t*>(lv_smem + 2 * LV_SPAN_CAP);
    int32_t* lcw = so + 2 * LV_SPAN_CAP;
    int32_t* lcq = lcw + LV_SPAN_MAX + 1;
    const int spans = (T >> a.span_log2) + 1;
    for (int S = blockIdx.x; S < spans; S += gridDim.x)
      lv_span(a, S, lv_smem, so, lcw, lcq);
    if (a.span_log2 < a.n_levels) {
      lv_sync(a);
      lv_grid_levels(a, a.span_log2, 0, 0, lv_smem);
    }
    return;
  }

  // general path. 1. tile sort of W_0 and Q_0 into buffer 0
  u64* k0 = lv_smem;
  u64* k1 = lv_smem + LV_TILE;
  int32_t* o0 = reinterpret_cast<int32_t*>(lv_smem + 2 * LV_TILE);
  int32_t* o1 = o0 + LV_TILE;
  const int tiles0 = (a.NW + LV_TILE - 1) / LV_TILE;
  const int tiles = tiles0 + (2 * a.NR + LV_TILE - 1) / LV_TILE;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int s = tile < tiles0 ? 0 : 1;
    const int base = (s == 0 ? tile : tile - tiles0) * LV_TILE;
    const int n = min(LV_TILE, lv_n(a, s) - base);
    for (int x = threadIdx.x; x < n; x += blockDim.x)
      lv_element(a, s, base + x, &o0[x], &k0[x]);
    __syncthreads();
    int from = 0;
    for (int w = 1; w < n; w *= 2) {
      for (int x = threadIdx.x; x < n; x += blockDim.x)
        lv_merge_one<false>(from ? o1 : o0, from ? k1 : k0, from ? o0 : o1,
                            from ? k0 : k1, n, w, x);
      from ^= 1;
      __syncthreads();
    }
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
      lv_own(a, s, 0)[base + x] = (from ? o1 : o0)[x];
      lv_key(a, s, 0)[base + x] = (from ? k1 : k0)[x];
    }
    __syncthreads();
  }
  lv_sync(a);

  // 2. merge rounds over global memory, both sets in each pass
  int cw = 0, cq = 0;
  for (int w = LV_TILE; w < max(a.NW, 2 * a.NR); w *= 2) {
    for (int s = 0; s < 2; ++s) {
      const int n = lv_n(a, s);
      if (w >= n) continue;
      const int c = s ? cq : cw;
      for (int x = gtid; x < n; x += gstride)
        lv_merge_one<true>(lv_own(a, s, c), lv_key(a, s, c),
                           lv_own(a, s, c ^ 1), lv_key(a, s, c ^ 1), n, w,
                           x);
      if (s) cq ^= 1; else cw ^= 1;
    }
    lv_sync(a);
  }

  // 3. WC[x], QC[x] = elements with owner < x, x in [0, T + 1]
  for (int s = 0; s < 2; ++s) {
    const int32_t* own = lv_own(a, s, s ? cq : cw);
    const int n = lv_n(a, s);
    for (int x = gtid; x < T + 2; x += gstride) {
      int lo = 0, hi = n;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldcg(&own[mid]) < x) lo = mid + 1; else hi = mid;
      }
      lv_cnt(a, s)[x] = lo;
    }
  }
  lv_sync(a);

  // 4. a pass a level
  lv_grid_levels(a, 0, cw, cq, lv_smem);
}

static int g_lv_per_sm[64];
static int g_lv_smem[64];

// wtxn_c, wbr, wer: NW int32; rtxn, rbr, rer: NR int32. Outputs: src, werl
// (n_levels, M) int32, is_w, bnd (n_levels, M) uint8, qlo, qhi (n_levels,
// NR) int32, M = NW + 2 NR >= 1. span_log2: s of the span path, 0 to
// take the general path always. Scratch: keys, 2 * (NW + 2 NR) u64
// (8-byte aligned); owners, 2 * (NW + 2 NR) int32; counts, 2 * (T + 2)
// int32, all overwritten; sync, one word whose low 31 bits are zero on
// entry and are left so; flag, five words: two zero on entry and left so,
// then the span-path and general-path launch counters (each launch adds
// one to the one it took) and the launch's grid barriers. One cooperative
// launch on `stream`.
extern "C" int fdb_intra_levels(
    const int32_t* wtxn_c, const int32_t* rtxn, const int32_t* rbr,
    const int32_t* rer, const int32_t* wbr, const int32_t* wer, int T,
    int NW, int NR, int n_levels, int span_log2, unsigned long long* keys,
    int32_t* owners, int32_t* counts, unsigned int* sync, unsigned int* flag,
    int32_t* src, uint8_t* is_w, int32_t* werl, uint8_t* bnd, int32_t* qlo,
    int32_t* qhi, void* stream) {
  const long long M = (long long)NW + 2LL * NR;
  if (T < 1 || NW < 0 || NR < 0 || M < 1 || M >= (1LL << 30) ||
      n_levels < 1 || n_levels > 31 ||
      (long long)n_levels * M >= (1LL << 31) || span_log2 < 0 ||
      span_log2 > n_levels)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  FdbDeviceLimits lim;
  cudaError_t e = fdb_device_limits(&dev, &lim);
  if (e != cudaSuccess) return (int)e;
  e = fdb_allow_smem(intra_levels_kernel, dev, LV_SMEM, g_lv_smem);
  if (e != cudaSuccess) return (int)e;
  if (g_lv_per_sm[dev] == 0) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, intra_levels_kernel, LV_THREADS, LV_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    g_lv_per_sm[dev] = per_sm;
  }
  LvArgs a;
  a.wtxn_c = wtxn_c; a.rtxn = rtxn; a.rbr = rbr; a.rer = rer;
  a.wbr = wbr; a.wer = wer;
  a.T = T; a.NW = NW; a.NR = NR; a.n_levels = n_levels;
  a.span_log2 = span_log2;
  a.owners = owners;
  a.keys = keys;
  a.counts = counts;
  a.sync = sync;
  a.flag = flag;
  a.src = src; a.is_w = is_w; a.werl = werl; a.bnd = bnd;
  a.qlo = qlo; a.qhi = qhi;
  // enough CTAs for the tiles, the spans, the elements or the counts, at
  // most what is co-resident
  const long long tiles = (NW + LV_TILE - 1) / LV_TILE +
                          (2LL * NR + LV_TILE - 1) / LV_TILE;
  const long long spans = span_log2 > 0 ? ((long long)T >> span_log2) + 1 : 0;
  long long want = (M + LV_THREADS - 1) / LV_THREADS;
  want = want > tiles ? want : tiles;
  want = want > spans ? want : spans;
  const long long want_c = ((long long)T + 2 + LV_THREADS - 1) / LV_THREADS;
  want = want > want_c ? want : want_c;
  const long long cap = (long long)lim.sms * g_lv_per_sm[dev];
  const int G = (int)(want < cap ? want : cap);
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)intra_levels_kernel, dim3(G),
                                  dim3(LV_THREADS), params, LV_SMEM,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
