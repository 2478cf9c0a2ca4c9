// K3 intra_sandwich: the whole intra-batch sandwich of the scan evaluator
// ("earlier transactions win") in one persistent, cooperative launch.
//
// Replaces: foundationdb_tpu/ops/conflict.py `_run_sandwich` (:311-334),
// the `lax.scan` over `lax.cond` that the jitted step runs, with every
// evaluation of its map f: `_f_commit` (:537-541) over
// `_intra_scan_blocked` (:295-308) and `_seg_cummax` (:227-236). Given a
// committed set c (T,), with cm[l][i] = is_w & c[wtxn_c[src]] & w_ok[src]
// at level element i (src = src[l][i]):
//   case A: pref = inclusive prefix sum of cm; a read j is blocked when
//           pref[qhi[l][j]] - pref[qlo[l][j]] > 0,
//   case B: segmax = running max of (cm ? werl : -1) restarting at bnd;
//           a read j is blocked when segmax[qlo[l][j]] > rbr[j];
// f(c)[t] = g[t] & no blocked read with r_ok belongs to t. The sandwich is
//   upper = g; lower = f(upper);
//   up to `rounds` times, while lower != upper:
//     upper = f(lower); lower = f(upper);
//   converged = (lower == upper),
// the same values as conflict_ref.run_sandwich for every rounds >= 0.
//
// Bound on H100: bytes. The function reads the level geometry (10 B per
// level element), the queries (8 B per read and level) and the reads once,
// and writes 2 T + 1 bytes: ~9.6 MB at the kernel bench's T = 16,384
// (M = 49,152, 14 levels), ~2.9 us of HBM time; ~21 MB (~6.2 us) at
// T = 32,768; ~1.7 MB (~0.5 us) at the resolver's M = 12,288, 10 levels.
// Each evaluation is a few integer operations per element, far below that.
//
// Design. Evaluations issued one by one from a host loop cost a step
// about 195 launches and 32 pinch reductions, most of them for rounds
// that the pinch test then skips, and each re-gathers c[wtxn_c[src[i]]]
// and re-writes (levels, M, 2) prefix arrays. So the loop runs on chip:
//   - one CTA per SM, launched with cudaLaunchCooperativeKernel so that
//     all CTAs are co-resident; grid-wide barriers are one atomic counter
//     whose top bit flips once every CTA has arrived (common.cuh
//     `fdb_grid_sync`, no -rdc needed). A
//     refused launch (too much shared memory, too few co-resident CTAs)
//     returns its CUDA error, and the Python wrapper raises.
//   - the levels are scanned as ONE flat sequence of n_levels * M
//     elements: every level starts with bnd set, so the segmented max
//     restarts there, and case A only takes differences of pref inside a
//     level, so a prefix sum that runs on across levels gives the same
//     answers. Each CTA owns a contiguous chunk of that sequence.
//   - before the first evaluation the kernel pre-folds each element into
//     an 8-byte record, built once in global scratch and then copied into
//     the owning CTA's shared memory:
//       x = wtxn_c[src] for a write with w_ok, -2 - 2 j for the lo query of
//           a read j with r_ok, -3 - 2 j for its hi query, else -1;
//       y = bnd << 31 | werl (a write) or rbr[j] (a lo query).
//     So cm is one shared-memory lookup, bit x of c, and every CTA keeps
//     all of c, of g and of its own marks as bit sets (T / 8 bytes each)
//     in shared memory.
//   - per evaluation, three barriers: each CTA reduces its chunk to a
//     (sum, max, reset) aggregate; barrier; each CTA folds the aggregates
//     of the CTAs before it (a look-back over statically assigned chunks)
//     and rescans, and at a query element writes what the read needs at
//     the read's own index: pref at hi, and pref at lo (or -2^30 when case
//     B already blocks it); barrier; one thread per (read, level) pair
//     tests it and sets the read's txn's bit in the CTA's mark bit set,
//     which is then ORed into a global one, word by word; barrier;
//     every CTA folds all T / 32 mark words into its own copy of c (c =
//     g & ~marks, 32 txns an operation) and compares it with the old c, so
//     all CTAs reach the same pinch verdict with no further barrier. The
//     marks alternate between two bit sets: an evaluation clears the
//     previous one's slice by slice, and the last CTA to read the final
//     marks clears them.
// Shared memory per CTA: 3 T / 8 bytes (the bit sets), 4 B per
// owned read, 8 B per owned element; elements past the opt-in limit
// (227 KB) are read from the global records instead, so any M works.
// About 102 KB at the bench's T = 32,768 (M = 98,304, 15 levels, 11,171
// elements a CTA), 48 KB at T = 16,384, 8 KB at the resolver's M = 12,288
// (10 levels).
// Where the bit sets and the owned reads do not fit (3 T / 8 + 4 NR / G
// bytes past the opt-in limit: above about 450,000 to 570,000 txns, by
// the reads a txn) the kernel runs with its bit sets in global memory
// (GB = true; T / 8 bytes each, L2 resident: 128 KB at T = 2^20), and the
// shared memory holds only cached records. One copy of c and g serves
// every CTA, so the step-6 fold is split: each CTA folds its own slice of
// words into c and ORs "differs" into a flag word, and one more grid
// barrier lets every CTA read the flag (three flag words rotate, so one is
// cleared while another is read).
// A CTA marks reads straight into the global mark words, and reads rtxn
// and r_ok from global memory. The wrapper picks the layout from the
// shape; no shape that `_run_sandwich` answers is refused.
#include "common.cuh"

#define SAND_THREADS 1024
#define SAND_MAX_GRID 1024
#define REC_BND 0x80000000u
#define SLOT_BLOCKED (-(1 << 30))

struct SweepElem {
  int sum;  // committed writes so far (case A)
  int mv;   // running max of committed write-end ranks (case B)
  int r;    // a segment reset lies in the span
  static __device__ __forceinline__ SweepElem shfl_up(SweepElem x, int d) {
    return {fdb_shfl_up(x.sum, d), fdb_shfl_up(x.mv, d), fdb_shfl_up(x.r, d)};
  }
};
struct SweepOp {
  __device__ __forceinline__ SweepElem operator()(SweepElem a,
                                                  SweepElem b) const {
    return {a.sum + b.sum, b.r ? b.mv : max(a.mv, b.mv), a.r | b.r};
  }
};
__device__ __forceinline__ SweepElem sweep_id() { return {0, INT_MIN, 0}; }

// The record of a level element as a scan element under c (in shared
// memory, or with GB in global memory that other CTAs rewrite).
template <bool GB>
__device__ __forceinline__ SweepElem rec_elem(int2 rec,
                                              const unsigned int* c_bits) {
  const bool cm =
      rec.x >= 0 &&
      (((GB ? __ldcg(&c_bits[rec.x >> 5]) : c_bits[rec.x >> 5]) >>
        (rec.x & 31)) & 1u);
  return {cm ? 1 : 0, cm ? (int)((unsigned)rec.y & ~REC_BND) : -1,
          (int)((unsigned)rec.y >> 31)};
}

struct SandArgs {
  const uint8_t* g;
  const int32_t* src;
  const uint8_t* is_w;
  const int32_t* werl;
  const uint8_t* bnd;
  const int32_t* qlo;
  const int32_t* qhi;
  const int32_t* wtxn_c;
  const uint8_t* w_ok;
  const uint8_t* r_ok;
  const int32_t* rtxn;
  const int32_t* rbr;
  int n_levels, T, M, NR, rounds;
  int E;          // n_levels * M
  int chunk;      // elements a CTA owns
  int cached;     // of which the first `cached` sit in shared memory
  int rpc, tpc;   // reads and txns a CTA owns
  int per_thread; // elements a thread scans (odd: no bank conflicts)
  int W;          // words of a txn bit set: ceil(T / 32)
  int wpc;        // mark words a CTA clears
  int bits_bytes; // shared bytes of one bit set (4 W rounded up to 16)
  int2* rec;      // E records (global scratch)
  int4* agg;      // gridDim.x chunk aggregates
  int32_t* slot_lo;  // n_levels * NR
  int32_t* slot_hi;
  unsigned int* marks;  // 2 W: two bit sets, zero on entry and on exit
  unsigned int* sync;  // [0] barrier arrivals (low 31 bits zero),
                       // [1] CTAs done with the last marks (zero)
  unsigned int* bits;  // GB: 2 W words, c and g (overwritten)
  unsigned int* differ;  // GB: 3 flag words, zero on entry and on exit
  uint8_t* lower;
  uint8_t* upper;
  uint8_t* converged;
  int32_t* evals;
};

struct SandSmem {
  unsigned int* c;  // the committed set, a bit per txn (GB: global)
  unsigned int* g;  // the eligible set, a bit per txn (GB: global)
  unsigned int* m;  // this CTA's marks of an evaluation (not with GB)
  int32_t* rt;  // rtxn of each owned read with r_ok, else -1 (not GB)
  int2* rec;
  SweepElem* scan;  // 32 for the block scans
};

__device__ __forceinline__ int2 rec_at(const SandArgs& a, const SandSmem& s,
                                       int e0, int i) {
  return i < a.cached ? s.rec[i] : __ldcg(&a.rec[e0 + i]);
}

// c = f(c), in place in every CTA's shared memory (GB: in the one global
// copy); each CTA also writes its own slice of the new c to `out`.
// `marks` (W words) is zero on entry and gets this evaluation's marks;
// `spent`, the previous evaluation's, is cleared slice by slice. Returns
// whether the new c differs from the old one, the same in every CTA:
// every CTA folds all the marks itself (GB: through a flag word and one
// more grid barrier). `e` numbers the evaluation.
template <bool GB>
__device__ bool sand_eval(const SandArgs& a, const SandSmem& s,
                          unsigned int* marks, unsigned int* spent,
                          uint8_t* out, int e) {
  const SweepOp op;
  const int b = blockIdx.x;
  const int e0 = b * a.chunk;
  const int n_mine = max(0, min(a.chunk, a.E - e0));
  const int t0 = min(b * a.tpc, a.T);
  const int t1 = min(t0 + a.tpc, a.T);

  // 1. reduce: each thread a contiguous run of its CTA's chunk
  const int i_lo = min((int)threadIdx.x * a.per_thread, n_mine);
  const int i_hi = min(i_lo + a.per_thread, n_mine);
  SweepElem acc = sweep_id();
  for (int i = i_lo; i < i_hi; ++i)
    acc = op(acc, rec_elem<GB>(rec_at(a, s, e0, i), s.c));
  SweepElem total;
  const SweepElem excl =
      fdb_block_exclusive_scan(acc, op, sweep_id(), s.scan, &total);
  if (threadIdx.x == 0)
    __stcg(&a.agg[b], make_int4(total.sum, total.mv, total.r, 0));
  fdb_grid_sync(a.sync);

  // 2. every CTA has read the previous evaluation's marks: clear a slice
  const int w_end = min((b + 1) * a.wpc, a.W);
  for (int w = b * a.wpc + threadIdx.x; w < w_end; w += blockDim.x)
    spent[w] = 0;

  // 3. the aggregates of the chunks before this one
  SweepElem carry = sweep_id();
  for (int base = 0; base < b; base += blockDim.x) {
    const int k = base + threadIdx.x;
    SweepElem v = sweep_id();
    if (k < b) {
      const int4 q = __ldcg(&a.agg[k]);
      v = {q.x, q.y, q.z};
    }
    SweepElem t;
    fdb_block_exclusive_scan(v, op, sweep_id(), s.scan, &t);
    carry = op(carry, t);
  }

  // 4. rescan; a query element leaves what its read needs at the read's
  // own index
  SweepElem run = op(carry, excl);
  for (int i = i_lo; i < i_hi; ++i) {
    const int2 r = rec_at(a, s, e0, i);
    run = op(run, rec_elem<GB>(r, s.c));
    if (r.x <= -2) {
      const int code = -2 - r.x;
      const int level = (e0 + i) / a.M;
      const long long slot = (long long)level * a.NR + (code >> 1);
      if (code & 1) {
        __stcg(&a.slot_hi[slot], run.sum);
      } else {
        const int rb = (int)((unsigned)r.y & ~REC_BND);
        __stcg(&a.slot_lo[slot], run.mv > rb ? SLOT_BLOCKED : run.sum);
      }
    }
  }
  fdb_grid_sync(a.sync);

  // 5. one thread per owned (read, level) pair, so that the slot loads of
  // all levels are in flight at once: blocked -> mark the read's txn in
  // the CTA's own bit set, then one global OR per word it touched (a
  // CTA's reads belong to few txns, so few words)
  for (int k = threadIdx.x; k < a.rpc * a.n_levels; k += blockDim.x) {
    const int l = k / a.rpc;
    const int jj = k - l * a.rpc;
    const int j = b * a.rpc + jj;
    int t;
    if (GB) {
      t = (j < a.NR && a.r_ok[j]) ? a.rtxn[j] : -1;
    } else {
      t = s.rt[jj];
    }
    if (t < 0) continue;
    const long long slot = (long long)l * a.NR + j;
    if (__ldcg(&a.slot_hi[slot]) - __ldcg(&a.slot_lo[slot]) > 0)
      atomicOr(GB ? &marks[t >> 5] : &s.m[t >> 5], 1u << (t & 31));
  }
  if (!GB) {
    __syncthreads();
    for (int w = threadIdx.x; w < a.W; w += blockDim.x) {
      const unsigned int v = s.m[w];
      if (v) {
        atomicOr(&marks[w], v);
        s.m[w] = 0;
      }
    }
  }
  fdb_grid_sync(a.sync);

  // 6. c = g & ~marks, 32 txns a word, compared with the old c
  int differ = 0;
  if constexpr (GB) {
    // this CTA's slice of c; no CTA reads c again before the barrier below
    for (int w = b * a.wpc + threadIdx.x; w < w_end; w += blockDim.x) {
      const unsigned int v = __ldcg(&s.g[w]) & ~__ldcg(&marks[w]);
      differ |= v != __ldcg(&s.c[w]);
      s.c[w] = v;
    }
    for (int t = t0 + threadIdx.x; t < t1; t += blockDim.x)
      out[t] = a.g[t] && !((__ldcg(&marks[t >> 5]) >> (t & 31)) & 1u);
    if (__syncthreads_or(differ) && threadIdx.x == 0)
      atomicOr(&a.differ[e % 3], 1u);
    // the flag word of the next evaluation was last read two evaluations
    // ago, before barriers every CTA has passed
    if (b == 0 && threadIdx.x == 0) a.differ[(e + 1) % 3] = 0u;
    fdb_grid_sync(a.sync);
    return __ldcg(&a.differ[e % 3]) != 0u;
  } else {
    for (int w = threadIdx.x; w < a.W; w += blockDim.x) {
      const unsigned int v = s.g[w] & ~__ldcg(&marks[w]);
      differ |= v != s.c[w];
      s.c[w] = v;
    }
    const bool d = __syncthreads_or(differ);
    for (int t = t0 + threadIdx.x; t < t1; t += blockDim.x)
      out[t] = (s.c[t >> 5] >> (t & 31)) & 1u;
    return d;
  }
}

template <bool GB>
__global__ void __launch_bounds__(SAND_THREADS, 1)
sandwich_kernel(SandArgs a) {
  extern __shared__ __align__(16) unsigned char sand_smem[];
  __shared__ SweepElem sh_scan[32];
  __shared__ bool sh_last;
  SandSmem s;
  if (GB) {
    s.c = a.bits;
    s.g = a.bits + a.W;
    s.m = nullptr;
    s.rt = nullptr;
    s.rec = reinterpret_cast<int2*>(sand_smem);
  } else {
    s.c = reinterpret_cast<unsigned int*>(sand_smem);
    s.g = reinterpret_cast<unsigned int*>(sand_smem + a.bits_bytes);
    s.m = reinterpret_cast<unsigned int*>(sand_smem + 2 * a.bits_bytes);
    s.rt = reinterpret_cast<int32_t*>(sand_smem + 3 * a.bits_bytes);
    s.rec = reinterpret_cast<int2*>(sand_smem + 3 * a.bits_bytes +
                                    ((a.rpc * 4 + 15) & ~15));
  }
  s.scan = sh_scan;
  const int b = blockIdx.x;

  // prologue: the records in global scratch (writes from the elements,
  // queries from the (level, read) pairs: every element is one of the two)
  const int gtid = b * blockDim.x + threadIdx.x;
  const int gstride = gridDim.x * blockDim.x;
  for (int gi = gtid; gi < a.E; gi += gstride) {
    if (a.is_w[gi]) {
      const int w = a.src[gi];
      a.rec[gi] = make_int2(a.w_ok[w] ? a.wtxn_c[w] : -1,
                            (int)(((unsigned)a.werl[gi] & ~REC_BND) |
                                  (a.bnd[gi] ? REC_BND : 0u)));
    }
  }
  const int nq = a.n_levels * a.NR;
  for (int q = gtid; q < nq; q += gstride) {
    const int l = q / a.NR;
    const int j = q - l * a.NR;
    const int lo = l * a.M + a.qlo[q];
    const int hi = l * a.M + a.qhi[q];
    const bool ok = a.r_ok[j];
    a.rec[lo] = make_int2(ok ? -2 - 2 * j : -1,
                          (int)((ok ? (unsigned)a.rbr[j] : 0u) |
                                (a.bnd[lo] ? REC_BND : 0u)));
    a.rec[hi] = make_int2(ok ? -3 - 2 * j : -1,
                          (int)(a.bnd[hi] ? REC_BND : 0u));
  }
  if (!GB) {
    for (int k = threadIdx.x; k < a.rpc; k += blockDim.x) {
      const int j = b * a.rpc + k;
      s.rt[k] = (j < a.NR && a.r_ok[j]) ? a.rtxn[j] : -1;
    }
  }
  // g and c = g as bit sets, m empty: each CTA all of its own copy, or
  // (GB) its slice of the one global copy
  const int w_first = GB ? b * a.wpc : 0;
  const int w_last = GB ? min((b + 1) * a.wpc, a.W) : a.W;
  for (int w = w_first + threadIdx.x; w < w_last; w += blockDim.x) {
    unsigned int word = 0;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int t = w * 32 + k;
      if (t < a.T && __ldg(&a.g[t])) word |= 1u << k;
    }
    s.g[w] = s.c[w] = word;
    if (!GB) s.m[w] = 0;
  }
  {
    const int t0 = min(b * a.tpc, a.T);
    const int t1 = min(t0 + a.tpc, a.T);
    for (int t = t0 + threadIdx.x; t < t1; t += blockDim.x)
      a.upper[t] = a.g[t];
  }
  fdb_grid_sync(a.sync);
  {
    const int e0 = b * a.chunk;
    const int n_cache = max(0, min(a.cached, a.E - e0));
    for (int i = threadIdx.x; i < n_cache; i += blockDim.x)
      s.rec[i] = __ldcg(&a.rec[e0 + i]);
  }
  __syncthreads();

  // the sandwich: evaluation e marks into buffer e & 1 and clears the
  // other; `differ` is the same in every CTA, so the exit is uniform
  unsigned int* marks[2] = {a.marks, a.marks + a.W};
  bool differ = sand_eval<GB>(a, s, marks[0], marks[1], a.lower, 0);
  int evals = 1;
  for (int r = 0; differ && r < a.rounds; ++r) {
    sand_eval<GB>(a, s, marks[evals & 1], marks[(evals + 1) & 1], a.upper,
                  evals);
    differ = sand_eval<GB>(a, s, marks[(evals + 1) & 1], marks[evals & 1],
                           a.lower, evals + 1);
    evals += 2;
  }

  // the last CTA to finish reading the last marks clears them
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    sh_last = atomicAdd(&a.sync[1], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (sh_last) {
    __threadfence();
    unsigned int* last = marks[(evals - 1) & 1];
    for (int w = threadIdx.x; w < a.W; w += blockDim.x) last[w] = 0;
    if (GB && threadIdx.x < 3) a.differ[threadIdx.x] = 0u;
    if (threadIdx.x == 0) a.sync[1] = 0;
  }
  if (b == 0 && threadIdx.x == 0) {
    *a.converged = differ ? 0 : 1;
    *a.evals = evals;
  }
}

// The largest dynamic shared memory granted so far, per layout and
// device, and each layout's static share, read once.
static int g_sand_smem[2][64];
static int g_static_smem[2] = {-1, -1};

template <bool GB>
static cudaError_t sand_static_smem() {
  if (g_static_smem[GB] >= 0) return cudaSuccess;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, sandwich_kernel<GB>);
  if (e == cudaSuccess) g_static_smem[GB] = (int)attr.sharedSizeBytes;
  return e;
}

template <bool GB>
static cudaError_t sand_launch(SandArgs* a, int G, int dev, int dyn,
                               cudaStream_t stream) {
  cudaError_t e =
      fdb_allow_smem(sandwich_kernel<GB>, dev, (size_t)dyn, g_sand_smem[GB]);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sandwich_kernel<GB>, SAND_THREADS, dyn);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {a};
  e = cudaLaunchCooperativeKernel((const void*)sandwich_kernel<GB>, dim3(G),
                                  dim3(SAND_THREADS), params, (size_t)dyn,
                                  stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// rec: 2 * n_levels * M int32, agg: 4 * SAND_MAX_GRID int32, slots:
// 2 * n_levels * NR int32 and bits: 2 * ceil(T / 32) uint32 of scratch,
// all overwritten; marks: 2 * ceil(T / 32) uint32, sync: 2 uint32 and
// differ: 3 uint32, marks, sync[1] and differ zero and sync[0]'s low 31
// bits zero on entry, all left so. The bit sets go to shared memory when
// they fit beside the owned reads, else to `bits`. One cooperative launch
// on `stream`.
extern "C" int fdb_intra_sandwich(
    const uint8_t* g, const int32_t* src, const uint8_t* is_w,
    const int32_t* werl, const uint8_t* bnd, const int32_t* qlo,
    const int32_t* qhi, const int32_t* wtxn_c, const uint8_t* w_ok,
    const uint8_t* r_ok, const int32_t* rtxn, const int32_t* rbr,
    int n_levels, int T, int M, int NR, int rounds, int32_t* rec,
    int32_t* agg, int32_t* slots, unsigned int* bits, unsigned int* marks,
    unsigned int* sync, unsigned int* differ, uint8_t* lower,
    uint8_t* upper, uint8_t* converged, int32_t* evals, void* stream) {
  int dev = 0;
  FdbDeviceLimits lim;
  cudaError_t e = fdb_device_limits(&dev, &lim);
  if (e != cudaSuccess) return (int)e;
  const int G = lim.sms < SAND_MAX_GRID ? lim.sms : SAND_MAX_GRID;
  const long long E = (long long)n_levels * M;
  if (E >= (1LL << 30) || (long long)n_levels * NR >= (1LL << 29) || T < 1)
    return (int)cudaErrorInvalidValue;
  e = sand_static_smem<false>();
  if (e == cudaSuccess) e = sand_static_smem<true>();
  if (e != cudaSuccess) return (int)e;

  SandArgs a;
  a.g = g; a.src = src; a.is_w = is_w; a.werl = werl; a.bnd = bnd;
  a.qlo = qlo; a.qhi = qhi; a.wtxn_c = wtxn_c; a.w_ok = w_ok;
  a.r_ok = r_ok; a.rtxn = rtxn; a.rbr = rbr;
  a.n_levels = n_levels; a.T = T; a.M = M; a.NR = NR;
  a.rounds = rounds > 0 ? rounds : 0;
  a.E = (int)E;
  a.chunk = (int)((E + G - 1) / G);
  a.rpc = (NR + G - 1) / G;
  a.tpc = (T + G - 1) / G;
  a.per_thread = (a.chunk + SAND_THREADS - 1) / SAND_THREADS;
  if (a.per_thread % 2 == 0) a.per_thread += 1;
  a.W = (T + 31) / 32;
  a.wpc = (a.W + G - 1) / G;
  a.bits_bytes = (4 * a.W + 15) & ~15;
  long long fixed = 3LL * a.bits_bytes + ((a.rpc * 4LL + 15) & ~15LL);
  long long avail = (long long)lim.smem_optin - (long long)g_static_smem[0];
  const bool global_bits = fixed > avail;
  if (global_bits) {
    fixed = 0;
    avail = (long long)lim.smem_optin - (long long)g_static_smem[1];
  }
  const long long fit = (avail - fixed) / 8;
  a.cached = fit < a.chunk ? (int)fit : a.chunk;
  const int dyn = (int)(fixed + 8LL * a.cached);
  a.rec = reinterpret_cast<int2*>(rec);
  a.agg = reinterpret_cast<int4*>(agg);
  a.slot_lo = slots;
  a.slot_hi = slots + (long long)n_levels * NR;
  a.marks = marks;
  a.sync = sync;
  a.bits = bits;
  a.differ = differ;
  a.lower = lower; a.upper = upper; a.converged = converged;
  a.evals = evals;

  return (int)(global_bits
                   ? sand_launch<true>(&a, G, dev, dyn, (cudaStream_t)stream)
                   : sand_launch<false>(&a, G, dev, dyn,
                                        (cudaStream_t)stream));
}
