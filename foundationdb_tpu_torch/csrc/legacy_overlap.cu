// K5 legacy_blocked: the legacy intra-batch evaluator's whole fixpoint,
// or one evaluation of its map f, in one cooperative launch.
//
// Replaces: foundationdb_tpu/ops/conflict.py's legacy evaluator
// (:491-533): `_f_commit` (:506-514), the int8 matrix-vector product of
// the committed writes with the dense (NW, NR) overlap matrix built at
// :493-504, and the unbounded `lax.while_loop` (:516-530) that evaluates
// it until the lower and upper bounds meet. The matrix is never
// materialised:
//   blocked_c[j] = r_ok[j] & any_i(c[wtxn[i]] & w_ok[i] & wtxn[i] < rtxn[j]
//                                  & wbr[i] < rer[j] & rbr[j] < wer[i])
//   f(c)[t]      = g[t] & !any(blocked_c[j] for the reads j of txn t)
// and the fixpoint (conflict_ref.run_legacy): upper = g, lower = f(upper),
// then body (upper = f(lower), lower = f(upper)) until lower == upper.
//
// Bound on H100: operations, the (write, read) pairs with wtxn < rtxn
// that each evaluation tests (1.3e8 at T = 16,384 with one read and one
// write a txn, a few integer operations each); the inputs are a few
// hundred KB. The previous design launched one grid an evaluation (one
// thread a read, every write streamed through shared memory, three loads
// a pair) and read the fixpoint's test on the host once a body.
//
// Design. One persistent cooperative grid runs every evaluation as a pass,
// with a grid barrier (fdb_grid_sync) between passes:
// - Work is cut into tiles of 512 reads by 256 writes. A prologue takes
//   each read chunk's largest live owner and each write chunk's smallest
//   owner; a tile whose writes all belong at or after its reads' txns can
//   block nothing and is skipped in every pass (for the pooled and strided
//   layouts, whose owners ascend, about half the tiles). This holds for
//   any order of owners. A CTA takes its tiles from a ticket a pass (an
//   atomic counter), so the tiles that are not skipped spread evenly; up
//   to 8 CTAs an SM, measured against 4 with tiles of 512 writes (1.04x
//   at T = 16,384, 1.5x a pass on a 1,000-txn chain) and 8 with 512
//   writes or 8 reads a thread (both slower than 4).
// - A tile stages only the writes that are active in this pass (w_ok,
//   their txn committed in the pass's input, their txn below the chunk's
//   largest read owner), compacted, each packed as one 16-byte record
//   (txn, begin rank, end rank). A thread holds 4 reads in registers, so
//   one broadcast shared load tests 4 pairs; four loads are in flight at
//   once (the ticket queue and this cut a pass by 1.36x on the H100). A
//   read whose txn is already marked in this pass, not eligible (g), or at
//   or below the chunk's smallest write owner is dead from the start; a
//   warp stops its tile once all its reads are blocked or dead (a warp
//   vote every 32 writes).
// - A blocked read marks its txn in a T-bit set (atomicOr). The committed
//   set of pass p is g & !marks_p, so pass p + 1 reads its input straight
//   from those bits: there is no fold between passes. Four bit sets
//   rotate: pass p writes set p % 4, reads set (p - 1) % 4 and zeroes set
//   (p + 1) % 4, which no CTA reads any more (its last reader, the test
//   after pass p - 2, ended before the barrier that closed pass p - 1).
// - The test of a body (after each even pass from 2 on) is the count of
//   txns whose marks differ between the pass's input and output; every
//   CTA counts it itself from the two bit sets (T / 32 words, from L2), so
//   every CTA takes the same branch with no further barrier.
// - The loop always ends (the map is monotone: after k evaluations the
//   first k txns are exact). It is guarded at max_bodies bodies (the
//   wrapper's default T / 2 + 2, which a correct kernel never reaches):
//   past that the kernel writes converged = 0 and stops. The step's
//   readback row carries the flag, and the engine raises internal_error
//   on it: the legacy evaluator has no host pass.
// - Last, a grid-strided pass writes out[t] = g[t] & !marks[t], then a
//   barrier, then every bit set and ticket is zeroed for the next launch.
//   The tickets rotate with the bit sets (pass p zeroes ticket p + 1).
#include "common.cuh"

#define LG_THREADS 128
#define LG_RPT 4  // reads a thread holds
#define LG_RCHUNK (LG_THREADS * LG_RPT)
#define LG_WCHUNK 256
#define LG_CTAS_PER_SM 8
#define LG_BITSETS 4

struct LegacyArgs {
  const uint8_t* c;  // pass 0's committed set (the fixpoint's is g)
  const uint8_t* g;
  const int32_t* wtxn;
  const int32_t* rtxn;
  const uint8_t* w_ok;
  const uint8_t* r_ok;
  const int32_t* wbr;
  const int32_t* wer;
  const int32_t* rbr;
  const int32_t* rer;
  int T, NW, NR;
  int fixpoint;  // 0: one evaluation of f on c; 1: the whole fixpoint
  int max_bodies;  // the fixpoint's guard
  int words;     // ceil(T / 32)
  int n_rc, n_wc;
  unsigned int* marks;  // LG_BITSETS * words, zero on entry and on exit
  unsigned int* queue;  // LG_BITSETS tile tickets (after the marks), alike
  int32_t* bounds;      // n_rc + n_wc
  unsigned int* sync;
  uint8_t* out;
  uint8_t* converged;
  int32_t* evals;  // or null
};

__device__ __forceinline__ bool lg_bit(const unsigned int* m, int t) {
  return (__ldcg(&m[t >> 5]) >> (t & 31)) & 1u;
}

// Block-wide max (MAX) or min of one int a thread; every thread gets it.
template <bool MAX>
__device__ __forceinline__ int lg_block_reduce(int v, int* sh) {
  if (threadIdx.x == 0) *sh = MAX ? INT_MIN : INT_MAX;
  __syncthreads();
  v = MAX ? __reduce_max_sync(0xffffffffu, v) : __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) {
    if (MAX)
      atomicMax(sh, v);
    else
      atomicMin(sh, v);
  }
  __syncthreads();
  const int r = *sh;
  __syncthreads();
  return r;
}

// One tile of pass p: the writes of chunk `wc` against the reads of chunk
// `rc`, marking in `mp` the txns of the reads they block.
__device__ __forceinline__ void lg_tile(const LegacyArgs& a, int rc, int wc,
                                        int rmax, int wmin, int p,
                                        const unsigned int* mprev,
                                        unsigned int* mp, int4* s_w,
                                        int* s_n) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) *s_n = 0;
  __syncthreads();
  // stage the writes that can block a read here, compacted (their order
  // does not matter: any one overlap blocks)
  const int i0 = wc * LG_WCHUNK;
  const int i1 = min(a.NW, i0 + LG_WCHUNK);
  for (int i = i0 + (int)threadIdx.x; i < i0 + LG_WCHUNK; i += LG_THREADS) {
    bool act = false;
    int t = 0;
    if (i < i1 && a.w_ok[i]) {
      t = a.wtxn[i];
      if ((unsigned)t < (unsigned)a.T && t < rmax)
        act = p == 0 ? a.c[t] != 0 : (a.g[t] && !lg_bit(mprev, t));
    }
    const unsigned int m = __ballot_sync(0xffffffffu, act);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(s_n, __popc(m));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (act)
      s_w[base + __popc(m & ((1u << lane) - 1u))] =
          make_int4(t, a.wbr[i], a.wer[i], 0);
  }
  __syncthreads();
  const int n = *s_n;
  int rt[LG_RPT], rb[LG_RPT], re[LG_RPT];
  bool blk[LG_RPT];
#pragma unroll
  for (int k = 0; k < LG_RPT; ++k) {
    const int j = rc * LG_RCHUNK + k * LG_THREADS + (int)threadIdx.x;
    rt[k] = INT_MIN;  // dead: no write's txn is below it
    rb[k] = re[k] = 0;
    blk[k] = false;
    if (n > 0 && j < a.NR && a.r_ok[j]) {
      const int t = a.rtxn[j];
      if ((unsigned)t < (unsigned)a.T && t > wmin && a.g[t] &&
          !lg_bit(mp, t)) {
        rt[k] = t;
        rb[k] = a.rbr[j];
        re[k] = a.rer[j];
      }
    }
  }
  for (int q0 = 0; q0 < n; q0 += 32) {
    bool done = true;
#pragma unroll
    for (int k = 0; k < LG_RPT; ++k) done = done && (blk[k] || rt[k] == INT_MIN);
    if (__all_sync(0xffffffffu, done)) break;
    const int q1 = min(n, q0 + 32);
    int q = q0;
    for (; q + 4 <= q1; q += 4) {  // four shared loads in flight
      int4 w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = s_w[q + u];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int k = 0; k < LG_RPT; ++k)
          blk[k] = blk[k] |
                   ((w[u].x < rt[k]) & (w[u].y < re[k]) & (rb[k] < w[u].z));
    }
    for (; q < q1; ++q) {
      const int4 w = s_w[q];
#pragma unroll
      for (int k = 0; k < LG_RPT; ++k)
        blk[k] = blk[k] | ((w.x < rt[k]) & (w.y < re[k]) & (rb[k] < w.z));
    }
  }
#pragma unroll
  for (int k = 0; k < LG_RPT; ++k)
    if (blk[k]) atomicOr(&mp[rt[k] >> 5], 1u << (rt[k] & 31));
  __syncthreads();  // s_w and s_n are the next tile's
}

__global__ void __launch_bounds__(LG_THREADS) legacy_kernel(const LegacyArgs a) {
  __shared__ int4 s_w[LG_WCHUNK];
  __shared__ int s_n;
  __shared__ int s_red;
  __shared__ int s_u;
  const int tid = threadIdx.x;
  const long long gtid = (long long)blockIdx.x * LG_THREADS + tid;
  const long long gstride = (long long)gridDim.x * LG_THREADS;

  // prologue: each read chunk's largest live owner, each write chunk's
  // smallest owner of a write that may ever be active
  for (int k = blockIdx.x; k < a.n_rc + a.n_wc; k += gridDim.x) {
    int v;
    if (k < a.n_rc) {
      v = INT_MIN;
      for (int j = k * LG_RCHUNK + tid; j < min(a.NR, (k + 1) * LG_RCHUNK);
           j += LG_THREADS) {
        const int t = a.r_ok[j] ? a.rtxn[j] : -1;
        if ((unsigned)t < (unsigned)a.T && a.g[t]) v = max(v, t);
      }
      v = lg_block_reduce<true>(v, &s_red);
    } else {
      const int w = k - a.n_rc;
      v = INT_MAX;
      for (int i = w * LG_WCHUNK + tid; i < min(a.NW, (w + 1) * LG_WCHUNK);
           i += LG_THREADS) {
        const int t = a.w_ok[i] ? a.wtxn[i] : -1;
        if ((unsigned)t < (unsigned)a.T && (a.g[t] || a.c[t])) v = min(v, t);
      }
      v = lg_block_reduce<false>(v, &s_red);
    }
    if (tid == 0) a.bounds[k] = v;
  }
  fdb_grid_sync(a.sync);

  const int n_tiles = a.n_rc * a.n_wc;
  bool converged = true;
  int p = 0;
  for (;; ++p) {
    unsigned int* mp = a.marks + (long long)(p % LG_BITSETS) * a.words;
    const unsigned int* mprev =
        a.marks + (long long)((p + LG_BITSETS - 1) % LG_BITSETS) * a.words;
    if (p > 0) {
      unsigned int* mz =
          a.marks + (long long)((p + 1) % LG_BITSETS) * a.words;
      for (long long w = gtid; w < a.words; w += gstride) mz[w] = 0u;
      if (gtid == 0) a.queue[(p + 1) % LG_BITSETS] = 0u;
    }
    // tiles from a ticket a pass, so that the CTAs share the tiles that
    // are not skipped evenly
    for (;;) {
      if (tid == 0) s_u = (int)atomicAdd(&a.queue[p % LG_BITSETS], 1u);
      __syncthreads();
      const int u = s_u;
      __syncthreads();
      if (u >= n_tiles) break;
      const int rc = u / a.n_wc, wc = u - rc * a.n_wc;
      const int rmax = __ldcg(&a.bounds[rc]);
      const int wmin = __ldcg(&a.bounds[a.n_rc + wc]);
      if (wmin >= rmax) continue;  // no write of the chunk precedes a read
      lg_tile(a, rc, wc, rmax, wmin, p, mprev, mp, s_w, &s_n);
    }
    fdb_grid_sync(a.sync);
    if (!a.fixpoint) break;
    if (p >= 2 && (p & 1) == 0) {
      // the body's test: txns whose marks differ between its two passes
      // (marks lie within g, so the committed sets differ exactly there)
      int cnt = 0;
      for (int w = tid; w < a.words; w += LG_THREADS)
        cnt += __popc(__ldcg(&mp[w]) ^ __ldcg(&mprev[w]));
      if (tid == 0) s_red = 0;
      __syncthreads();
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      if ((tid & 31) == 0 && cnt) atomicAdd(&s_red, cnt);
      __syncthreads();
      const int differ = s_red;
      __syncthreads();
      if (differ == 0) break;
      if (p / 2 >= a.max_bodies) {
        converged = false;
        break;
      }
    }
  }

  const unsigned int* mf =
      a.marks + (long long)(p % LG_BITSETS) * a.words;
  for (long long t = gtid; t < a.T; t += gstride)
    a.out[t] = a.g[t] && !lg_bit(mf, (int)t);
  if (blockIdx.x == 0 && tid == 0) {
    *a.converged = converged;
    if (a.evals) *a.evals = p + 1;
  }
  fdb_grid_sync(a.sync);
  for (long long w = gtid; w < (long long)LG_BITSETS * (a.words + 1);
       w += gstride)
    a.marks[w] = 0u;  // the bit sets, then the tickets
}

// Co-resident CTAs an SM of each device, read once.
static int g_legacy_per_sm[64];

// marks: 4 * (ceil(T / 32) + 1) uint32 (the bit sets, then the tile
// tickets), zero on entry and left zero; bounds:
// ceil(NR / 512) + ceil(NW / 256) int32 of overwritten scratch; sync: 1
// uint32 whose low 31 bits are zero on entry, and stay so. fixpoint 0:
// out = f(c), one evaluation; 1: out = the fixpoint from g (c is g),
// stopped unconverged after max_bodies bodies (at least 1).
// converged: 1 byte; evals (or null): the evaluations that ran. One
// cooperative launch on `stream`.
extern "C" int fdb_legacy_overlap(
    const uint8_t* c, const uint8_t* g, const int32_t* wtxn,
    const int32_t* rtxn, const uint8_t* w_ok, const uint8_t* r_ok,
    const int32_t* wbr, const int32_t* wer, const int32_t* rbr,
    const int32_t* rer, int T, int NW, int NR, int fixpoint, int max_bodies,
    unsigned int* marks, int32_t* bounds, unsigned int* sync, uint8_t* out,
    uint8_t* converged, int32_t* evals, void* stream) {
  if (T < 1 || NW < 0 || NR < 0 || max_bodies < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  FdbDeviceLimits lim;
  cudaError_t e = fdb_device_limits(&dev, &lim);
  if (e != cudaSuccess) return (int)e;
  if (g_legacy_per_sm[dev] == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &g_legacy_per_sm[dev], legacy_kernel, LG_THREADS, 0);
    if (e != cudaSuccess) {
      g_legacy_per_sm[dev] = 0;
      return (int)e;
    }
    if (g_legacy_per_sm[dev] < 1)
      return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  LegacyArgs a;
  a.c = c;
  a.g = g;
  a.wtxn = wtxn;
  a.rtxn = rtxn;
  a.w_ok = w_ok;
  a.r_ok = r_ok;
  a.wbr = wbr;
  a.wer = wer;
  a.rbr = rbr;
  a.rer = rer;
  a.T = T;
  a.NW = NW;
  a.NR = NR;
  a.fixpoint = fixpoint ? 1 : 0;
  a.max_bodies = max_bodies;
  a.words = (T + 31) / 32;
  a.n_rc = (NR + LG_RCHUNK - 1) / LG_RCHUNK;
  a.n_wc = (NW + LG_WCHUNK - 1) / LG_WCHUNK;
  a.marks = marks;
  a.queue = marks + (long long)LG_BITSETS * a.words;
  a.bounds = bounds;
  a.sync = sync;
  a.out = out;
  a.converged = converged;
  a.evals = evals;
  // a CTA a tile, at most LG_CTAS_PER_SM an SM; the other passes stride
  const int per_sm = min(g_legacy_per_sm[dev], LG_CTAS_PER_SM);
  long long want = (long long)a.n_rc * a.n_wc;
  if (want < 1) want = 1;
  const long long cap = (long long)lim.sms * per_sm;
  const int G = (int)(want < cap ? want : cap);
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)legacy_kernel, dim3(G),
                                  dim3(LG_THREADS), params, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
