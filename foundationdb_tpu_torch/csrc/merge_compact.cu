// K4 merge_compact: merge the committed writes into the step function at
// the commit version, clamp to the new MVCC floor, coalesce, and compact
// to K slots; overflow poisons the state (sticky), never truncates it.
//
// Replaces: foundationdb_tpu/ops/conflict.py `_merge_phase` (:589-704),
// the tail of the jitted XLA step, with `_carry_last_flagged` (:215-224).
// The sorted union [state | rb | re | wb | we] comes from the step's sort.
// A key group is a run of equal sorted keys. Per group that holds a source
// (a live state boundary or a committed write endpoint), the JAX step
// keeps one slot, whose value is
//   val   = value of the last live state boundary at-or-before the group
//   cover = coverage count (prefix sum of +1/-1 write deltas) at group end
//   new   = max(cover > 0 ? max(val, vnew) : val, new_oldest)
// and drops it when `new` equals the previous slot's value (coalesce).
// Live state boundaries sort before equal write endpoints, so `val` and
// `cover` are both known at the group's LAST element: one forward pass
// decides every slot, with no backward carry.
//
// Three launches:
//   merge_prep  (max(NW, 3 * tiles + 1) threads): committed writes scatter
//               +1/-1 into a zeroed delta array at their sorted positions;
//               the scan's tile descriptors and ticket are reset.
//   merge_scan  (one CTA per tile of 2,048 elements, all SMs): a
//               single-pass scan with decoupled look-back (Merrill and
//               Garland, "Single-pass Parallel Prefix Scan with Decoupled
//               Look-back", 2016). A CTA takes its tile from an atomic
//               ticket, so every earlier tile has started and the look-back
//               cannot deadlock. It derives the group-start, group-end and
//               live flags from the sorted keys itself, then runs three
//               chained monoids in order, each with its own look-back:
//                 1. ValOp: coverage sum, last live value, "a source since
//                    the group start";
//                 2. FdbLast: the previous kept slot value, over the slot
//                    events that the resolved ValOp prefix defines;
//                 3. the slot count.
//               Each tile publishes (aggregate, inclusive prefix, status)
//               per monoid and starts the next look-back once the previous
//               prefix is known. It writes each kept slot's value and
//               source position (below K only) and re-zeroes delta; the
//               last tile writes nb, oldest, poisoned and the boundary
//               count.
//   merge_fill  (K threads): gathers each slot's key limbs from the
//               sorted keys, pads the tail, or writes the poison state.
//
// Bound on H100: bytes. It reads the sorted keys (L * N int32), classes,
// indices, values and write positions, and writes L * K + K int32: ~6 MB
// at the kernel bench's N = 327,680 (~1.8 us of HBM time), ~19 MB at
// N = 1,064,960 (~5.6 us). A scan on one CTA walks N at one SM's rate
// (0.5 ms and 1.5 ms at those sizes on the H100); the look-back scan
// spreads the N elements over N / 2,048 CTAs in one pass over memory.
#include "common.cuh"

#define PREP_THREADS 256
#define SCAN_THREADS 256
#define SCAN_IPT 8
#define SCAN_TILE (SCAN_THREADS * SCAN_IPT)

// tile descriptor: 24 int32 per tile. Words 0-2: the status of monoid
// 0-2 (common.cuh's look-back); then each monoid's aggregate and
// inclusive prefix.
#define DESC_WORDS 24
#define VAL_AGG 4
#define VAL_INCL 8
#define LAST_AGG 12
#define LAST_INCL 14
#define SUM_AGG 16
#define SUM_INCL 17

__global__ void merge_prep_kernel(
    const int32_t* __restrict__ spos, const uint8_t* __restrict__ merge_commit,
    const int32_t* __restrict__ wb, const int32_t* __restrict__ we,
    const int32_t* __restrict__ wtxn, int L, int K, int NR, int NW, int T,
    int n_tiles, int32_t* delta, int32_t* desc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < NW) {
    const int t = wtxn[i];
    if (t < T && merge_commit[t] && fdb_key_lt(wb, we, L, NW, i)) {
      const long long off = (long long)K + 2LL * NR;
      delta[spos[off + i]] = 1;
      delta[spos[off + NW + i]] = -1;
    }
  }
  if (i < 3LL * n_tiles) desc[(i / 3) * DESC_WORDS + i % 3] = 0;
  if (i == 0) desc[(long long)n_tiles * DESC_WORDS] = 0;  // the ticket
}

// Values pass: coverage sum, latest live value, "a source since the group
// start" (reset at group starts).
struct ValElem {
  int sum;
  int val;
  int has;
  int any;
  int rst;
  static __device__ __forceinline__ ValElem shfl_up(ValElem x, int d) {
    return {fdb_shfl_up(x.sum, d), fdb_shfl_up(x.val, d),
            fdb_shfl_up(x.has, d), fdb_shfl_up(x.any, d),
            fdb_shfl_up(x.rst, d)};
  }
};
struct ValOp {
  __device__ __forceinline__ ValElem operator()(ValElem a, ValElem b) const {
    return {a.sum + b.sum, b.has ? b.val : a.val, a.has | b.has,
            b.rst ? b.any : (a.any | b.any), a.rst | b.rst};
  }
};

// descriptor words of the values pass (volatile: other CTAs' writes)
__device__ __forceinline__ void desc_put(volatile int32_t* w, ValElem x) {
  w[0] = x.sum;
  w[1] = x.val;
  w[2] = x.has | (x.any << 1) | (x.rst << 2);
}
__device__ __forceinline__ void desc_get(const volatile int32_t* w,
                                         ValElem* x) {
  const int bits = w[2];
  *x = {w[0], w[1], bits & 1, (bits >> 1) & 1, (bits >> 2) & 1};
}

__global__ void __launch_bounds__(SCAN_THREADS)
merge_scan_kernel(const int32_t* __restrict__ skeys,
                  const int32_t* __restrict__ scls,
                  const int32_t* __restrict__ sval,
                  const int32_t* __restrict__ sidx,
                  const int32_t* __restrict__ nb, int32_t* delta,
                  const int32_t* __restrict__ oldest,
                  const uint8_t* __restrict__ poisoned,
                  const int32_t* __restrict__ vnew_p,
                  const uint8_t* __restrict__ advance_floor, int L, int N,
                  int K, int max_write_life, int n_tiles, int32_t* desc,
                  int32_t* csrc, int32_t* out_vals, int32_t* nb_out,
                  int32_t* oldest_out, uint8_t* poisoned_out,
                  int32_t* boundaries_out) {
  __shared__ ValElem sh_val[32];
  __shared__ FdbLast sh_last[32];
  __shared__ FdbSum sh_sum[32];
  __shared__ int sh_tile, sh_first;
  if (threadIdx.x == 0)
    sh_tile = (int)atomicAdd(
        reinterpret_cast<unsigned int*>(desc + (long long)n_tiles * DESC_WORDS),
        1u);
  __syncthreads();
  const int tile = sh_tile;
  const int32_t vnew = *vnew_p;
  const int32_t old = *oldest;
  const int32_t floor_v = *advance_floor ? vnew - max_write_life : old;
  const int32_t new_oldest = max(old, floor_v);
  const int32_t live_nb = *nb;

  const ValOp vop;
  const FdbLastOp lop;
  const FdbSumOp sop;
  const ValElem vid = {0, FDB_NEG, 0, 0, 0};
  const FdbLast lid = {FDB_NEG, 0};
  const FdbSum sid = {0};
  const long long i0 =
      (long long)tile * SCAN_TILE + (long long)threadIdx.x * SCAN_IPT;

  // group flags from the sorted keys: same[k] <=> element i0 + k - 1
  // equals element i0 + k
  bool same[SCAN_IPT + 1];
#pragma unroll
  for (int k = 0; k <= SCAN_IPT; ++k) same[k] = true;
  for (int l = 0; l < L; ++l) {
    const int32_t* row = skeys + (long long)l * N;
    int32_t x[SCAN_IPT + 2];
#pragma unroll
    for (int k = 0; k < SCAN_IPT + 2; ++k) {
      const long long idx = i0 - 1 + k;
      x[k] = (idx >= 0 && idx < N) ? __ldg(&row[idx]) : 0;
    }
#pragma unroll
    for (int k = 0; k <= SCAN_IPT; ++k) same[k] = same[k] && x[k] == x[k + 1];
  }

  // 1. values: coverage sum, last live value, a source since group start
  ValElem e[SCAN_IPT];
  bool grplast[SCAN_IPT];
  ValElem vagg = vid;
#pragma unroll
  for (int k = 0; k < SCAN_IPT; ++k) {
    const long long i = i0 + k;
    e[k] = vid;
    grplast[k] = false;
    if (i < N) {
      const int d = delta[i];
      if (d != 0) delta[i] = 0;  // leave the scratch zeroed for the next step
      const int live = (scls[i] == 1 && sidx[i] < live_nb) ? 1 : 0;
      e[k] = {d, live ? sval[i] : FDB_NEG, live, (live || d != 0) ? 1 : 0,
              (i == 0 || !same[k]) ? 1 : 0};
      grplast[k] = i == N - 1 || !same[k + 1];
    }
    vagg = vop(vagg, e[k]);
  }
  ValElem vtotal;
  const ValElem vx =
      fdb_block_exclusive_scan(vagg, vop, vid, sh_val, &vtotal);
  ValElem run = vop(fdb_tile_prefix(desc, DESC_WORDS, tile, 0, VAL_AGG,
                                    VAL_INCL, vtotal, vop, vid, sh_val,
                                    &sh_first),
                    vx);

  // 2. per element: a slot event at each group end that holds a source
  FdbLast ev[SCAN_IPT];
  FdbLast lagg = lid;
#pragma unroll
  for (int k = 0; k < SCAN_IPT; ++k) {
    run = vop(run, e[k]);
    int32_t nv = run.sum > 0 ? max(run.val, vnew) : run.val;
    nv = max(nv, new_oldest);
    ev[k] = {nv, (grplast[k] && run.any) ? 1 : 0};
    lagg = lop(lagg, ev[k]);
  }
  FdbLast ltotal;
  const FdbLast lx = fdb_block_exclusive_scan(lagg, lop, lid, sh_last,
                                              &ltotal);
  FdbLast prev = lop(fdb_tile_prefix(desc, DESC_WORDS, tile, 1, LAST_AGG,
                                     LAST_INCL, ltotal, lop, lid, sh_last,
                                     &sh_first),
                     lx);

  // 3. kept slots (a new value) and their count
  bool keep[SCAN_IPT];
  FdbSum sagg = sid;
#pragma unroll
  for (int k = 0; k < SCAN_IPT; ++k) {
    keep[k] = ev[k].has && (!prev.has || ev[k].v != prev.v);
    prev = lop(prev, ev[k]);
    sagg.v += keep[k];
  }
  FdbSum stotal;
  const FdbSum sx = fdb_block_exclusive_scan(sagg, sop, sid, sh_sum, &stotal);
  const FdbSum scarry =
      fdb_tile_prefix(desc, DESC_WORDS, tile, 2, SUM_AGG, SUM_INCL, stotal,
                      sop, sid, sh_sum, &sh_first);
  int slot = scarry.v + sx.v;
#pragma unroll
  for (int k = 0; k < SCAN_IPT; ++k) {
    if (keep[k]) {
      if (slot < K) {
        csrc[slot] = (int32_t)(i0 + k);
        out_vals[slot] = ev[k].v;
      }
      slot += 1;
    }
  }
  if (tile == n_tiles - 1 && threadIdx.x == 0) {
    const int n2 = scarry.v + stotal.v;
    const bool pois = *poisoned || n2 > K;
    const int n = pois ? 1 : n2;
    *nb_out = min(n, K);
    *boundaries_out = n;
    *oldest_out = new_oldest;
    *poisoned_out = pois;
  }
}

__global__ void merge_fill_kernel(const int32_t* __restrict__ skeys,
                                  const int32_t* __restrict__ csrc,
                                  const uint8_t* __restrict__ poisoned_out,
                                  const int32_t* __restrict__ boundaries_out,
                                  const int32_t* __restrict__ vnew_p, int L,
                                  int N, int K, int32_t* out_keys,
                                  int32_t* out_vals) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= K) return;
  if (*poisoned_out) {
    // the whole keyspace collapses to one segment at vnew
    for (int l = 0; l < L; ++l)
      out_keys[l * (long long)K + s] = s == 0 ? FDB_EMPTY_LIMB : FDB_PAD_LIMB;
    out_vals[s] = s == 0 ? *vnew_p : FDB_NEG;
  } else if (s < *boundaries_out) {
    const long long src = csrc[s];
    for (int l = 0; l < L; ++l)
      out_keys[l * (long long)K + s] = skeys[l * (long long)N + src];
  } else {
    for (int l = 0; l < L; ++l) out_keys[l * (long long)K + s] = FDB_PAD_LIMB;
    out_vals[s] = FDB_NEG;
  }
}

// delta: N int32, zero on entry and left zero. desc: 24 * ceil(N / 2,048)
// + 1 int32 of scratch (tile descriptors and the ticket, reset by
// merge_prep); csrc: K int32 of scratch. The five outputs after out_vals
// are 0-dim tensors. Three launches on `stream`.
extern "C" int fdb_merge_compact(
    const int32_t* skeys, const int32_t* scls, const int32_t* sval,
    const int32_t* sidx, const int32_t* spos, const uint8_t* merge_commit,
    const int32_t* wb, const int32_t* we, const int32_t* wtxn,
    const int32_t* nb, const int32_t* oldest, const uint8_t* poisoned,
    const int32_t* vnew, const uint8_t* advance_floor, int L, int N, int K,
    int NR, int NW, int T, int max_write_life, int32_t* desc, int32_t* delta,
    int32_t* csrc, int32_t* out_keys, int32_t* out_vals, int32_t* nb_out,
    int32_t* oldest_out, uint8_t* poisoned_out, int32_t* boundaries_out,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (N + SCAN_TILE - 1) / SCAN_TILE;
  const int n_prep = NW > 3 * n_tiles + 1 ? NW : 3 * n_tiles + 1;
  merge_prep_kernel<<<(n_prep + PREP_THREADS - 1) / PREP_THREADS,
                      PREP_THREADS, 0, st>>>(spos, merge_commit, wb, we, wtxn,
                                             L, K, NR, NW, T, n_tiles, delta,
                                             desc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_scan_kernel<<<n_tiles, SCAN_THREADS, 0, st>>>(
      skeys, scls, sval, sidx, nb, delta, oldest, poisoned, vnew,
      advance_floor, L, N, K, max_write_life, n_tiles, desc, csrc, out_vals,
      nb_out, oldest_out, poisoned_out, boundaries_out);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_fill_kernel<<<(K + PREP_THREADS - 1) / PREP_THREADS, PREP_THREADS, 0,
                      st>>>(skeys, csrc, poisoned_out, boundaries_out, vnew, L,
                            N, K, out_keys, out_vals);
  return (int)cudaGetLastError();
}
