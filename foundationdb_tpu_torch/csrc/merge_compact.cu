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
//   merge_prep  (N threads): group-start / group-end / live flags per
//               sorted element; committed writes scatter +1/-1 into a
//               zeroed delta array at their sorted positions.
//   merge_scan  (one block): a tiled scan over N with the prefix carried
//               across tiles, three block scans a tile (values, previous
//               kept value, slot count); writes the slot's value and its
//               source position, re-zeroes delta, and writes nb, oldest,
//               poisoned and the boundary count.
//   merge_fill  (K threads): gathers each slot's key limbs from the
//               sorted keys, pads the tail, or writes the poison state.
//
// Bound on H100: bytes. It reads the sorted keys (L * N int32), classes,
// indices, values and write positions, and writes L * K + K int32: ~3 MB
// at K = 65,536 (~1 us of HBM time); at K = 2^20, ~40 MB (~12 us). The one
// block of merge_scan runs at one SM's rate, not the card's: a later PR
// replaces it with a decoupled look-back scan across SMs.
#include "common.cuh"

#define PREP_THREADS 256
#define SCAN_THREADS 1024
#define SCAN_IPT 4

#define F_NEWGRP 1
#define F_GRPLAST 2
#define F_LIVE 4

__device__ __forceinline__ bool col_neq(const int32_t* keys, int L, long long n,
                                        long long i, long long j) {
  for (int l = 0; l < L; ++l)
    if (keys[l * n + i] != keys[l * n + j]) return true;
  return false;
}

__global__ void merge_prep_kernel(
    const int32_t* __restrict__ skeys, const int32_t* __restrict__ scls,
    const int32_t* __restrict__ sidx, const int32_t* __restrict__ spos,
    const uint8_t* __restrict__ merge_commit, const int32_t* __restrict__ wb,
    const int32_t* __restrict__ we, const int32_t* __restrict__ wtxn,
    const int32_t* __restrict__ nb, int L, int N, int K, int NR, int NW, int T,
    uint8_t* flags, int32_t* delta) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N) {
    uint8_t f = 0;
    if (i == 0 || col_neq(skeys, L, N, i, i - 1)) f |= F_NEWGRP;
    if (i == N - 1 || col_neq(skeys, L, N, i, i + 1)) f |= F_GRPLAST;
    if (scls[i] == 1 && sidx[i] < *nb) f |= F_LIVE;
    flags[i] = f;
  }
  if (i < NW) {
    const int t = wtxn[i];
    if (t < T && merge_commit[t] && fdb_key_lt(wb, we, L, NW, i)) {
      const long long off = (long long)K + 2LL * NR;
      delta[spos[off + i]] = 1;
      delta[spos[off + NW + i]] = -1;
    }
  }
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

__global__ void __launch_bounds__(SCAN_THREADS)
merge_scan_kernel(const uint8_t* __restrict__ flags, int32_t* delta,
                  const int32_t* __restrict__ sval,
                  const int32_t* __restrict__ oldest,
                  const uint8_t* __restrict__ poisoned,
                  const int32_t* __restrict__ vnew_p,
                  const uint8_t* __restrict__ advance_floor, int N, int K,
                  int max_write_life, int32_t* csrc, int32_t* out_vals,
                  int32_t* nb_out, int32_t* oldest_out, uint8_t* poisoned_out,
                  int32_t* boundaries_out) {
  __shared__ ValElem sh_val[32];
  __shared__ FdbLast sh_last[32];
  __shared__ FdbSum sh_sum[32];
  const int32_t vnew = *vnew_p;
  const int32_t old = *oldest;
  const int32_t floor_v = *advance_floor ? vnew - max_write_life : old;
  const int32_t new_oldest = max(old, floor_v);

  const ValOp vop;
  const FdbLastOp lop;
  const FdbSumOp sop;
  const ValElem vid = {0, FDB_NEG, 0, 0, 0};
  const FdbLast lid = {FDB_NEG, 0};
  const FdbSum sid = {0};
  ValElem vcarry = vid;
  FdbLast lcarry = lid;
  FdbSum scarry = sid;
  const int tile = SCAN_THREADS * SCAN_IPT;
  for (int base = 0; base < N; base += tile) {
    const int i0 = base + threadIdx.x * SCAN_IPT;
    ValElem e[SCAN_IPT];
    uint8_t grplast[SCAN_IPT];
    ValElem vagg = vid;
#pragma unroll
    for (int k = 0; k < SCAN_IPT; ++k) {
      const int i = i0 + k;
      e[k] = vid;
      grplast[k] = 0;
      if (i < N) {
        const uint8_t f = flags[i];
        const int d = delta[i];
        delta[i] = 0;  // leave the scratch zeroed for the next step
        const int live = (f & F_LIVE) ? 1 : 0;
        e[k] = {d, live ? sval[i] : FDB_NEG, live, (live || d != 0) ? 1 : 0,
                (f & F_NEWGRP) ? 1 : 0};
        grplast[k] = (f & F_GRPLAST) ? 1 : 0;
      }
      vagg = vop(vagg, e[k]);
    }
    ValElem vtotal;
    ValElem run = vop(vcarry,
                      fdb_block_exclusive_scan(vagg, vop, vid, sh_val, &vtotal));
    vcarry = vop(vcarry, vtotal);

    // per element: a slot event at each group end that holds a source
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
    FdbLast prev = lop(lcarry, fdb_block_exclusive_scan(lagg, lop, lid,
                                                        sh_last, &ltotal));
    lcarry = lop(lcarry, ltotal);

    uint8_t keep[SCAN_IPT];
    FdbSum sagg = sid;
#pragma unroll
    for (int k = 0; k < SCAN_IPT; ++k) {
      keep[k] = ev[k].has && (!prev.has || ev[k].v != prev.v);
      prev = lop(prev, ev[k]);
      sagg.v += keep[k];
    }
    FdbSum stotal;
    FdbSum slot = sop(scarry, fdb_block_exclusive_scan(sagg, sop, sid, sh_sum,
                                                       &stotal));
    scarry = sop(scarry, stotal);
#pragma unroll
    for (int k = 0; k < SCAN_IPT; ++k) {
      if (keep[k]) {
        if (slot.v < K) {
          csrc[slot.v] = i0 + k;
          out_vals[slot.v] = ev[k].v;
        }
        slot.v += 1;
      }
    }
  }
  if (threadIdx.x == 0) {
    const int n2 = scarry.v;
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

// delta: N int32, zero on entry and left zero. flags: N bytes and csrc: K
// int32 of scratch. The five outputs after out_vals are 0-dim tensors.
extern "C" int fdb_merge_compact(
    const int32_t* skeys, const int32_t* scls, const int32_t* sval,
    const int32_t* sidx, const int32_t* spos, const uint8_t* merge_commit,
    const int32_t* wb, const int32_t* we, const int32_t* wtxn,
    const int32_t* nb, const int32_t* oldest, const uint8_t* poisoned,
    const int32_t* vnew, const uint8_t* advance_floor, int L, int N, int K,
    int NR, int NW, int T, int max_write_life, uint8_t* flags, int32_t* delta,
    int32_t* csrc, int32_t* out_keys, int32_t* out_vals, int32_t* nb_out,
    int32_t* oldest_out, uint8_t* poisoned_out, int32_t* boundaries_out,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_prep = N > NW ? N : NW;
  merge_prep_kernel<<<(n_prep + PREP_THREADS - 1) / PREP_THREADS,
                      PREP_THREADS, 0, st>>>(skeys, scls, sidx, spos,
                                             merge_commit, wb, we, wtxn, nb, L,
                                             N, K, NR, NW, T, flags, delta);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(
      flags, delta, sval, oldest, poisoned, vnew, advance_floor, N, K,
      max_write_life, csrc, out_vals, nb_out, oldest_out, poisoned_out,
      boundaries_out);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_fill_kernel<<<(K + PREP_THREADS - 1) / PREP_THREADS, PREP_THREADS, 0,
                      st>>>(skeys, csrc, poisoned_out, boundaries_out, vnew, L,
                            N, K, out_keys, out_vals);
  return (int)cudaGetLastError();
}
