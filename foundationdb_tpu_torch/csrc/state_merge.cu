// K7 state_merge: the sorted batch endpoints (K6) merged into the K sorted
// state boundaries, giving the step's sorted union and everything the
// later phases read from it, with no scan and no second pass.
//
// Replaces: the second half of foundationdb_tpu/ops/conflict.py
// `conflict_step` phase 0 (:397-421): the sorted keys, classes, values
// and indices of the `lax.sort` of [state | rb | re | wb | we], the
// inverse-permutation scatter `spos`, and the `cum_state` cumsum.
//
// The merge order is the step's total order: keys, then class
// re(0) < state(1) < rb/wb/we(2); state indices 0..K-1 come before every
// endpoint index, and classes never tie between state and endpoints. For
// output position p the merge-path co-rank i (state elements among the
// first p) says everything: p holds state element i or endpoint p - i, and
// cum_state[p] = i (+ 1 if p holds state element i).
//
// One launch, a CTA a tile of 256 * RUN outputs (RUN 8, 4 or 2: the
// longest that still gives the card two tiles an SM; fewer, longer tiles
// pay fewer co-rank searches, more, shorter ones spread a small merge):
//  1. the two halves of the block find the co-ranks of the tile's first
//     and last output in global memory, SM_PROBES evenly spaced
//     candidates a round each (a probe loads scattered words, so few
//     probes, and rounds that narrow to neighbours, keep this traffic a
//     small share of the tile's bytes);
//  2. both slices go to shared memory by cp.async (every load in flight
//     at once, where a load-then-store loop waits a round trip a limb),
//     one pad word every 32 so that threads a run apart hit 32 banks;
//  3. each thread finds the co-rank of its run of RUN outputs by
//     bisection there and merges the run with two fingers, one comparison
//     an output, comparing from the first limb on which the slices'
//     extremes differ and staging each output's source in shared memory;
//     a tile with no endpoint (most of a state's padding tail) skips this
//     and is a shifted copy of the state slice;
//  4. every output row is written coalesced (all but the endpoints' spos,
//     a scatter), a run's loads from shared memory before its stores.
// Every key comparison loads all the limbs of a batch whatever the
// earlier ones hold and reduces them by selects (fdb_key_cmp_wide): compiled
// with a branch a limb, each limb was a dependent round trip, up to four
// to DRAM a co-rank probe for keys whose first limbs agree.
//
// Bound on H100: bytes. It reads L * (K + M) limbs, K values and M
// indices, and writes (L + 5) * N int32: 20 MB at N = 327,680 and L = 5
// (~6 us), 51 MB at cell B's N = 1,064,960 and L = 7 (~15 us). The
// co-rank rounds are latency the tiles overlap; a small N (cell A: 2 us
// of bytes) is bound by them.
#include "common.cuh"

#define SM_THREADS 256
#define SM_PROBES 32  // co-rank candidates probed a round, a search
#define SM_GLIMBS 4   // limbs a global co-rank comparison loads at a time
#define SM_MLIMBS 2   // and one in shared memory, past the common prefix
#define SM_MAX_RUN 8  // outputs a thread; a tile is SM_THREADS times it
#define SM_MAX_LIMBS 17  // the widest key: 64 bytes (ConflictShapes.limbs)

// Shared-memory slot of slice element i: one pad word every 32, so that
// threads a run apart (run 1, 2, 4 or 8) hit 32 different banks.
__device__ __forceinline__ int sm_at(int i) { return i + (i >> 5); }

extern __shared__ int32_t sm_sh[];

__device__ __forceinline__ void sm_cp4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void sm_cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The co-ranks (fdb_corank's definition) of outputs q[0] and q[1], each
// half of the block searching for one. Each round a half's first
// SM_PROBES threads probe evenly spaced candidates of its interval; the
// predicate is true on a prefix of them, so their count (one barrier)
// narrows the interval to one gap of the probes; late rounds probe
// neighbours (coalesced). Called by every thread; every thread gets both
// answers in out[].
template <typename Before>
__device__ __forceinline__ void sm_coranks(const int* q, int nA, int nB,
                                           Before before, int* out) {
  constexpr int S = 2;
  const int per = blockDim.x / S;
  const int g = threadIdx.x / per;
  const int m = threadIdx.x - g * per;
  int lo[S], hi[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    lo[s] = max(0, q[s] - nB);
    hi[s] = min(q[s], nA);
  }
  for (;;) {
    bool open = false;
#pragma unroll
    for (int s = 0; s < S; ++s) open |= lo[s] < hi[s];
    if (!open) break;  // the same in every thread
    int step[S];
#pragma unroll
    for (int s = 0; s < S; ++s)
      step[s] = (hi[s] - lo[s] + SM_PROBES - 1) / SM_PROBES;
    // this thread's search, picked by selects (no local-memory array)
    int lo_g = lo[0], hi_g = hi[0], step_g = step[0], q_g = q[0];
#pragma unroll
    for (int s = 1; s < S; ++s)
      if (g == s) {
        lo_g = lo[s];
        hi_g = hi[s];
        step_g = step[s];
        q_g = q[s];
      }
    const int x = lo_g + m * step_g;
    const bool p = m < SM_PROBES && x < hi_g && before(x, q_g - x - 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int c = __syncthreads_count(p && g == s);
      if (c == 0) {
        hi[s] = lo[s];
      } else {
        const int next = lo[s] + c * step[s];  // the first probe false
        lo[s] += (c - 1) * step[s] + 1;
        hi[s] = min(hi[s], next);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) out[s] = lo[s];
}

template <int RUN>
__global__ void __launch_bounds__(SM_THREADS)
state_merge_kernel(const int32_t* __restrict__ bkeys,
                   const int32_t* __restrict__ bval,
                   const int32_t* __restrict__ ekeys,
                   const int32_t* __restrict__ eids, int L, int K, int M,
                   int NR, int32_t* skeys, int32_t* scls, int32_t* sval,
                   int32_t* sidx, int32_t* spos, int32_t* cum_state) {
  const int tile_n = SM_THREADS * RUN;  // outputs a full tile
  const int stride = sm_at(tile_n);     // a padded row
  // sm_sh: L rows of keys (the state slice, then the endpoints), a row of
  // state values then endpoint ids, and a row of `ord` (the slice element
  // output q holds)
  const int SV = L * stride, ORD = SV + stride;
  int32_t* sk = sm_sh;
  int32_t* sv = sm_sh + SV;
  int32_t* ord = sm_sh + ORD;
  __shared__ int sh_f;
  const int N = K + M;
  const int p0 = blockIdx.x * tile_n;
  const int p1 = min(p0 + tile_n, N);
  const int n = p1 - p0;

  // 1. the tile's co-ranks, in global memory
  auto before = [&](int i, int k) -> bool {
    // the class with the keys, in one round trip (no short circuit)
    const bool late = fdb_endpoint_cls(eids[k], NR) == 2;
    const int c = fdb_key_cmp_wide<SM_GLIMBS>(bkeys + i, K, ekeys + k, M, L);
    return (c < 0) | ((c == 0) & late);
  };
  const int q[2] = {p0, p1};
  int c[2];
  sm_coranks(q, K, M, before, c);
  const int i0 = c[0], i1 = c[1];
  const int e0 = p0 - i0;
  const int na = i1 - i0, nb = n - na;

  // 2. both slices to shared memory, every load in flight at once (the
  // loops stride by blockDim.x: with the constant the compiler unrolled
  // them, and the kernel ran slower at the bench's and cell B's shapes)
  for (int l = 0; l < L; ++l) {
    for (int x = threadIdx.x; x < na; x += blockDim.x)
      sm_cp4(sk + l * stride + sm_at(x), bkeys + (long long)l * K + i0 + x);
    for (int x = threadIdx.x; x < nb; x += blockDim.x)
      sm_cp4(sk + l * stride + sm_at(na + x),
             ekeys + (long long)l * M + e0 + x);
  }
  for (int x = threadIdx.x; x < na; x += blockDim.x)
    sm_cp4(sv + sm_at(x), bval + i0 + x);
  for (int x = threadIdx.x; x < nb; x += blockDim.x)
    sm_cp4(sv + sm_at(na + x), eids + e0 + x);
  sm_cp_wait();
  __syncthreads();

  // 3. each thread merges its run of outputs with two fingers (a tile
  // with no endpoint is the state slice in order)
  if (nb > 0) {
    // every key of the tile shares the limbs before f, the first on which
    // the slices' extremes differ (each slice is sorted), so comparisons
    // among them start there
    if (threadIdx.x == 0) {
      const int ends[4] = {0, max(na - 1, 0), na, na + nb - 1};
      int f = 0;
      for (; f < L; ++f) {
        const int32_t v = sk[f * stride];
        bool same = true;
        for (int e = 0; e < 4; ++e)
          if ((e >= 2 || na > 0) && sk[f * stride + sm_at(ends[e])] != v)
            same = false;
        if (!same) break;
      }
      sh_f = f;
    }
    __syncthreads();
    const int f = sh_f;
    const int fo = f * stride;
    auto local_before = [&](int i, int k) -> bool {
      const bool late = fdb_endpoint_cls(sv[sm_at(na + k)], NR) == 2;
      const int c = fdb_key_cmp_wide<SM_MLIMBS>(sk + fo + sm_at(i), stride,
                                                sk + fo + sm_at(na + k),
                                                stride, L - f);
      return (c < 0) | ((c == 0) & late);
    };
    const int q0 = threadIdx.x * RUN;
    if (q0 < n) {
      int i = fdb_corank(q0, na, nb, local_before);
      int k = q0 - i;
      const int q1 = min(q0 + RUN, n);
      for (int q = q0; q < q1; ++q) {
        // both fingers compared in range, then the side chosen
        const bool b = local_before(min(i, max(na - 1, 0)), min(k, nb - 1));
        const bool st = k >= nb || (i < na && b);
        ord[sm_at(q)] = st ? i : na + k;
        if (st)
          ++i;
        else
          ++k;
      }
    }
    __syncthreads();
  }

  // 4. every output row written coalesced (all but the endpoints' spos),
  // the run's sources first, so that its loads and stores overlap
  int src[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int q = j * SM_THREADS + threadIdx.x;
    src[j] = q < n ? (nb > 0 ? ord[sm_at(q)] : q) : -1;
  }
  for (int l = 0; l < L; ++l) {
    int32_t* row = skeys + (long long)l * N + p0 + threadIdx.x;
    int32_t v[RUN];
#pragma unroll
    for (int j = 0; j < RUN; ++j)
      v[j] = sk[l * stride + sm_at(max(src[j], 0))];
#pragma unroll
    for (int j = 0; j < RUN; ++j)
      if (src[j] >= 0) row[j * SM_THREADS] = v[j];
  }
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int sj = max(src[j], 0);
    const int v = sv[sm_at(sj)];  // a state value or an endpoint id
    const bool state = sj < na;
    const int q = j * SM_THREADS + threadIdx.x;
    const int p = p0 + q;
    const int idx = state ? i0 + sj : K + v;
    if (src[j] >= 0) {
      scls[p] = state ? 1 : fdb_endpoint_cls(v, NR);
      sval[p] = state ? v : FDB_NEG;
      sidx[p] = idx;
      spos[idx] = p;
      cum_state[p] = state ? idx + 1 : i0 + q - (sj - na);
    }
  }
}

static int g_merge_smem[3][64];  // dynamic shared memory granted, by RUN

static constexpr size_t sm_smem_bytes(int L, int run) {
  // L + 2 padded rows (sm_at) of a tile
  return ((size_t)SM_THREADS * run + (size_t)SM_THREADS * run / 32) *
         (L + 2) * sizeof(int32_t);
}
// the widest key at the longest run fits the 227 KiB a block may opt in to
static_assert(sm_smem_bytes(SM_MAX_LIMBS, SM_MAX_RUN) <= 227 * 1024,
              "a tile's slices exceed the shared memory of a block");

template <int RUN>
static cudaError_t sm_launch(int dev, const int32_t* bkeys,
                             const int32_t* bval, const int32_t* ekeys,
                             const int32_t* eids, int L, int K, int M,
                             int NR, int32_t* skeys, int32_t* scls,
                             int32_t* sval, int32_t* sidx, int32_t* spos,
                             int32_t* cum_state, cudaStream_t stream) {
  const size_t smem = sm_smem_bytes(L, RUN);
  constexpr int slot = RUN == 8 ? 2 : RUN == 4 ? 1 : 0;
  cudaError_t e = fdb_allow_smem(state_merge_kernel<RUN>, dev, smem,
                                 g_merge_smem[slot]);
  if (e != cudaSuccess) return e;
  const long long n_tiles =
      ((long long)K + M + SM_THREADS * RUN - 1) / (SM_THREADS * RUN);
  state_merge_kernel<RUN><<<(unsigned int)n_tiles, SM_THREADS, smem,
                            stream>>>(bkeys, bval, ekeys, eids, L, K, M, NR,
                                      skeys, scls, sval, sidx, spos,
                                      cum_state);
  return cudaGetLastError();
}

// bkeys (L, K) sorted, bval (K); ekeys (L, M), eids (M) from K6 (M may be
// 0), L <= SM_MAX_LIMBS. Outputs: skeys (L, K + M) and five (K + M) int32
// vectors. A tile is 256 threads times a run of 8, 4 or 2 outputs, the
// longest that still gives two tiles an SM. One launch on `stream`.
extern "C" int fdb_state_merge(const int32_t* bkeys, const int32_t* bval,
                               const int32_t* ekeys, const int32_t* eids,
                               int L, int K, int M, int NR, int32_t* skeys,
                               int32_t* scls, int32_t* sval, int32_t* sidx,
                               int32_t* spos, int32_t* cum_state,
                               void* stream) {
  if (L < 1 || L > SM_MAX_LIMBS) return (int)cudaErrorInvalidValue;
  const long long N = (long long)K + M;
  int dev = 0;
  FdbDeviceLimits lim;
  cudaError_t e = fdb_device_limits(&dev, &lim);
  if (e != cudaSuccess) return (int)e;
  int run = SM_MAX_RUN;
  while (run > 2 && (N + SM_THREADS * run - 1) / (SM_THREADS * run) <
                        2LL * lim.sms)
    run >>= 1;
  const cudaStream_t st = (cudaStream_t)stream;
#define SM_LAUNCH(U)                                                   \
  sm_launch<U>(dev, bkeys, bval, ekeys, eids, L, K, M, NR, skeys, scls, \
               sval, sidx, spos, cum_state, st)
  switch (run) {
    case 8:
      e = SM_LAUNCH(8);
      break;
    case 4:
      e = SM_LAUNCH(4);
      break;
    default:
      e = SM_LAUNCH(2);
  }
#undef SM_LAUNCH
  return (int)e;
}
