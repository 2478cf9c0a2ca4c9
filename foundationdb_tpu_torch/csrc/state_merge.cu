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
// One launch, one CTA per 512 outputs: warps 0 and 1 find the co-ranks of
// the CTA's first and last output (fdb_warp_corank over the state and the
// endpoints in global memory, eight limbs a load), the two slices go to
// shared memory,
// and each thread finds its outputs' co-ranks there (comparing from the
// first limb on which the slices vary) and writes
// skeys[:, p], scls[p], sval[p], sidx[p], cum_state[p] and spos[sidx[p]]
// (coalesced but for the endpoints' spos).
//
// Bound on H100: bytes. It reads L * (K + M) limbs, K values and M
// indices, and writes (L + 5) * N int32: 20 MB at N = 327,680 and L = 5
// (~6 us), 51 MB at cell B's N = 1,064,960 and L = 7 (~15 us).
#include "common.cuh"

#define SM_THREADS 256
#define SM_TILE 512

__global__ void __launch_bounds__(SM_THREADS)
state_merge_kernel(const int32_t* __restrict__ bkeys,
                   const int32_t* __restrict__ bval,
                   const int32_t* __restrict__ ekeys,
                   const int32_t* __restrict__ eids, int L, int K, int M,
                   int NR, int32_t* skeys, int32_t* scls, int32_t* sval,
                   int32_t* sidx, int32_t* spos, int32_t* cum_state) {
  extern __shared__ int32_t sh[];
  int32_t* sk = sh;                // L * SM_TILE: state slice, then endpoints
  int32_t* sid = sh + L * SM_TILE;  // the endpoint slice's indices
  __shared__ int s_corank[2];
  __shared__ unsigned int sh_mask;
  const int N = K + M;
  const int p0 = blockIdx.x * SM_TILE;
  const int p1 = min(p0 + SM_TILE, N);
  // state element i before endpoint k
  auto before = [&](int i, int k) -> bool {
    const int j = __ldcg(eids + k);  // with the keys, in one round trip
    const int c = fdb_key_cmp_wide<8, true>(bkeys + i, K, ekeys + k, M, L);
    return c < 0 || (c == 0 && fdb_endpoint_cls(j, NR) == 2);
  };
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int c = fdb_warp_corank(warp == 0 ? p0 : p1, K, M, before);
    if ((threadIdx.x & 31) == 0) s_corank[warp] = c;
  }
  __syncthreads();
  const int i0 = s_corank[0], i1 = s_corank[1];
  const int e0 = p0 - i0, e1 = p1 - i1;
  const int na = i1 - i0, nb = e1 - e0;
  for (int x = threadIdx.x; x < na; x += blockDim.x)
    for (int l = 0; l < L; ++l)
      sk[l * SM_TILE + x] = bkeys[(long long)l * K + i0 + x];
  for (int x = threadIdx.x; x < nb; x += blockDim.x) {
    sid[x] = eids[e0 + x];
    for (int l = 0; l < L; ++l)
      sk[l * SM_TILE + na + x] = ekeys[(long long)l * M + e0 + x];
  }
  // limbs before f are equal across both slices
  const int f = fdb_first_varying_limb(sk, SM_TILE, na + nb, L, &sh_mask);
  const int32_t* skf = sk + (long long)f * SM_TILE;
  auto local_before = [&](int i, int k) -> bool {
    const int c = fdb_key_cmp(skf + i, SM_TILE, skf + na + k, SM_TILE, L - f);
    return c < 0 || (c == 0 && fdb_endpoint_cls(sid[k], NR) == 2);
  };
  for (int q = threadIdx.x; q < na + nb; q += blockDim.x) {
    const int c = fdb_corank(q, na, nb, local_before);
    const bool is_state = c < na && (q - c >= nb || local_before(c, q - c));
    const int src = is_state ? c : na + q - c;
    const int p = p0 + q;
    for (int l = 0; l < L; ++l)
      skeys[(long long)l * N + p] = sk[l * SM_TILE + src];
    int idx;
    if (is_state) {
      idx = i0 + c;
      scls[p] = 1;
      sval[p] = bval[idx];
      cum_state[p] = idx + 1;
    } else {
      const int j = sid[q - c];
      idx = K + j;
      scls[p] = fdb_endpoint_cls(j, NR);
      sval[p] = FDB_NEG;
      cum_state[p] = i0 + c;
    }
    sidx[p] = idx;
    spos[idx] = p;
  }
}

static int g_merge_smem[64];  // dynamic shared memory granted, per device

// bkeys (L, K) sorted, bval (K); ekeys (L, M), eids (M) from K6 (M may be
// 0). Outputs: skeys (L, K + M) and five (K + M) int32 vectors. One launch
// on `stream`.
extern "C" int fdb_state_merge(const int32_t* bkeys, const int32_t* bval,
                               const int32_t* ekeys, const int32_t* eids,
                               int L, int K, int M, int NR, int32_t* skeys,
                               int32_t* scls, int32_t* sval, int32_t* sidx,
                               int32_t* spos, int32_t* cum_state,
                               void* stream) {
  const int N = K + M;
  const size_t smem = (size_t)(L + 1) * SM_TILE * sizeof(int32_t);
  int dev = 0;
  FdbDeviceLimits lim;
  cudaError_t e = fdb_device_limits(&dev, &lim);
  if (e == cudaSuccess)
    e = fdb_allow_smem(state_merge_kernel, dev, smem, g_merge_smem);
  if (e != cudaSuccess) return (int)e;
  state_merge_kernel<<<(N + SM_TILE - 1) / SM_TILE, SM_THREADS, smem,
                       (cudaStream_t)stream>>>(bkeys, bval, ekeys, eids, L, K,
                                               M, NR, skeys, scls, sval, sidx,
                                               spos, cum_state);
  return (int)cudaGetLastError();
}
