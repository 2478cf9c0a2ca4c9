// K8 endpoint_ranks: the dense rank of each batch endpoint's key among
// all 2NR + 2NW endpoint keys, written at its endpoint index.
//
// Replaces: the endpoint ranks of foundationdb_tpu/ops/conflict.py
// `conflict_step` (:455-476): group starts over the sorted union, an
// exclusive count of batch elements, and two carried `cummax` scans over
// all N = K + 2NR + 2NW sorted elements. A state element "interleaves but
// contributes no rank", and the class does not enter the rank, so the rank
// of an endpoint is the number of key changes up to it in the sorted
// endpoints alone (K6's output): one inclusive sum over M = 2NR + 2NW
// flags, minus one.
//
// One launch: a single-pass scan with decoupled look-back across all SMs
// (common.cuh, as K4's merge scan): ticketed tiles of 2,048 elements, each
// deriving its key-change flags from the sorted limbs in its own load. The
// last CTA to finish re-zeroes the descriptors, the ticket and its done
// counter, so the scratch is zero on entry and on exit.
//
// Bound on H100: bytes. It reads (L + 1) * M int32 and writes M int32:
// 1.6 MB at M = 65,536 and L = 5 (~0.5 us).
#include "common.cuh"

#define RANK_THREADS 256
#define RANK_IPT 8
#define RANK_TILE (RANK_THREADS * RANK_IPT)
// tile descriptor: status, aggregate, inclusive prefix, pad
#define RANK_DESC_WORDS 4

__global__ void __launch_bounds__(RANK_THREADS)
endpoint_ranks_kernel(const int32_t* __restrict__ keys,
                      const int32_t* __restrict__ ids, int L, int M,
                      int n_tiles, int32_t* desc, int32_t* qranks) {
  __shared__ FdbSum sh_sum[32];
  __shared__ int sh_tile, sh_first;
  __shared__ bool am_last;
  unsigned int* ticket = reinterpret_cast<unsigned int*>(
      desc + (long long)n_tiles * RANK_DESC_WORDS);
  if (threadIdx.x == 0) sh_tile = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int tile = sh_tile;
  const long long i0 =
      (long long)tile * RANK_TILE + (long long)threadIdx.x * RANK_IPT;

  // same[k] <=> element i0 + k - 1 has the key of element i0 + k
  bool same[RANK_IPT];
#pragma unroll
  for (int k = 0; k < RANK_IPT; ++k) same[k] = true;
  for (int l = 0; l < L; ++l) {
    const int32_t* row = keys + (long long)l * M;
    int32_t x[RANK_IPT + 1];
#pragma unroll
    for (int k = 0; k <= RANK_IPT; ++k) {
      const long long idx = i0 - 1 + k;
      x[k] = (idx >= 0 && idx < M) ? __ldg(&row[idx]) : 0;
    }
#pragma unroll
    for (int k = 0; k < RANK_IPT; ++k) same[k] = same[k] && x[k] == x[k + 1];
  }
  FdbSum agg = {0};
#pragma unroll
  for (int k = 0; k < RANK_IPT; ++k)
    agg.v += (i0 + k < M && (i0 + k == 0 || !same[k])) ? 1 : 0;
  const FdbSumOp op;
  const FdbSum id = {0};
  FdbSum total;
  const FdbSum excl = fdb_block_exclusive_scan(agg, op, id, sh_sum, &total);
  const FdbSum carry = fdb_tile_prefix(desc, RANK_DESC_WORDS, tile, 0, 1, 2,
                                       total, op, id, sh_sum, &sh_first);
  int rank = carry.v + excl.v - 1;
#pragma unroll
  for (int k = 0; k < RANK_IPT; ++k) {
    const long long i = i0 + k;
    if (i < M) {
      rank += (i == 0 || !same[k]) ? 1 : 0;
      qranks[ids[i]] = rank;
    }
  }

  // the last CTA out leaves the descriptors, ticket and counter zero
  __threadfence();
  __syncthreads();
  unsigned int* done = ticket + 1;
  if (threadIdx.x == 0) am_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!am_last) return;
  __threadfence();
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x)
    desc[(long long)t * RANK_DESC_WORDS] = 0;
  if (threadIdx.x == 0) {
    *ticket = 0;
    *done = 0;
  }
}

// keys (L, M) and ids (M) are K6's sorted endpoints; qranks (M) the output.
// desc: 4 * ceil(M / 2,048) + 2 int32, zero on entry and left zero. One
// launch on `stream`.
extern "C" int fdb_endpoint_ranks(const int32_t* keys, const int32_t* ids,
                                  int L, int M, int32_t* desc,
                                  int32_t* qranks, void* stream) {
  const int n_tiles = (M + RANK_TILE - 1) / RANK_TILE;
  endpoint_ranks_kernel<<<n_tiles, RANK_THREADS, 0, (cudaStream_t)stream>>>(
      keys, ids, L, M, n_tiles, desc, qranks);
  return (int)cudaGetLastError();
}
