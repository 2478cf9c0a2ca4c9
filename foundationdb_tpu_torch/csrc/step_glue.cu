// K13 step_verdicts: the conflict step's closing glue, one launch.
//
// Replaces: in foundationdb_tpu/ops/conflict.py `conflict_step`, part of
// the jitted XLA step, the statuses (:545-553), info["committed"] (:697),
// the int8 statuses, committed and overflow rows of `conflict_scan`
// (:782-786), and the resolver's readback row, `_combine_fn`
// (:1190-1198): [statuses | eligible | overflow | converged], in place
// of a string of small torch launches a step. (The step's other glue,
// the range->txn maps and the intra-batch masks, rides in K2's launch:
// csrc/history_check.cu.)
//
// Bound on H100: the launch. K13 reads 4 and writes 9 bytes a txn
// (0.2 MB at T = 16,384, 0.07 us of HBM time). A launch costs a few
// microseconds, so it is one launch and nothing more: one thread-block
// cluster.
//
// K13: one thread-block cluster, launched with cudaLaunchKernelEx, of as
// many CTAs of VERDICT_THREADS as T needs at VERDICT_TXNS txns a thread,
// up to VERDICT_CLUSTER (16, non-portable): one CTA up to T = 2,048, 8 at
// 16,384, 16 at 32,768 (the loads and stores want many SMs; 8 CTAs of
// 256 threads measured slower at 32,768). Each thread takes 16
// consecutive txns: one 16-byte load of each of commit, too_old,
// txn_valid and eligible, the statuses computed a byte at a time within
// 32-bit words, then for each group of 4 a 16-byte store to each half of
// the int32 row and a 4-byte store to the int8 scan row (an array not
// aligned for that takes byte and word accesses instead; the host says
// which). A scalar tail takes the last T mod 16 txns. The committed count
// is summed in each CTA (warp sums, then shared memory), each CTA writes
// its sum into rank 0's shared memory (distributed shared memory; the
// cluster barrier that lets it is arrived at before the loads and waited
// on only then), one cluster barrier, and rank 0 writes the count: no
// scratch, ticket or fence. A cluster of one CTA skips the barriers.
// Past T = 32,768 one cluster, confined to one GPC, would move the bytes
// at one GPC's share of the memory rate (0.043 ms at T = 2^20 on the
// H100 against 0.006 for a grid over every SM; PERF.md): there the
// launch is a grid of clusters (step_verdicts_kernel<true>) of
// VERDICT_GRID_CLUSTER CTAs of VERDICT_GRID_THREADS, cluster 0 reading
// commit alone and summing it as above, the other clusters writing the
// rows, each thread 4 groups of 4 txns a stride apart (4-byte loads), so
// that a warp's stores are contiguous; the count still needs no scratch.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define VERDICT_THREADS 128  // a CTA's threads, one cluster
#define VERDICT_GRID_THREADS 512  // a CTA's threads, a grid of clusters
#define VERDICT_GROUPS 4  // groups of 4 txns a thread a pass
#define VERDICT_TXNS (4 * VERDICT_GROUPS)  // txns a thread a pass
#define VERDICT_COUNT_LOADS 32  // 4-byte loads in flight, counting alone
#define VERDICT_CLUSTER 16  // CTAs of one cluster, at most (non-portable)
#define VERDICT_GRID_CLUSTER 8  // CTAs of a cluster of a grid (portable)

// which arrays are 16-byte aligned (the bits) and 4-byte aligned (the
// bits << 8): one cluster loads 16 flags at a time, a grid 4, and a group
// of 4 statuses is one 16-byte store to the int32 row, 4 bytes to the scan
#define V_COMMIT 1
#define V_TOO_OLD 2
#define V_VALID 4
#define V_ELIGIBLE 8
#define V_ROW 16  // the row's statuses
#define V_ROW_ELIGIBLE 32  // the row's eligible half
#define V_SCAN 64  // the scan's int8 row

// 16 bytes from p: one load where it is aligned, else byte loads.
__device__ __forceinline__ uint4 load16(const uint8_t* p, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)p[4 * i] | (uint32_t)p[4 * i + 1] << 8 |
           (uint32_t)p[4 * i + 2] << 16 | (uint32_t)p[4 * i + 3] << 24;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The 4 bytes at p: one load where it is aligned, else byte loads.
__device__ __forceinline__ uint32_t load4(const uint8_t* p, bool vec) {
  if (vec) return *reinterpret_cast<const uint32_t*>(p);
  return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
         (uint32_t)p[3] << 24;
}

// The 4 bytes of `w` as 4 int32 at p (4-byte aligned).
__device__ __forceinline__ void store4_i32(int32_t* p, uint32_t w, bool vec) {
  const int4 q = make_int4(w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF,
                           w >> 24);
  if (vec) {
    *reinterpret_cast<int4*>(p) = q;
  } else {
    p[0] = q.x;
    p[1] = q.y;
    p[2] = q.z;
    p[3] = q.w;
  }
}

// Committed 2, TooOld 1, Conflict 0; a txn that is not valid reads
// Committed. A byte of each word a txn, each 0 or 1.
__device__ __forceinline__ uint32_t status_bytes(uint32_t c, uint32_t o,
                                                 uint32_t v) {
  const uint32_t m = (v ^ 0x01010101u) | c;  // 1: reads Committed
  return (m << 1) | (o & ~m);
}

// Txns [t, t + 4): commit, too_old, txn_valid and eligible a byte each in
// c, o, v and e. Writes their statuses and eligible flags to the row and
// the scan row; returns how many committed.
__device__ __forceinline__ unsigned int verdict_group(
    int t, int T, uint32_t c, uint32_t o, uint32_t v, uint32_t e, int vec,
    int32_t* __restrict__ row, int8_t* __restrict__ scan_statuses) {
  const uint32_t st = status_bytes(c, o, v);
  store4_i32(row + t, st, vec & V_ROW);
  store4_i32(row + T + t, e, vec & V_ROW_ELIGIBLE);
  if (scan_statuses) {
    if (vec & (V_SCAN << 8)) {
      *reinterpret_cast<uint32_t*>(scan_statuses + t) = st;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        scan_statuses[t + i] = (int8_t)((st >> (8 * i)) & 0xFF);
    }
  }
  return __popc(c);
}

// GRID: a grid of clusters (past one cluster's T), each CTA of
// VERDICT_GRID_THREADS; else one cluster of CTAs of VERDICT_THREADS.
template <bool GRID>
__global__ void __launch_bounds__(GRID ? VERDICT_GRID_THREADS
                                       : VERDICT_THREADS)
step_verdicts_kernel(const uint8_t* __restrict__ commit,
                     const uint8_t* __restrict__ too_old,
                     const uint8_t* __restrict__ txn_valid,
                     const uint8_t* __restrict__ eligible,
                     const uint8_t* __restrict__ overflow,
                     const uint8_t* __restrict__ converged, int T,
                     int vec, int32_t* __restrict__ row,
                     int32_t* __restrict__ committed,
                     int8_t* __restrict__ scan_statuses,
                     int32_t* __restrict__ scan_committed,
                     uint8_t* __restrict__ scan_overflow) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int ctas = cluster.num_blocks();
  const unsigned int rank = cluster.block_rank();
  __shared__ unsigned int sh_warp[VERDICT_GRID_THREADS / 32];
  __shared__ unsigned int sh_sums[VERDICT_CLUSTER];  // rank 0's: each CTA's
  // one cluster writes the rows and counts; in a grid of clusters cluster
  // 0 counts and the others write the rows
  const bool alone = !GRID;
  const bool counts = !GRID || blockIdx.x < ctas;
  // every CTA of the cluster must have started before one writes another's
  // shared memory: arrive now, wait just before that write
  if (counts && ctas > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const bool lead = counts && rank == 0 && threadIdx.x == 0;
  uint8_t ov = 0, cv = 0;
  if (lead) {  // loaded now, used at the end
    ov = *overflow != 0;
    cv = *converged != 0;
  }
  const int groups = T / 4;  // whole groups of 4 txns
  unsigned int mine = 0u;
  if (!alone && counts) {  // cluster 0 of a grid: commit alone
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    const int stride = (int)(ctas * blockDim.x);
    for (int q0 = tid; q0 < groups; q0 += VERDICT_COUNT_LOADS * stride) {
      uint32_t c[VERDICT_COUNT_LOADS];
#pragma unroll
      for (int u = 0; u < VERDICT_COUNT_LOADS; ++u) {
        const int q = q0 + u * stride;
        c[u] = q < groups ? load4(commit + 4 * q, (vec >> 8) & V_COMMIT)
                          : 0u;
      }
#pragma unroll
      for (int u = 0; u < VERDICT_COUNT_LOADS; ++u) mine += __popc(c[u]);
    }
    for (int t = 4 * groups + tid; t < T; t += stride) mine += commit[t] != 0;
  }
  const int first = alone ? 0 : ctas;  // the first CTA that writes rows
  const int tid =
      ((int)blockIdx.x - first) * (int)blockDim.x + (int)threadIdx.x;
  const int stride = ((int)gridDim.x - first) * (int)blockDim.x;
  int done = 0;  // txns the passes take; the tail the rest
  if (alone) {  // 16 consecutive txns a thread, 16-byte loads
    done = T / VERDICT_TXNS * VERDICT_TXNS;
    for (int t = VERDICT_TXNS * tid; t < done; t += VERDICT_TXNS * stride) {
      const uint4 c = load16(commit + t, vec & V_COMMIT);
      const uint4 o = load16(too_old + t, vec & V_TOO_OLD);
      const uint4 v = load16(txn_valid + t, vec & V_VALID);
      const uint4 e = load16(eligible + t, vec & V_ELIGIBLE);
      mine += verdict_group(t, T, c.x, o.x, v.x, e.x, vec, row, scan_statuses);
      mine += verdict_group(t + 4, T, c.y, o.y, v.y, e.y, vec, row,
                            scan_statuses);
      mine += verdict_group(t + 8, T, c.z, o.z, v.z, e.z, vec, row,
                            scan_statuses);
      mine += verdict_group(t + 12, T, c.w, o.w, v.w, e.w, vec, row,
                            scan_statuses);
    }
  } else if (!counts) {
    // VERDICT_GROUPS groups of 4 txns a thread a pass, a stride apart, so
    // that a warp's loads and stores are contiguous
    done = groups * 4;
    const int v4 = vec >> 8;
    for (int q0 = tid; q0 < groups; q0 += VERDICT_GROUPS * stride) {
      uint32_t c[VERDICT_GROUPS], o[VERDICT_GROUPS], v[VERDICT_GROUPS],
          e[VERDICT_GROUPS];
#pragma unroll
      for (int u = 0; u < VERDICT_GROUPS; ++u) {
        const int t = 4 * (q0 + u * stride);
        const bool in = t < done;
        c[u] = in ? load4(commit + t, v4 & V_COMMIT) : 0u;
        o[u] = in ? load4(too_old + t, v4 & V_TOO_OLD) : 0u;
        v[u] = in ? load4(txn_valid + t, v4 & V_VALID) : 0u;
        e[u] = in ? load4(eligible + t, v4 & V_ELIGIBLE) : 0u;
      }
#pragma unroll
      for (int u = 0; u < VERDICT_GROUPS; ++u) {
        const int t = 4 * (q0 + u * stride);
        if (t < done)
          mine += verdict_group(t, T, c[u], o[u], v[u], e[u], vec, row,
                                scan_statuses);
      }
    }
  }
  // the tail
  for (int t = done + tid; (alone || !counts) && t < T; t += stride) {
    const bool c = commit[t] != 0;
    const int32_t s = (!txn_valid[t] || c) ? 2 : (too_old[t] ? 1 : 0);
    row[t] = s;
    row[T + t] = eligible[t] != 0;
    if (scan_statuses) scan_statuses[t] = (int8_t)s;
    mine += c ? 1u : 0u;
  }
  if (!counts) return;
  mine = __reduce_add_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0) sh_warp[threadIdx.x >> 5] = mine;
  __syncthreads();
  unsigned int sum = 0u;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) sum += sh_warp[w];
  if (ctas > 1) {
    // each CTA's sum into rank 0's shared memory, then one barrier; no
    // CTA's own shared memory is read by another, so all may leave after
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    if (threadIdx.x == 0) *cluster.map_shared_rank(&sh_sums[rank], 0) = sum;
    cluster.sync();
  } else if (threadIdx.x == 0) {
    sh_sums[0] = sum;
  }
  if (lead) {
    unsigned int count = 0u;
    for (unsigned int r = 0; r < ctas; ++r) count += sh_sums[r];
    *committed = (int32_t)count;
    if (scan_committed) *scan_committed = (int32_t)count;
    row[2 * T] = ov;
    row[2 * T + 1] = cv;
    if (scan_overflow) *scan_overflow = ov;
  }
}

// The scan outputs may be null (a lone step); given, they are row i of the
// (M, T) int8 statuses and entry i of the (M,) committed and overflow.
// One launch on `stream`: one cluster, or a grid of clusters past
// T = 32,768.
extern "C" int fdb_step_verdicts(const uint8_t* commit, const uint8_t* too_old,
                                 const uint8_t* txn_valid,
                                 const uint8_t* eligible,
                                 const uint8_t* overflow,
                                 const uint8_t* converged, int T, int32_t* row,
                                 int32_t* committed, int8_t* scan_statuses,
                                 int32_t* scan_committed,
                                 uint8_t* scan_overflow, void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* p, uintptr_t n) {
    return ((uintptr_t)p & (n - 1)) == 0;
  };
  int vec = 0;
  for (int a = 0; a < 2; ++a) {  // 16-byte alignment, then 4-byte << 8
    const uintptr_t n = a ? 4 : 16;
    vec |= ((aligned(commit, n) ? V_COMMIT : 0) |
            (aligned(too_old, n) ? V_TOO_OLD : 0) |
            (aligned(txn_valid, n) ? V_VALID : 0) |
            (aligned(eligible, n) ? V_ELIGIBLE : 0) |
            (aligned(row, n) ? V_ROW : 0) |
            (aligned(row + T, n) ? V_ROW_ELIGIBLE : 0) |
            (aligned(scan_statuses, n) ? V_SCAN : 0))
           << (8 * a);
  }
  // one cluster of CTAs of VERDICT_THREADS up to its width; past it a
  // grid of clusters, one counting and the rest writing the rows
  const long long want = (T + VERDICT_TXNS - 1) / VERDICT_TXNS;  // threads
  long long ctas = (want + VERDICT_THREADS - 1) / VERDICT_THREADS;
  long long threads = VERDICT_THREADS, clusters = 1;
  const bool grid = ctas > VERDICT_CLUSTER;
  cudaError_t e = cudaSuccess;
  if (grid) {
    int dev = 0;
    FdbDeviceLimits lim;
    e = fdb_device_limits(&dev, &lim);
    if (e != cudaSuccess) return (int)e;
    ctas = VERDICT_GRID_CLUSTER;
    threads = VERDICT_GRID_THREADS;
    const long long rows = (want + ctas * threads - 1) / (ctas * threads);
    clusters = 1 + (rows < lim.sms ? rows : lim.sms);
  } else if (ctas > 8) {  // past the portable cluster width
    e = cudaFuncSetAttribute(step_verdicts_kernel<false>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)(ctas * clusters));
  cfg.blockDim = dim3((unsigned int)threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned int)ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg,
                         grid ? step_verdicts_kernel<true>
                              : step_verdicts_kernel<false>,
                         commit, too_old, txn_valid, eligible, overflow,
                         converged, T, vec, row, committed, scan_statuses,
                         scan_committed, scan_overflow);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
