// K11 shard_combine: the proxy's combine of the W shards' verdicts.
//
// Replaces: foundationdb_tpu/parallel/sharded_conflict.py `local_step`'s
// collectives (:193-210), `lax.pmin` / `lax.pmax` over the resolver mesh
// axis and the committed count, in the jitted shard_map step. Per txn t:
//   statuses[t] = min over shards  (Conflict 0 < TooOld 1 < Committed 2,
//                                   ConflictSet.h:36-40; the proxy's rule)
//   eligible[t] = all over shards
// and per chunk: overflow = any, boundaries = max, converged = all, and
//   committed = #{t : statuses[t] == Committed and txn_valid[t]}.
//
// The readback row the engine copies to the host is written here too:
//   row = [statuses (T) | eligible (T) | overflow | converged], int32,
// the row K13 writes for one device (`_combine_fn`), so the sharded chunk
// needs no cast or concatenation after the combine.
//
// The shards' outputs are read where the step left them: the wrapper
// passes their W x 5 device pointers by value in the launch's parameters
// (no stack, no pointer table in device memory, no copy before the launch).
// On one card every shard's output is already there, and the sharded
// chunk replays as one CUDA graph (parallel/sharded_conflict.py), so the
// launch's host cost (the pointer table, the checks) is paid at capture.
// Shards on other cards are copied to this one first.
//
// Bound on H100: bytes, and in practice the launch. It reads 5 W T + T
// bytes and writes 9 T + 18 (T = 16,384, W = 4: 0.48 MB, 0.14 us at
// 3.35 TB/s); a launch costs several microseconds.
//
// Design. One launch a chunk: a thread per txn, grid-strided; each block
// counts its committed txns (warp sums, then one shared counter) and adds
// them to a global counter; the last block to finish (an atomic ticket)
// writes the count, the chunk's scalars and the row's last two words, and
// resets both counters, so the scratch is zero again for the next launch
// (as K2 and K8 do).
#include "common.cuh"

#define COMBINE_THREADS 256
#define COMBINE_MAX_SHARDS 64

struct ShardOutputs {
  const int32_t* statuses[COMBINE_MAX_SHARDS];
  const uint8_t* eligible[COMBINE_MAX_SHARDS];
  const uint8_t* overflow[COMBINE_MAX_SHARDS];
  const int32_t* boundaries[COMBINE_MAX_SHARDS];
  const uint8_t* converged[COMBINE_MAX_SHARDS];
};

__global__ void __launch_bounds__(COMBINE_THREADS)
shard_combine_kernel(const ShardOutputs in, int W, int T,
                     const uint8_t* __restrict__ txn_valid,
                     unsigned int* scratch, int32_t* __restrict__ row,
                     uint8_t* __restrict__ eligible,
                     int32_t* __restrict__ scalars,
                     uint8_t* __restrict__ flags) {
  __shared__ const int32_t* sh_st[COMBINE_MAX_SHARDS];
  __shared__ const uint8_t* sh_el[COMBINE_MAX_SHARDS];
  __shared__ unsigned int sh_count;
  for (int d = threadIdx.x; d < W; d += blockDim.x) {
    sh_st[d] = in.statuses[d];
    sh_el[d] = in.eligible[d];
  }
  if (threadIdx.x == 0) sh_count = 0u;
  __syncthreads();

  unsigned int mine = 0u;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < T;
       t += gridDim.x * blockDim.x) {
    int32_t s = sh_st[0][t];
    bool e = sh_el[0][t] != 0;
    for (int d = 1; d < W; ++d) {
      s = min(s, sh_st[d][t]);
      e = e && sh_el[d][t] != 0;
    }
    row[t] = s;
    row[T + t] = e;
    eligible[t] = e;
    mine += (s == 2 && txn_valid[t]) ? 1u : 0u;
  }
  mine = __reduce_add_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(&sh_count, mine);
  __syncthreads();

  if (threadIdx.x == 0) {
    if (sh_count) atomicAdd(&scratch[0], sh_count);
    __threadfence();
    if (atomicAdd(&scratch[1], 1u) == gridDim.x - 1) {  // the last block
      __threadfence();
      scalars[1] = (int32_t)atomicExch(&scratch[0], 0u);
      scratch[1] = 0u;
      bool ov = false, cv = true;
      int32_t b = INT_MIN;
      for (int d = 0; d < W; ++d) {
        ov = ov || *in.overflow[d] != 0;
        cv = cv && *in.converged[d] != 0;
        b = max(b, *in.boundaries[d]);
      }
      flags[0] = ov;
      flags[1] = cv;
      scalars[0] = b;
      row[2 * T] = ov;
      row[2 * T + 1] = cv;
    }
  }
}

// ptrs: a HOST array of 5 W device pointers, [statuses 0..W-1 | eligible |
// overflow | boundaries | converged]. scratch: 2 uint32, zero on entry and
// left zero. Outputs: row (2T + 2 int32), eligible (T bytes), scalars
// [boundaries, committed] (int32), flags [overflow, converged] (bytes).
// One launch on `stream`.
extern "C" int fdb_shard_combine(const void* const* ptrs, int W, int T,
                                 const uint8_t* txn_valid,
                                 unsigned int* scratch, int32_t* row,
                                 uint8_t* eligible, int32_t* scalars,
                                 uint8_t* flags, void* stream) {
  if (W < 1 || W > COMBINE_MAX_SHARDS || T < 1)
    return (int)cudaErrorInvalidValue;
  ShardOutputs in = {};
  for (int d = 0; d < W; ++d) {
    in.statuses[d] = (const int32_t*)ptrs[d];
    in.eligible[d] = (const uint8_t*)ptrs[W + d];
    in.overflow[d] = (const uint8_t*)ptrs[2 * W + d];
    in.boundaries[d] = (const int32_t*)ptrs[3 * W + d];
    in.converged[d] = (const uint8_t*)ptrs[4 * W + d];
  }
  int dev = 0;
  FdbDeviceLimits lim;
  const cudaError_t e = fdb_device_limits(&dev, &lim);
  if (e != cudaSuccess) return (int)e;
  long long blocks = ((long long)T + COMBINE_THREADS - 1) / COMBINE_THREADS;
  const long long cap = (long long)lim.sms * 8;
  if (blocks > cap) blocks = cap;
  shard_combine_kernel<<<(int)blocks, COMBINE_THREADS, 0,
                         (cudaStream_t)stream>>>(
      in, W, T, txn_valid, scratch, row, eligible, scalars, flags);
  return (int)cudaGetLastError();
}
