// K5 legacy_blocked: one evaluation of the legacy intra-batch map f, the
// "earlier transactions win" test over every (write, read) pair.
//
// Replaces: foundationdb_tpu/ops/conflict.py `_f_commit` of the legacy
// evaluator (:506-514), the int8 matrix-vector product of the committed
// writes with the dense (NW, NR) overlap matrix built at :493-504, which
// the unbounded `lax.while_loop` (:516-530) evaluates until the lower and
// upper bounds meet. XLA runs it outside any Pallas kernel; torch has no
// int8 matrix-vector product on CUDA for these shapes, so it is written
// here, and the matrix is never materialised:
//   blocked[j] = r_ok[j] & any_i(c[wtxn_c[i]] & w_ok[i] & wtxn[i] < rtxn[j]
//                                & wbr[i] < rer[j] & rbr[j] < wer[i])
//   out[t]     = g[t] & !any(blocked[j] for the reads j of txn t)
//
// Bound on H100: operations, NW * NR pair tests (2.7e8 at T = 16,384 with
// one read and one write a txn); the inputs are a few hundred KB. Design:
// a grid of (read chunk, write chunk) blocks, one thread per read, the
// block's 1,024 writes staged through shared memory 256 at a time (an
// inactive write is staged as txn T, which no read's txn exceeds); a block
// stops once all its reads are blocked, a blocked read marks its txn by
// atomic OR, and the last block folds the marks as K3 does. Splitting the
// writes gives 16 x 64 blocks at T = 16,384 where one block per 256 reads
// left half the SMs idle.
#include "common.cuh"

#define LEGACY_THREADS 256
#define LEGACY_WRITES_PER_BLOCK 1024

__global__ void __launch_bounds__(LEGACY_THREADS)
legacy_kernel(const uint8_t* __restrict__ c, const uint8_t* __restrict__ g,
              const int32_t* __restrict__ wtxn,
              const int32_t* __restrict__ rtxn,
              const uint8_t* __restrict__ w_ok,
              const uint8_t* __restrict__ r_ok,
              const int32_t* __restrict__ wbr, const int32_t* __restrict__ wer,
              const int32_t* __restrict__ rbr, const int32_t* __restrict__ rer,
              int T, int NW, int NR, int32_t* marks, unsigned int* counter,
              uint8_t* out) {
  __shared__ int s_txn[LEGACY_THREADS];
  __shared__ int s_b[LEGACY_THREADS];
  __shared__ int s_e[LEGACY_THREADS];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = j < NR && r_ok[j];
  int rt = 0, rb = 0, re = 0;
  if (live) {
    rt = rtxn[j];
    rb = rbr[j];
    re = rer[j];
  }
  bool blocked = false;
  const int w_end = min(NW, (int)(blockIdx.y + 1) * LEGACY_WRITES_PER_BLOCK);
  for (int base = blockIdx.y * LEGACY_WRITES_PER_BLOCK; base < w_end;
       base += LEGACY_THREADS) {
    const int i = base + threadIdx.x;
    int wt = T, wb = 0, we = 0;
    if (i < w_end && w_ok[i]) {
      const int t = wtxn[i];
      if (c[min(t, T - 1)]) {
        wt = t;
        wb = wbr[i];
        we = wer[i];
      }
    }
    s_txn[threadIdx.x] = wt;
    s_b[threadIdx.x] = wb;
    s_e[threadIdx.x] = we;
    __syncthreads();
    if (live && !blocked) {
      const int n = min(LEGACY_THREADS, w_end - base);
      for (int k = 0; k < n; ++k) {
        if (s_txn[k] < rt && s_b[k] < re && rb < s_e[k]) {
          blocked = true;
          break;
        }
      }
    }
    // also the barrier before the next chunk overwrites the staged writes
    if (__syncthreads_and(!live || blocked)) break;
  }
  if (blocked) atomicOr(&marks[rt], 1);
  fdb_fold_marks_last_block(g, marks, counter, out, T);
}

// marks: T int32 and counter: 1 uint32, both zero on entry; the kernel
// leaves them zero again.
extern "C" int fdb_legacy_blocked(
    const uint8_t* c, const uint8_t* g, const int32_t* wtxn,
    const int32_t* rtxn, const uint8_t* w_ok, const uint8_t* r_ok,
    const int32_t* wbr, const int32_t* wer, const int32_t* rbr,
    const int32_t* rer, int T, int NW, int NR, int32_t* marks,
    unsigned int* counter, uint8_t* out, void* stream) {
  const dim3 grid(NR > 0 ? (NR + LEGACY_THREADS - 1) / LEGACY_THREADS : 1,
                  NW > 0 ? (NW + LEGACY_WRITES_PER_BLOCK - 1) /
                               LEGACY_WRITES_PER_BLOCK
                         : 1);
  legacy_kernel<<<grid, LEGACY_THREADS, 0, (cudaStream_t)stream>>>(
      c, g, wtxn, rtxn, w_ok, r_ok, wbr, wer, rbr, rer, T, NW, NR, marks,
      counter, out);
  return (int)cudaGetLastError();
}
