// K2 masks_and_history: the step's range->txn maps and intra-batch masks
// (once a launch of their own, K12 step_masks) and the too-old and
// history verdicts per transaction, in one launch.
//
// Replaces: foundationdb_tpu/ops/conflict.py `conflict_step`, part of the
// jitted XLA step: the strided owners and the masks of the intra-batch
// phase (:385-395, :477-489) and phases 1-2 (:423-444) with `_range_max`
// (:163-169).
//   masks, per read r and write w: the owner (strided: j // (N / T), or T
//     where the begin key carries the padding length limb; pooled: the
//     batch's rtxn / wtxn), wtxn_c = min(wtxn, T - 1),
//     r_ok = owner < T & rbr < rer, w_ok alike;
//   verdicts, for each read r of txn t = owner (t outside [0, T) marks
//     padding):
//     i0 = max(cum_state[spos[K + r]] - 1, 0)       segment holding the begin
//     i1 = max(cum_state[spos[K + NR + r]], i0 + 1)  first boundary >= end
//     hit = rb < re  and  max(vals[i0 .. i1)) > snapshot[t]
//   with the O(1) range max from two sparse-table entries. Per txn:
//     too_old = valid & has_reads & snapshot < oldest
//     g0 = valid & ~too_old & ~(any hit of its reads).
// Any pooled rtxn is valid input: unsorted, repeated, padding anywhere,
// txns without reads. (Both encoders write it nondecreasing; that only
// makes the fold cheaper.)
//
// Bound on H100: bytes, and mostly latency. Per read it gathers 2 spos,
// 2 cum_state, 2 table entries and 2L key limbs (~90 B at L = 7: 0.4 MB at
// NR = 4,096, ~0.1 us of HBM time), and the masks move at most 17 bytes a
// range, so no launch reaches the bound; the floor is one launch, a chain
// of three dependent gathers (spos -> cum_state -> table) and the fold.
// The masks alone cost a launch (1.6-1.9 us on the H100 for 0.07 us of
// bytes at NR = NW = 16,384), which is why they ride in this one: a read's
// owner is the index the read pass already takes, and the writes need
// nothing the grid barrier orders.
//
// Design. A fold by the last CTA to finish would loop over all T txns in
// one CTA, ~2.8 us per 1,024 txns on the H100 (0.092 ms at T = 32,768), so
// no CTA loops over T. One cooperative launch, grid-strided, as many CTAs
// as the reads and writes or the txns need and the card holds at once:
//   - range pass over max(ceil(NR / 32) * 32, NW) slots, slot j read j
//     and write j, its independent loads first and its stores last: a
//     write's thread writes its owner, wtxn_c and w_ok; a read's thread
//     finds its owner, writes its masks and gathers; every gather is
//     independent across threads. "Has a read" and "hit" fold into two bit
//     sets of ceil(T / 32) words in global scratch: the lanes of a warp
//     whose txns share a word (__match_any_sync) OR their bits together
//     (__reduce_or_sync) and one of them makes the atomicOr, so
//     nondecreasing rtxn costs an atomic per 32 reads and any other order
//     is still right;
//   - one grid barrier (common.cuh `fdb_grid_sync`);
//   - txn pass: a warp per word, a thread per txn; it writes too_old and g0
//     and clears the word, so the scratch is zero again for the next launch.
// r_ok compares the endpoint ranks, as the plain version does, and where
// they are given the hit's rb < re does too: the ranks are dense over the
// endpoint keys, so it equals the key compare
// (tests/test_torch_masks_history.py) at 2 loads in place of up to 2L
// dependent ones. Without them (`history_check`) the keys are compared.
// A refused launch returns its CUDA error, and the Python wrapper raises.
#include "common.cuh"

#define HIST_THREADS 256

// The launch's arguments (one struct, passed by value). The mask outputs
// are optional: rtxn_out / wtxn_out null keep the given pooled owners
// (nothing to write), r_ok null skips the read masks (rbr, rer unread;
// the hits then compare the keys), and NW = 0 skips the write pass.
struct MasksHistoryArgs {
  const int32_t* table;
  int K;
  const int32_t* cum_state;
  const int32_t* spos;
  const int32_t* rb;
  const int32_t* re;
  const int32_t* wb;
  int L, NR, NW, T;
  int strided;
  const int32_t* rtxn;
  const int32_t* wtxn;
  const int32_t* rbr;
  const int32_t* rer;
  const int32_t* wbr;
  const int32_t* wer;
  const int32_t* snapshot;
  const uint8_t* txn_valid;
  const int32_t* oldest;
  int skip_history;
  unsigned int* words;
  unsigned int* sync;
  uint8_t* too_old;
  uint8_t* g0;
  int32_t* rtxn_out;
  int32_t* wtxn_out;
  int32_t* wtxn_c;
  uint8_t* r_ok;
  uint8_t* w_ok;
};

// Slot j of n in the strided layout belongs to txn j / (n / T), or to T
// where its begin key's last limb `last` is the padding length limb (a
// real key never carries it, so an empty real range keeps its txn).
__device__ __forceinline__ int strided_owner(int32_t last, int j, int n,
                                             int T) {
  return last != FDB_PAD_LIMB ? j / (n / T) : T;
}

__global__ void __launch_bounds__(HIST_THREADS)
masks_history_kernel(const MasksHistoryArgs a) {
  const int T = a.T, NR = a.NR, NW = a.NW, K = a.K, L = a.L;
  const int W = (T + 31) >> 5;
  unsigned int* has_reads = a.words;
  unsigned int* hist = a.words + W;
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  const long long read_slots = ((long long)NR + 31) & ~31LL;
  const long long slots = read_slots > NW ? read_slots : NW;

  // range pass: slot j is read j and write j. Every load that waits on no
  // other is issued first and every store comes last, so that a slot
  // costs three dependent rounds to memory: (owners, ranks, spos), then
  // (cum_state, snapshot), then the table. Reads fill whole warps, so the
  // read branch is the same for all lanes of a warp, and every lane of a
  // read warp reaches the warp-wide fold
  for (long long base = (long long)warp * 32; base < slots;
       base += (long long)n_warps * 32) {
    const long long j = base + lane;
    const int w = (int)j;
    int32_t w_own = 0, w_lo = 0, w_hi = 0;
    if (j < NW) {
      w_own = a.strided ? __ldg(&a.wb[(long long)(L - 1) * NW + w])
                        : a.wtxn[w];
      w_lo = a.wbr[w];
      w_hi = a.wer[w];
    }
    if (base < read_slots) {
      const int r = (int)j;
      int t = -1;
      bool hit = false;
      if (r < NR) {
        const int32_t own = a.strided
                                ? __ldg(&a.rb[(long long)(L - 1) * NR + r])
                                : a.rtxn[r];
        int32_t lo = 0, hi = 0;
        if (a.r_ok) {
          lo = a.rbr[r];
          hi = a.rer[r];
        }
        const int p0 = a.spos[K + r], p1 = a.spos[K + NR + r];
        const int owner = a.strided ? strided_owner(own, r, NR, T) : own;
        if ((unsigned)owner < (unsigned)T) t = owner;  // else padding
        if (t >= 0 && !a.skip_history) {
          const int c0 = a.cum_state[p0], c1 = a.cum_state[p1];
          const int32_t snap = a.snapshot[t];
          // rb < re: the ranks where given (dense over the endpoint keys,
          // so the same answer), else the keys
          if (a.r_ok ? lo < hi : fdb_key_lt(a.rb, a.re, L, NR, r)) {
            const int i0 = max(c0 - 1, 0);
            const int i1 = max(c1, i0 + 1);
            const int lvl = 31 - __clz(i1 - i0);
            const int32_t* row = a.table + (long long)lvl * K;
            hit = max(row[i0], row[max(i1 - (1 << lvl), i0)]) > snap;
          }
        }
        if (a.rtxn_out) a.rtxn_out[r] = owner;
        if (a.r_ok) a.r_ok[r] = owner < T && lo < hi;
      }
      const int word = t >= 0 ? t >> 5 : -1;
      const unsigned int bit = t >= 0 ? 1u << (t & 31) : 0u;
      const unsigned int peers = __match_any_sync(0xffffffffu, word);
      const unsigned int reads = __reduce_or_sync(peers, bit);
      const unsigned int hits = __reduce_or_sync(peers, hit ? bit : 0u);
      if (word >= 0 && lane == __ffs(peers) - 1) {
        atomicOr(&has_reads[word], reads);
        if (hits) atomicOr(&hist[word], hits);
      }
    }
    if (j < NW) {
      const int owner = a.strided ? strided_owner(w_own, w, NW, T) : w_own;
      if (a.wtxn_out) a.wtxn_out[w] = owner;
      a.wtxn_c[w] = min(owner, T - 1);
      a.w_ok[w] = owner < T && w_lo < w_hi;
    }
  }

  fdb_grid_sync(a.sync);

  // txn pass: word w is read and then cleared by warp w alone
  const int32_t old = *a.oldest;
  for (int w = warp; w < W; w += n_warps) {
    const unsigned int hr = __ldcg(&has_reads[w]);
    const unsigned int hh = __ldcg(&hist[w]);
    const int t = w * 32 + lane;
    if (t < T) {
      const bool valid = a.txn_valid[t];
      const bool to = valid && ((hr >> lane) & 1u) && a.snapshot[t] < old;
      a.too_old[t] = to;
      a.g0[t] = valid && !to && !((hh >> lane) & 1u);
    }
    __syncwarp();
    if (lane == 0 && (hr | hh)) {
      has_reads[w] = 0;
      hist[w] = 0;
    }
  }
}

// Co-resident CTAs an SM of each device, read once.
static int g_hist_per_sm[64];

// words: 2 * ceil(T / 32) uint32, zero on entry and left zero; sync: 1
// uint32 whose low 31 bits are zero on entry, and stay so. With
// skip_history set (the `no_hist` and `only_merge` ablations of the JAX
// step, :427-429) the read pass folds "has a read" and no hit. In the
// strided layout NR and NW are multiples of T, rtxn / wtxn are not read
// and rtxn_out / wtxn_out must be given; in the pooled layout they may be
// null (the owners are the given ones). r_ok null: no read masks, rbr and
// rer unread; NW = 0: no write pass (wb ... w_ok unread). One cooperative
// launch on `stream`.
extern "C" int fdb_masks_history(
    const int32_t* table, int K, const int32_t* cum_state, const int32_t* spos,
    const int32_t* rb, const int32_t* re, const int32_t* wb, int L, int NR,
    int NW, int strided, const int32_t* rtxn, const int32_t* wtxn,
    const int32_t* rbr, const int32_t* rer, const int32_t* wbr,
    const int32_t* wer, const int32_t* snapshot, const uint8_t* txn_valid,
    const int32_t* oldest, int T, int skip_history, unsigned int* words,
    unsigned int* sync, uint8_t* too_old, uint8_t* g0, int32_t* rtxn_out,
    int32_t* wtxn_out, int32_t* wtxn_c, uint8_t* r_ok, uint8_t* w_ok,
    void* stream) {
  if (T < 1 || L < 1 || NR < 0 || NW < 0 ||
      (strided && (NR % T || NW % T || (NR && !rtxn_out) ||
                   (NW && !wtxn_out))))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  FdbDeviceLimits lim;
  cudaError_t e = fdb_device_limits(&dev, &lim);
  if (e != cudaSuccess) return (int)e;
  if (g_hist_per_sm[dev] == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &g_hist_per_sm[dev], masks_history_kernel, HIST_THREADS, 0);
    if (e != cudaSuccess) {
      g_hist_per_sm[dev] = 0;
      return (int)e;
    }
    if (g_hist_per_sm[dev] < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  // a thread per slot (a read and a write), a warp per word of the bit sets
  const long long W = (T + 31) / 32;
  const long long read_slots = ((long long)NR + 31) / 32 * 32;
  const long long slots = read_slots > NW ? read_slots : NW;
  long long want = (slots + HIST_THREADS - 1) / HIST_THREADS;
  const long long for_txns = (W * 32 + HIST_THREADS - 1) / HIST_THREADS;
  if (for_txns > want) want = for_txns;
  const long long cap = (long long)lim.sms * g_hist_per_sm[dev];
  const int G = (int)(want < cap ? want : cap);
  MasksHistoryArgs a = {table,  K,        cum_state, spos,   rb,
                        re,     wb,       L,         NR,     NW,
                        T,      strided,  rtxn,      wtxn,   rbr,
                        rer,    wbr,      wer,       snapshot, txn_valid,
                        oldest, skip_history, words, sync,   too_old,
                        g0,     rtxn_out, wtxn_out,  wtxn_c, r_ok,
                        w_ok};
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)masks_history_kernel, dim3(G),
                                  dim3(HIST_THREADS), params, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
