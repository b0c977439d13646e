// K4: canonical-Huffman codebook from a 256-bin histogram: int32[256] code
// lengths and uint32[256] canonical codes, for each histogram of a batch.
//
// Replaces datacomp_tpu/ops/codebook.py::device_code_lengths and
// ::device_canonical_codes, XLA ops, and reproduces them tie for tie: leaves
// ordered by (frequency, symbol) with absent symbols last, the two-queue
// merge that takes a leaf on a tie, a lone symbol coded in one bit, and the
// canonical assignment (shorter codes numerically smaller, same-length codes
// consecutive in symbol order) in 32-bit unsigned arithmetic.  Weights are
// 32-bit: exact while the histogram's total is at most 2^32 - 2 (a chunk
// below 2^31 bytes gives less), where the JAX builder's int32 sums are exact
// only below 2^30.  Past that the sums saturate, and the code stays complete.
//
// What bounds it on the H100: latency, not bytes or operations.  It reads
// 1 KB and writes 2 KB; its time is the chain of barriers and dependent
// shared-memory reads from the launch to the last store.
//
// Design: one block of 256 threads, one per symbol, a block for each
// histogram of a batch (the JAX service vmaps device_codebook over a group).
//  1. Sort: each warp sorts its 32 (key, symbol) pairs with a bitonic network
//     of shuffles; a present symbol's leaf slot is then the count of smaller
//     pairs in the 8 sorted runs (a binary search in each).
//  2. Merge in rounds, on warp 0 alone (no block barrier inside).  The serial
//     merge pops nodes in the sorted merge of the leaf queue and the
//     internal-node queue (a leaf first on a tie), and every node it makes
//     from now on weighs at least s1, the sum of the first pair.  So it pops
//     every existing node of weight <= s1 before any node made after this
//     point.  A round puts the first 32 nodes of the merged queues on the
//     lanes (lane k finds node k by a merge-path search), pairs the lanes of
//     weight <= s1 (an even number of them; an odd one waits) and appends
//     their sums in order.  Rounds are about the code's depth on real chunks
//     (10 on text, 24 on skewed); Fibonacci counts pair once a round.
//  3. Depths by parent-pointer doubling over the internal nodes, one barrier
//     a round, until every pointer reaches the root.
//  4. Codes: counts per length from each warp's groups of equal lengths
//     (__match_any_sync), the first code of each length by a shift-and-add
//     scan across each warp, and a symbol's rank among the same-length
//     symbols below it from the groups.  Lengths above 32 are written
//     exactly; their codes are meaningless (the codec raises on such a
//     codebook) but still equal the plain version's.
// tests/test_torch_codebook_schedule.py holds a numpy model of this schedule
// to the plain version and the JAX builder.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSyms = 256;
constexpr int kWarps = kSyms / 32;
constexpr int kMaxLen = 32;
constexpr uint32_t kAbsent = 0xFFFFFFFFu;  // key of an absent symbol
constexpr uint32_t kTop = 0xFFFFFFFEu;     // sums saturate here, below kAbsent
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t sat_add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return (s < a || s > kTop) ? kTop : s;
}

__global__ void __launch_bounds__(kSyms)
codebook_kernel(const int* __restrict__ hist, int* __restrict__ lengths,
                uint32_t* __restrict__ codes) {
  __shared__ unsigned long long run_s[kWarps][32];  // each warp's pairs, sorted
  __shared__ uint32_t leaf_s[kSyms];                // leaf slot -> weight
  __shared__ uint32_t intern_s[kSyms];              // internal node -> weight
  __shared__ int parent_s[2 * kSyms];               // leaf slot k, internal node 256 + m
  __shared__ int ptr_s[2][kSyms];                   // doubling, two buffers: ancestor
  __shared__ int depth_s[2][kSyms];                 //   and the distance to it
  __shared__ int len_s[kSyms];
  __shared__ int warp_count_s[kWarps][kMaxLen + 2];  // lengths 0..32, and 33 for deeper

  hist += blockIdx.x * kSyms;  // this block's histogram of the batch
  lengths += blockIdx.x * kSyms;
  codes += blockIdx.x * kSyms;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int f = hist[t];
  const bool present = f > 0;
  const uint32_t key = present ? (uint32_t)f : kAbsent;
  const unsigned long long mine = ((unsigned long long)key << 8) | (unsigned)t;
  for (int i = t; i < kWarps * (kMaxLen + 2); i += kSyms) (&warp_count_s[0][0])[i] = 0;

  // 1. the leaf slot of symbol t (present symbols only: absent ones are
  // never read).  The 8 searches are independent, so their loads overlap.
  unsigned long long v = mine;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned long long other = __shfl_xor_sync(kFull, v, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      v = keep_min ? (other < v ? other : v) : (other < v ? v : other);
    }
  }
  run_s[warp][lane] = v;
  const int nsym = __syncthreads_count(present);
  int rank = 0;
  if (present) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {  // pairs below mine in run w
      int pos = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        if (run_s[w][pos + step - 1] < mine) pos += step;
      }
      rank += pos + (run_s[w][pos] < mine);
    }
    leaf_s[rank] = key;
  }
  __syncthreads();

  // 2. the merge, on warp 0; li, ii and ni (next leaf, next unpaired
  // internal node, internal nodes made) are the same in every lane
  if (warp == 0) {
    int li = 0, ii = 0, ni = 0;
    while ((nsym - li) + (ni - ii) >= 2) {
      const int na = nsym - li, nb = ni - ii;
      // lane k takes node k of the merged queues: lo of the k nodes before
      // it are leaves (a merge-path search)
      int lo = lane - nb > 0 ? lane - nb : 0;
      int hi = lane < na ? lane : na;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (leaf_s[li + mid - 1] <= intern_s[ii + lane - mid]) lo = mid; else hi = mid - 1;
      }
      const int j = lane - lo;
      const bool valid = lane < na + nb;
      // unconditional loads (clamped), selected after: no predicated
      // address set-up on the round's chain
      const uint32_t lf_at = leaf_s[min(li + lo, kSyms - 1)];
      const uint32_t itf_at = intern_s[min(ii + j, kSyms - 1)];
      const uint32_t lf = lo < na ? lf_at : kAbsent;
      const uint32_t itf = j < nb ? itf_at : kAbsent;
      const bool is_leaf = valid && lf <= itf;
      const uint32_t w = valid ? (is_leaf ? lf : itf) : kAbsent;
      const int node = is_leaf ? li + lo : kSyms + ii + j;
      const uint32_t s1 = sat_add(__shfl_sync(kFull, w, 0), __shfl_sync(kFull, w, 1));
      const int pairs = __popc(__ballot_sync(kFull, w <= s1)) >> 1;  // a prefix of the lanes
      const uint32_t next = __shfl_down_sync(kFull, w, 1);
      const bool paired = lane < 2 * pairs;
      if (paired) parent_s[node] = ni + (lane >> 1);
      if (paired && (lane & 1) == 0) intern_s[ni + (lane >> 1)] = sat_add(w, next);
      const int taken = __popc(__ballot_sync(kFull, paired && is_leaf));
      __syncwarp();
      li += taken;
      ii += 2 * pairs - taken;
      ni += pairs;
    }
  }
  __syncthreads();

  // 3. depths of the internal nodes; the root is the last one made, node
  // nsym - 2 (none when fewer than two symbols)
  const int root = nsym - 2;
  int p = t, d = 0;
  if (t < root) {
    p = parent_s[kSyms + t];
    d = 1;
  }
  int buf = 0;
  ptr_s[0][t] = p;
  depth_s[0][t] = d;
  while (!__syncthreads_and(t >= root || p == root)) {
    if (t < root) {
      d += depth_s[buf][p];
      p = ptr_s[buf][p];
    }
    buf ^= 1;
    ptr_s[buf][t] = p;
    depth_s[buf][t] = d;
  }
  int len = 0;
  if (nsym == 1) {
    len = present;
  } else if (present) {  // present leaves fill slots 0 .. nsym-1
    len = depth_s[buf][parent_s[rank]] + 1;
  }
  lengths[t] = len;
  len_s[t] = len;

  // 4. canonical codes
  const int bucket = len <= kMaxLen ? len : kMaxLen + 1;
  const unsigned peers = __match_any_sync(kFull, bucket);
  if (lane == __ffs(peers) - 1) warp_count_s[warp][bucket] = __popc(peers);
  __syncthreads();
  // every warp scans for itself (no second barrier): lane l gets the first
  // code of length l + 1
  int c = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) c += warp_count_s[w][lane + 1];
  uint32_t first = (uint32_t)__shfl_up_sync(kFull, c, 1) << 1;
  if (lane == 0) first = 0;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const uint32_t u = __shfl_up_sync(kFull, first, s);
    if (lane >= s) first += u << s;
  }
  const int len_lane = len == 0 ? 0 : (len < kMaxLen ? len : kMaxLen) - 1;
  first = __shfl_sync(kFull, first, len_lane);
  uint32_t before = __popc(peers & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) before += warp_count_s[w][bucket];
  if (len > kMaxLen) {  // only on codebooks the codec refuses
    before = 0;
    for (int j = 0; j < t; ++j) before += len_s[j] == len;
  }
  codes[t] = len > 0 ? first + before : 0u;
}

}  // namespace

// hist: int32[rows][256]; lengths: int32[rows][256]; codes: uint32[rows][256].
extern "C" int dcz_codebook(const void* hist, void* lengths, void* codes, int rows,
                            void* stream) {
  codebook_kernel<<<rows, kSyms, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(hist), static_cast<int*>(lengths),
      static_cast<uint32_t*>(codes));
  return (int)cudaGetLastError();
}
