// K4: canonical-Huffman codebook from a 256-bin histogram: int32[256] code
// lengths and uint32[256] canonical codes.
//
// Replaces datacomp_tpu/ops/codebook.py::device_code_lengths and
// ::device_canonical_codes, XLA ops, and reproduces them tie for tie: leaves
// ordered by (frequency, symbol) with absent symbols last, the two-queue
// merge that takes a leaf on a tie, a lone symbol coded in one bit, and the
// canonical assignment (shorter codes numerically smaller, same-length codes
// consecutive in symbol order) in 32-bit unsigned arithmetic.  Frequencies
// are carried in 64 bits, so the result is the JAX builder's wherever that
// builder's int32 sums do not overflow (totals below 2^30).
//
// What bounds it on the H100: latency, not bytes or operations.  It reads
// 1 KB and writes 2 KB; the merge is a chain of about 255 dependent steps
// through shared memory, each waiting on the last, so it takes tens of
// microseconds whatever the card's rates.
//
// Design: one block of 256 threads, one per symbol.  Each thread ranks its
// leaf by counting the smaller (key, symbol) pairs (256 broadcast reads of
// shared memory), so the sort is one parallel step.  Thread 0 walks the merge
// and then the internal nodes' depths root first (each node's parent was
// made after it); every thread then reads its leaf's depth.  Lengths above
// 32 are written exactly; their codes are meaningless, and the codec raises
// on such a codebook.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSyms = 256;
constexpr int kIntern = kSyms - 1;
constexpr int kMaxLen = 32;
constexpr long long kInf = 1LL << 62;  // key of an absent symbol

__global__ void __launch_bounds__(kSyms)
codebook_kernel(const int* __restrict__ hist, int* __restrict__ lengths,
                uint32_t* __restrict__ codes) {
  __shared__ long long key_s[kSyms];
  __shared__ long long leaf_f[kSyms];   // keys in leaf order
  __shared__ long long intern_f[kIntern];
  __shared__ int parent[kSyms + kIntern];  // leaf slot k -> node k; internal m -> 256 + m
  __shared__ int depth[kSyms + kIntern];
  __shared__ int len_s[kSyms];
  __shared__ int count_s[kMaxLen + 1];
  __shared__ uint32_t first_s[kMaxLen + 1];

  const int t = threadIdx.x;
  const int f = hist[t];
  const bool present = f > 0;
  const long long key = present ? (long long)f : kInf;
  key_s[t] = key;
  parent[t] = -1;
  if (t < kIntern) parent[kSyms + t] = -1;
  if (t <= kMaxLen) count_s[t] = 0;
  const int nsym = __syncthreads_count(present);

  // leaf slot of symbol t: the number of (key, symbol) pairs before it
  int rank = 0;
  for (int j = 0; j < kSyms; ++j) {
    const long long kj = key_s[j];
    rank += (kj < key) | ((kj == key) & (j < t));
  }
  leaf_f[rank] = key;
  __syncthreads();

  if (t == 0) {
    int li = 0, ii = 0, ni = 0;  // next leaf, next unmerged internal, internals made
    for (int step = 0; step < nsym - 1; ++step) {
      int id[2];
      long long sum = 0;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const long long lf = li < kSyms ? leaf_f[li] : kInf;
        const long long itf = ii < ni ? intern_f[ii] : kInf;
        if (lf <= itf) {  // a leaf wins a tie
          id[p] = li++;
          sum += lf;
        } else {
          id[p] = kSyms + ii++;
          sum += itf;
        }
      }
      parent[id[0]] = kSyms + ni;
      parent[id[1]] = kSyms + ni;
      intern_f[ni++] = sum;
    }
    if (nsym >= 2) {
      depth[kSyms + nsym - 2] = 0;  // the root
      for (int m = nsym - 3; m >= 0; --m) depth[kSyms + m] = depth[parent[kSyms + m]] + 1;
    }
  }
  __syncthreads();

  int len = 0;
  if (nsym == 1) {
    len = present;
  } else if (present) {  // present leaves fill slots 0 .. nsym-1
    len = depth[parent[rank]] + 1;
  }
  len_s[t] = len;
  lengths[t] = len;
  if (len > 0 && len <= kMaxLen) atomicAdd(&count_s[len], 1);
  __syncthreads();

  if (t == 0) {
    uint32_t code = 0;
    first_s[0] = 0;
    for (int l = 1; l <= kMaxLen; ++l) {
      code = (code + (uint32_t)count_s[l - 1]) << 1;
      first_s[l] = code;
    }
  }
  __syncthreads();

  uint32_t before = 0;  // symbols below t with the same length
  for (int j = 0; j < t; ++j) before += len_s[j] == len;
  codes[t] = len > 0 ? first_s[len < kMaxLen ? len : kMaxLen] + before : 0u;
}

}  // namespace

// hist: int32[256]; lengths: int32[256]; codes: uint32[256].
extern "C" int dcz_codebook(const void* hist, void* lengths, void* codes, void* stream) {
  codebook_kernel<<<1, kSyms, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(hist), static_cast<int*>(lengths),
      static_cast<uint32_t*>(codes));
  return (int)cudaGetLastError();
}
