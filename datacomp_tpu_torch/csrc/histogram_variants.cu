// A/B variants of K1, the 256-bin byte histogram of data[:valid_len].  They
// are timed against K1 by datacomp_tpu_torch/tools/ab_histogram.py; the
// codec never runs them.
//
// K1s, dcz_histogram_stacked, replaces the kernel that
// tools/ab_hist_pallas_r3.py::make_stacked builds.  The axis r3 probes is how
// many updates reach the accumulator per block: sixteen small one-hot dots,
// or one or two stacked ones.  On Hopper the same axis is how often a
// thread's counts are folded into the block's histogram.  Each thread counts
// into private narrow counters in shared memory (8-bit counters four to a
// word, or 16-bit counters two to a word), with no atomics; every
// `groups` x 16 bytes a thread, the block folds them: thread b sums bin b
// over all threads' counters into a register, and the counters restart at
// zero.  r3's variants map to (groups, counter_bits) = (16, 8) "stacked",
// (8, 8) "stacked8" and (16, 16) "stacked-i16".
//
// K1p, dcz_histogram_partial, replaces tools/ab_hist_pallas_r4.py::kernel_2d
// (via hist_partial).  The axis r4 probes is one accumulator that the whole
// grid adds into against k independent partial accumulators summed
// afterwards.  Here the grid is cut into k stripes of consecutive blocks,
// each over its own 1/k of the data, and each stripe adds into its own row
// of an int32[k, 256] buffer, so no two stripes touch the same atomics; the
// wrapper sums the rows.  k = 1 is K1's shape.  r4's "parallel" dimension
// semantics has no counterpart: blocks always run in parallel on a GPU.
//
// What bounds them on the H100: one read of the chunk (16 MiB is about 5 us
// at 3.35 TB/s).  K1s trades K1's shared-memory atomics for one private
// read-modify-write a byte plus one shared read a counter at each fold; K1p
// keeps K1's per-warp atomics and changes only where the blocks' sums land.
//
// An 8-bit counter holds 255, and a thread adds at most groups x 16 = 256
// bytes a fold, so with groups = 16 a counter wraps exactly when all 256 of
// the thread's bytes were one symbol.  The thread checks for that as it
// loads; such a thread clears its counters and adds 256 to the symbol's bin
// directly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // one bin a thread at the fold
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 16;

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <int kBits>
__global__ void __launch_bounds__(kThreads)
stacked_kernel(const uint8_t* __restrict__ data, int64_t valid_len,
               int64_t vec_per_block, int groups, int* __restrict__ hist) {
  constexpr int kPerWord = 32 / kBits;
  constexpr int kWords = 256 / kPerWord;
  constexpr uint32_t kMask = (1u << kBits) - 1;
  extern __shared__ uint32_t cnt[];  // word w of thread u at cnt[w * kThreads + u]
  __shared__ int direct[256];        // bins added past the counters
  const int t = threadIdx.x;
  for (int w = 0; w < kWords; ++w) cnt[w * kThreads + t] = 0;
  direct[t] = 0;
  __syncthreads();

  const int64_t nvec = valid_len / 16;
  const int64_t v0 = (int64_t)blockIdx.x * vec_per_block;
  const int64_t v1 = v0 + vec_per_block < nvec ? v0 + vec_per_block : nvec;
  const uint4* vec = reinterpret_cast<const uint4*>(data);
  const bool can_wrap = kBits == 8 && groups * 16 > 255;
  const int fold_word = t / kPerWord, fold_shift = (t % kPerWord) * kBits;
  int total = 0;  // bin t, folded

  for (int64_t base = v0; base < v1; base += (int64_t)groups * kThreads) {
    int loads = 0;
    bool uniform = true;
    uint32_t rep = 0;  // the first byte, four times
#pragma unroll 4
    for (int g = 0; g < groups; ++g) {
      const int64_t v = base + (int64_t)g * kThreads + t;
      if (v < v1) {
        const uint4 q = vec[v];
        const uint32_t w4[4] = {q.x, q.y, q.z, q.w};
        if (can_wrap) {
          if (loads == 0) rep = (q.x & 0xFFu) * 0x01010101u;
          uniform &= (q.x == rep) & (q.y == rep) & (q.z == rep) & (q.w == rep);
        }
        ++loads;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const uint32_t s = (w4[k] >> (8 * b)) & 0xFFu;
            cnt[(s / kPerWord) * kThreads + t] += 1u << ((s % kPerWord) * kBits);
          }
        }
      }
    }
    if (can_wrap && uniform && loads * 16 > 255) {  // one symbol filled a counter
      const uint32_t s = rep & 0xFFu;
      for (int w = 0; w < kWords; ++w) cnt[w * kThreads + t] = 0;
      atomicAdd(&direct[s], loads * 16);
    }
    __syncthreads();
    // fold: bin t over every thread's counters, starting at a different
    // thread in each lane so that a warp reads 32 banks
    for (int i = 0; i < kThreads; ++i) {
      const int u = (i + t) & (kThreads - 1);
      total += (cnt[fold_word * kThreads + u] >> fold_shift) & kMask;
    }
    __syncthreads();
    for (int w = 0; w < kWords; ++w) cnt[w * kThreads + t] = 0;
  }
  // the ragged tail: fewer than 16 bytes, taken by block 0
  if (blockIdx.x == 0 && t < (valid_len & 15)) atomicAdd(&direct[data[nvec * 16 + t]], 1);
  __syncthreads();
  total += direct[t];
  if (total) atomicAdd(&hist[t], total);
}

__global__ void __launch_bounds__(kThreads)
partial_kernel(const uint8_t* __restrict__ data, int64_t valid_len, int k,
               int* __restrict__ partial) {
  __shared__ int sub[kWarps][256];
  int* flat = &sub[0][0];
  for (int i = threadIdx.x; i < kWarps * 256; i += kThreads) flat[i] = 0;
  __syncthreads();

  const int per_stripe = gridDim.x / k;
  const int stripe = blockIdx.x / per_stripe;
  const int64_t nvec = valid_len / 16;
  const int64_t span = (nvec + k - 1) / k;
  const int64_t v0 = stripe * span;
  const int64_t v1 = v0 + span < nvec ? v0 + span : nvec;
  int* mine = sub[threadIdx.x / 32];
  const uint4* vec = reinterpret_cast<const uint4*>(data);
  const int64_t stride = (int64_t)per_stripe * kThreads;
  for (int64_t v = v0 + (int64_t)(blockIdx.x % per_stripe) * kThreads + threadIdx.x; v < v1;
       v += stride) {
    const uint4 q = vec[v];
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int b = 0; b < 4; ++b) atomicAdd(&mine[(w[j] >> (8 * b)) & 0xFF], 1);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < (valid_len & 15)) {
    atomicAdd(&mine[data[nvec * 16 + threadIdx.x]], 1);
  }
  __syncthreads();

  for (int bin = threadIdx.x; bin < 256; bin += kThreads) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sub[w][bin];
    if (s) atomicAdd(&partial[stripe * 256 + bin], s);
  }
}

template <int kBits>
int launch_stacked(const uint8_t* data, int64_t valid_len, int groups, int* hist,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(256 / (32 / kBits)) * kThreads * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      stacked_kernel<kBits>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stacked_kernel<kBits>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t nvec = valid_len / 16;
  const int64_t period = (int64_t)groups * kThreads;  // vectors a block takes per fold
  int64_t blocks = (nvec + period - 1) / period;
  const int64_t resident = (int64_t)sm_count() * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;  // the tail alone
  // whole folds a block, so that only the last block has a partial one
  const int64_t vec_per_block = ((nvec + blocks - 1) / blocks + period - 1) / period * period;
  stacked_kernel<kBits><<<(unsigned)blocks, kThreads, smem, stream>>>(
      data, valid_len, vec_per_block, groups, hist);
  return (int)cudaGetLastError();
}

}  // namespace

// data: uint8[>= valid_len], 16-byte aligned; hist: int32[256], zeroed;
// groups in [1, 16]; counter_bits 8 or 16.
extern "C" int dcz_histogram_stacked(const void* data, int64_t valid_len, int groups,
                                     int counter_bits, void* hist, void* stream) {
  if (groups < 1 || groups > kMaxGroups || (counter_bits != 8 && counter_bits != 16)) {
    return (int)cudaErrorInvalidValue;
  }
  if (valid_len <= 0) return (int)cudaGetLastError();
  const uint8_t* d = static_cast<const uint8_t*>(data);
  int* h = static_cast<int*>(hist);
  return counter_bits == 8
             ? launch_stacked<8>(d, valid_len, groups, h, (cudaStream_t)stream)
             : launch_stacked<16>(d, valid_len, groups, h, (cudaStream_t)stream);
}

// data as above; partial: int32[k * 256], zeroed; k in [1, 64].
extern "C" int dcz_histogram_partial(const void* data, int64_t valid_len, int k,
                                     void* partial, void* stream) {
  if (k < 1 || k > 64) return (int)cudaErrorInvalidValue;
  if (valid_len > 0) {
    const int64_t nvec = (valid_len + 15) / 16;
    int64_t per_stripe = ((nvec + k - 1) / k + kThreads - 1) / kThreads;
    const int64_t cap = (int64_t)sm_count() * 8 / k;  // 8 blocks an SM in all
    if (per_stripe > cap) per_stripe = cap;
    if (per_stripe < 1) per_stripe = 1;
    partial_kernel<<<(unsigned)(per_stripe * k), kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint8_t*>(data), valid_len, k, static_cast<int*>(partial));
  }
  return (int)cudaGetLastError();
}
