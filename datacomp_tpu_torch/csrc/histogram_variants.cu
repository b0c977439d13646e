// A/B variants of K1, the 256-bin byte histogram of data[:valid_len].  They
// are timed against K1 by datacomp_tpu_torch/tools/ab_histogram.py and
// ab_codec.py; the codec never runs them.  Both write each block's partial
// histogram into its own row of a scratch (no atomics, nothing zeroed
// beforehand), and histogram_core.cuh's summing kernel, launched
// programmatically dependent, sums the rows into the output.
//
// K1p, dcz_histogram_partial, replaces tools/ab_hist_pallas_r4.py::kernel_2d
// (via hist_partial).  The axis r4 probes is one accumulator that the whole
// grid adds into against k independent partial accumulators summed
// afterwards.  Here the grid is k stripes of blocks, stripe s reading only
// its own contiguous 1/k of the 16-byte vectors, each block with its own row;
// the summing kernel adds the rows.  The grid is two-dimensional (blocks of a
// stripe by stripes) and the host passes a stripe's length, so no block
// divides.  k = 1 is K1's shape, and the counting is K1's core
// (histogram_core.cuh): 32 lane-banked copies of the histogram a block, so a
// warp's shared atomics never share a bank.  What bounds it on the H100 is
// what bounds K1: one read of the chunk (16 MiB is about 5 us at 3.35 TB/s)
// and the SMs' rate of shared atomics, one a byte.  r4's "parallel"
// dimension semantics has no counterpart: blocks always run in parallel on a
// GPU.
//
// K1s, dcz_histogram_stacked, replaces the kernel that
// tools/ab_hist_pallas_r3.py::make_stacked builds.  The axis r3 probes is how
// many updates reach the accumulator per block: sixteen small one-hot dots,
// or one or two stacked ones.  On Hopper the same axis is how often a
// thread's counts are folded: each thread counts into private narrow counters
// in shared memory (8-bit counters four to a word, or 16-bit counters two to
// a word), with no atomics, and every `groups` x 16 of its bytes its warp
// folds them.  r3's variants map to (groups, counter_bits) = (16, 8)
// "stacked", (8, 8) "stacked8" and (16, 16) "stacked-i16".  What bounds it on
// the H100 is not the one read of the chunk but the instructions a byte: an
// extract, a word index, a field shift, a shared load, an add and a store,
// about nine, and two shared accesses a byte through the SM's shared-memory
// pipe, plus the fold's reads and clears.  (Issuing all of a window's loads at
// once, or loading a word's four counters at once and forwarding the sums in
// registers, measured slower: PERF.md, section 6.)  The design keeps that traffic
// lane-banked and small:
// - bin s is field s / W of word s % W (W = 64 words of four 8-bit fields, or
//   128 of two 16-bit fields); thread t's word w lies at w * 128 + t, in bank
//   t % 32, so no two lanes of a warp ever touch one bank;
// - a warp counts windows of `groups` x 32 consecutive vectors (lane l takes
//   vectors l, l + 32, ...: every load of the warp is 512 contiguous bytes)
//   and folds its own counters after each window, with __syncwarp and no
//   block barrier: lane l sums word l + 32m of all 32 threads (starting at a
//   different thread in each lane, so the warp reads 32 banks) and clears it;
// - the fold adds packed words: an 8-bit word splits into its two halves
//   with 16-bit fields (w & 0x00FF00FF, (w >> 8) & 0x00FF00FF), and a 16-bit
//   word adds whole, since 32 lanes x 256 fits 16 bits; so one shared read
//   folds four or two counters, and lane l ends up owning bins l + 32j;
// - 128 threads a block, and as many blocks an SM as the counters' shared
//   memory allows (the occupancy API), up to one window a warp.
// An 8-bit counter holds 255, and a thread adds at most groups x 16 = 256
// bytes a window, so with groups = 16 a counter wraps exactly when all 256 of
// the thread's bytes were one symbol.  The thread checks for that as it
// loads; such a thread clears that symbol's word (the only one it touched)
// and adds 256 to the block's row directly.

#include "histogram_core.cuh"

namespace {

constexpr int kStackedThreads = 128;
constexpr int kStackedWarps = kStackedThreads / kLanes;
constexpr int kMaxGroups = 16;

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// Block (x, y) is block x of stripe y, which counts vectors [y * span,
// (y + 1) * span) below valid_len / 16; its row is y * gridDim.x + x.
__global__ void __launch_bounds__(kThreads)
partial_kernel(const uint8_t* __restrict__ data, int64_t valid_len, int64_t span,
               int* __restrict__ partial) {
  __shared__ uint32_t bins[kBins * kLanes];
  asm volatile("griddepcontrol.launch_dependents;");  // the summing kernel may start
  uint32_t* mine = lane_bins_init(bins);
  const int64_t nvec = valid_len / 16;
  const int64_t v0 = blockIdx.y * span < nvec ? blockIdx.y * span : nvec;
  const int64_t v1 = v0 + span < nvec ? v0 + span : nvec;
  const int row = blockIdx.y * gridDim.x + blockIdx.x;
  count_vectors(mine, reinterpret_cast<const uint4*>(data),
                v0 + (int64_t)blockIdx.x * kThreads + threadIdx.x, v1,
                (int64_t)gridDim.x * kThreads);
  if (row == 0) count_tail(mine, data, valid_len);
  fold_lane_bins(bins, partial + (int64_t)row * kBins);
}

template <int kBits>
struct Counters {
  static constexpr int kWords = kBins * kBits / 32;  // words a thread
  static constexpr int kFieldShift = kBits == 8 ? 24 : 16;  // (s >> 3) & this: s / kWords * kBits
  static constexpr size_t kSmem = (size_t)kWords * kStackedThreads * sizeof(uint32_t);
};

// One word's four bytes into the thread's counters (mine: its word 0).
template <int kBits>
__device__ __forceinline__ void count_private(uint32_t* mine, uint32_t w) {
  using C = Counters<kBits>;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t s = (w >> (8 * b)) & 0xFFu;
    mine[(s & (C::kWords - 1)) * kStackedThreads] += 1u << ((s >> 3) & C::kFieldShift);
  }
}

template <int kBits>
__global__ void __launch_bounds__(kStackedThreads)
stacked_kernel(const uint8_t* __restrict__ data, int64_t valid_len, int groups,
               int* __restrict__ partial) {
  using C = Counters<kBits>;
  extern __shared__ uint32_t cnt[];  // word w of thread t at cnt[w * kStackedThreads + t]
  __shared__ int row[kBins];         // the block's partial histogram
  asm volatile("griddepcontrol.launch_dependents;");  // the summing kernel may start
  const int t = threadIdx.x;
  const int lane = t & (kLanes - 1);
  uint32_t* mine = cnt + t;
  for (int w = 0; w < C::kWords; ++w) mine[w * kStackedThreads] = 0;
  for (int i = t; i < kBins; i += kStackedThreads) row[i] = 0;
  __syncthreads();

  const int64_t nvec = valid_len / 16;
  const uint4* vec = reinterpret_cast<const uint4*>(data);
  const int64_t per_window = (int64_t)groups * kLanes;  // vectors a warp takes a window
  const int64_t windows = (nvec + per_window - 1) / per_window;
  const int64_t nwarps = (int64_t)gridDim.x * kStackedWarps;
  const bool can_wrap = kBits == 8 && groups == kMaxGroups;
  uint32_t* warp_cnt = cnt + (t - lane);  // the counters of this warp's thread 0
  uint32_t total[kBins / kLanes] = {};  // bin lane + 32 j, folded

  for (int64_t win = (int64_t)blockIdx.x * kStackedWarps + t / kLanes; win < windows;
       win += nwarps) {
    const int64_t base = win * per_window + lane;
    int loads = 0;
    bool uniform = true;
    uint32_t rep = 0;  // the window's first byte, four times
    for (int g = 0; g < groups; g += kUnroll) {
      uint4 q[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int64_t v = base + (int64_t)(g + k) * kLanes;
        q[k] = g + k < groups && v < nvec ? __ldcs(vec + v) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (g + k < groups && base + (int64_t)(g + k) * kLanes < nvec) {
          if (can_wrap) {
            if (g + k == 0) rep = (q[k].x & 0xFFu) * 0x01010101u;
            uniform &= (q[k].x == rep) & (q[k].y == rep) & (q[k].z == rep) & (q[k].w == rep);
          }
          ++loads;
          count_private<kBits>(mine, q[k].x);
          count_private<kBits>(mine, q[k].y);
          count_private<kBits>(mine, q[k].z);
          count_private<kBits>(mine, q[k].w);
        }
      }
    }
    if (can_wrap && uniform && loads == kMaxGroups) {  // one symbol filled a counter
      const uint32_t s = rep & 0xFFu;
      mine[(s & (C::kWords - 1)) * kStackedThreads] = 0;
      atomicAdd(&row[s], kMaxGroups * 16);
    }
    __syncwarp();
    // fold and clear: lane l takes word l + 32m of every thread of the warp
#pragma unroll
    for (int m = 0; m < C::kWords / kLanes; ++m) {
      const int w = lane + m * kLanes;
      uint32_t* col = warp_cnt + w * kStackedThreads;
      uint32_t lo = 0, hi = 0;
#pragma unroll 8
      for (int i = 0; i < kLanes; ++i) {
        const int u = (i + lane) & (kLanes - 1);
        const uint32_t c = col[u];
        col[u] = 0;
        if constexpr (kBits == 8) {
          lo += c & 0x00FF00FFu;
          hi += (c >> 8) & 0x00FF00FFu;
        } else {
          lo += c;
        }
      }
      // word w holds bins w + kWords * f, field f; 8-bit: f = 0, 2 in lo and 1, 3 in hi
      if constexpr (kBits == 8) {
        total[m] += lo & 0xFFFFu;
        total[m + 4] += lo >> 16;
        total[m + 2] += hi & 0xFFFFu;
        total[m + 6] += hi >> 16;
      } else {
        total[m] += lo & 0xFFFFu;
        total[m + 4] += lo >> 16;
      }
    }
    __syncwarp();
  }
  // the ragged tail: fewer than 16 bytes, taken by block 0
  if (blockIdx.x == 0 && t < (valid_len & 15)) atomicAdd(&row[data[nvec * 16 + t]], 1);
#pragma unroll
  for (int j = 0; j < kBins / kLanes; ++j) {
    if (total[j]) atomicAdd(&row[lane + j * kLanes], (int)total[j]);
  }
  __syncthreads();
  int* out = partial + (int64_t)blockIdx.x * kBins;
  for (int i = t; i < kBins; i += kStackedThreads) out[i] = row[i];
}

// Blocks of stacked_kernel<kBits> resident on the device at once.
template <int kBits>
int stacked_rows(int* rows) {
  cudaError_t err = cudaFuncSetAttribute(stacked_kernel<kBits>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Counters<kBits>::kSmem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stacked_kernel<kBits>,
                                                      kStackedThreads, Counters<kBits>::kSmem);
  if (err != cudaSuccess) return (int)err;
  *rows = sm_count() * (per_sm > 0 ? per_sm : 1);
  return 0;
}

template <int kBits>
int launch_stacked(const uint8_t* data, int64_t valid_len, int groups, int* hist, int* partial,
                   int max_rows, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(stacked_kernel<kBits>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)Counters<kBits>::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int64_t per_window = (int64_t)groups * kLanes;
  const int64_t windows = (valid_len / 16 + per_window - 1) / per_window;
  int64_t blocks = (windows + kStackedWarps - 1) / kStackedWarps;  // up to a window a warp
  if (blocks > max_rows) blocks = max_rows;
  if (blocks < 1) blocks = 1;  // the tail alone, or valid_len 0: the zeros
  stacked_kernel<kBits><<<(unsigned)blocks, kStackedThreads, Counters<kBits>::kSmem, stream>>>(
      data, valid_len, groups, partial);
  return launch_histogram_sum(partial, (int)blocks, hist, stream);
}

}  // namespace

// *rows = the most rows dcz_histogram_stacked's scratch needs with these
// counters: the blocks resident on the current device at once.
extern "C" int dcz_histogram_stacked_rows(int counter_bits, int* rows) {
  if (counter_bits != 8 && counter_bits != 16) return (int)cudaErrorInvalidValue;
  return counter_bits == 8 ? stacked_rows<8>(rows) : stacked_rows<16>(rows);
}

// data: uint8[>= valid_len], 16-byte aligned; hist: int32[256], written
// whole; partial: int32[max_rows * 256] scratch (max_rows from
// dcz_histogram_stacked_rows); groups in [1, 16]; counter_bits 8 or 16.
extern "C" int dcz_histogram_stacked(const void* data, int64_t valid_len, int groups,
                                     int counter_bits, void* hist, void* partial, int max_rows,
                                     void* stream) {
  if (groups < 1 || groups > kMaxGroups || (counter_bits != 8 && counter_bits != 16) ||
      max_rows < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const uint8_t* d = static_cast<const uint8_t*>(data);
  int* h = static_cast<int*>(hist);
  int* p = static_cast<int*>(partial);
  cudaStream_t s = (cudaStream_t)stream;
  return counter_bits == 8 ? launch_stacked<8>(d, valid_len, groups, h, p, max_rows, s)
                           : launch_stacked<16>(d, valid_len, groups, h, p, max_rows, s);
}

// data, hist as above; k in [1, 64]; partial: int32[k * max_per_stripe * 256]
// scratch, one row a block (max_per_stripe: the SM count over k, at least 1).
extern "C" int dcz_histogram_partial(const void* data, int64_t valid_len, int k, void* hist,
                                     void* partial, int max_per_stripe, void* stream) {
  if (k < 1 || k > 64 || max_per_stripe < 1) return (int)cudaErrorInvalidValue;
  const int64_t span = (valid_len / 16 + k - 1) / k;  // vectors a stripe
  int64_t per_stripe = (span + kThreads - 1) / kThreads;
  if (per_stripe > max_per_stripe) per_stripe = max_per_stripe;
  if (per_stripe < 1) per_stripe = 1;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (int)per_stripe * k;
  partial_kernel<<<dim3((unsigned)per_stripe, (unsigned)k), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(data), valid_len, span, static_cast<int*>(partial));
  return launch_histogram_sum(static_cast<const int*>(partial), blocks,
                              static_cast<int*>(hist), s);
}
