// K1: 256-bin byte histogram of data[:valid_len].
//
// Replaces datacomp_tpu/ops/histogram_pallas.py::_hist_kernel (wrapper
// histogram_pallas).  The TPU kernel contracts packed-8 one-hots on the MXU
// into an f32 accumulator, because the TPU has no fast scatter, and splits
// chunks into 2^24-byte segments to keep f32 counts exact.  Hopper has
// shared-memory atomics, so each byte is one integer atomicAdd and the counts
// are exact int32 at any chunk size below 2^31 bytes.
//
// What bounds it on the H100: one read of the chunk (16 MiB is ~5 us at
// 3.35 TB/s), and the rate at which an SM retires shared-memory atomics, one
// a byte: with no two lanes of a warp on one bank, that rate, and not the
// data, holds it at about twice the byte bound on every kind of input
// (PERF.md).  Atomics of one warp that fell on one bank (or one bin, on
// skewed data) would serialise; the layout below rules that out.
//
// Design: a persistent grid, one block of 1024 threads on each SM, reading
// the chunk in a grid-stride loop of 16-byte loads, four in flight a thread,
// masked by valid_len inside the kernel.  Each block counts into 32 copies of
// the histogram in shared memory, one for each lane of a warp, laid out so
// that lane l's copy of every bin lies in bank l (32 KiB): an atomic of a
// warp touches 32 banks whatever the data, so no two lanes ever wait on each
// other.  A block then folds its 32 copies into one partial histogram, which
// it writes (no atomics) into its own row of the scratch; a second kernel of
// 8 blocks sums the rows into the output.  Nothing is zeroed beforehand and
// no global atomics remain.  The second kernel is a programmatic dependent
// launch: the first lets it start at once, and it waits on the first's
// completion inside (griddepcontrol), so its launch overlaps the counting.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kLanes = 32;
constexpr int kBins = 256;
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread
constexpr unsigned kFull = 0xFFFFFFFFu;
// the summing kernel: kSumBlocks blocks of 32 bins, 32 row groups a block
constexpr int kSumBlocks = kBins / kLanes;
constexpr int kSumGroups = 32;

__device__ __forceinline__ void count_word(uint32_t* lane_bins, uint32_t w) {
  atomicAdd(&lane_bins[(w & 0xFF) * kLanes], 1u);
  atomicAdd(&lane_bins[((w >> 8) & 0xFF) * kLanes], 1u);
  atomicAdd(&lane_bins[((w >> 16) & 0xFF) * kLanes], 1u);
  atomicAdd(&lane_bins[(w >> 24) * kLanes], 1u);
}

__device__ __forceinline__ void count_vec(uint32_t* lane_bins, const uint4& q) {
  count_word(lane_bins, q.x);
  count_word(lane_bins, q.y);
  count_word(lane_bins, q.z);
  count_word(lane_bins, q.w);
}

__global__ void __launch_bounds__(kThreads)
histogram_kernel(const uint8_t* __restrict__ data, int64_t valid_len,
                 int* __restrict__ partial) {
  __shared__ uint32_t bins[kBins * kLanes];  // bin b of lane l at b * 32 + l
  asm volatile("griddepcontrol.launch_dependents;");  // the summing kernel may start
  for (int i = threadIdx.x; i < kBins * kLanes; i += kThreads) bins[i] = 0;
  __syncthreads();

  uint32_t* mine = bins + (threadIdx.x & (kLanes - 1));
  const int64_t nvec = valid_len / 16;  // whole 16-byte vectors below valid_len
  const uint4* vec = reinterpret_cast<const uint4*>(data);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (; v + (kUnroll - 1) * stride < nvec; v += kUnroll * stride) {
    uint4 q[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) q[k] = __ldcs(vec + v + k * stride);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) count_vec(mine, q[k]);
  }
  for (; v < nvec; v += stride) count_vec(mine, __ldcs(vec + v));
  // the ragged tail: fewer than 16 bytes, taken by block 0
  if (blockIdx.x == 0 && threadIdx.x < (valid_len & 15)) {
    atomicAdd(&mine[data[nvec * 16 + threadIdx.x] * kLanes], 1u);
  }
  __syncthreads();

  // fold: four threads a bin, each summing 8 lanes' copies (rotated by the
  // bin, so that a warp's reads fall on 32 banks), then across the four
  const int bin = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += bins[bin * kLanes + part * 8 + ((k + bin) & 7)];
  s += __shfl_xor_sync(kFull, s, 1);
  s += __shfl_xor_sync(kFull, s, 2);
  if (part == 0) partial[(int64_t)blockIdx.x * kBins + bin] = (int)s;
}

// hist[b] = sum of partial[r * 256 + b] over the rows r < rows.  Block k
// takes bins 32k .. 32k+31; its 32 warps take every 32nd row (about four
// each, all loads in flight), each lane a bin.
__global__ void __launch_bounds__(kLanes * kSumGroups)
histogram_sum_kernel(const int* __restrict__ partial, int rows, int* __restrict__ hist) {
  __shared__ int group_s[kSumGroups][kLanes];
  const int lane = threadIdx.x & (kLanes - 1);
  const int group = threadIdx.x / kLanes;
  const int bin = blockIdx.x * kLanes + lane;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // every row written and visible
  int s = 0;
#pragma unroll 8
  for (int r = group; r < rows; r += kSumGroups) s += partial[(int64_t)r * kBins + bin];
  group_s[group][lane] = s;
  __syncthreads();
  if (group == 0) {
#pragma unroll
    for (int g = 1; g < kSumGroups; ++g) s += group_s[g][lane];
    hist[bin] = s;
  }
}

}  // namespace

// data: uint8[>= valid_len], 16-byte aligned; hist: int32[256], written
// whole; partial: int32[max_blocks * 256] scratch, one row a block of the
// first kernel (max_blocks: the SM count, one block each).
extern "C" int dcz_histogram(const void* data, int64_t valid_len, void* hist, void* partial,
                             int max_blocks, void* stream) {
  const int64_t nvec = (valid_len + 15) / 16;
  int64_t blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;  // valid_len 0 still writes the zeros
  cudaStream_t s = (cudaStream_t)stream;
  histogram_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(data), valid_len, static_cast<int*>(partial));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t sum = {};
  sum.gridDim = dim3(kSumBlocks);
  sum.blockDim = dim3(kLanes * kSumGroups);
  sum.stream = s;
  sum.attrs = &early;
  sum.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&sum, histogram_sum_kernel, static_cast<const int*>(partial),
                                 (int)blocks, static_cast<int*>(hist));
}

// Message for a code returned by any dcz_* entry point (all sources link
// into one library, so it is defined once, here).
extern "C" const char* dcz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
