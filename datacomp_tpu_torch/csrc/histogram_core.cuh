// The counting core of the byte histograms K1 (histogram.cu) and K1p
// (histogram_variants.cu), and the summing kernel that K1, K1p and K1s share.
//
// Each block of kThreads threads counts into 32 copies of the histogram in
// shared memory, one for each lane of a warp, laid out so that lane l's copy
// of every bin lies in bank l (32 KiB): an atomic of a warp touches 32 banks
// whatever the data, so no two lanes ever wait on each other.  A block then
// folds its 32 copies into one row, which it writes (no atomics) into its own
// row of a scratch; histogram_sum_kernel, launched programmatically dependent
// on the counting kernel (launch_histogram_sum), sums the rows into the
// output.  Nothing is zeroed beforehand and no global atomics remain.
//
// Included by several sources: everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

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

// Zero the block's 32 lane copies (bins: kBins * kLanes words of shared
// memory, bin b of lane l at b * 32 + l) and return this thread's lane copy.
__device__ __forceinline__ uint32_t* lane_bins_init(uint32_t* bins) {
  for (int i = threadIdx.x; i < kBins * kLanes; i += kThreads) bins[i] = 0;
  __syncthreads();
  return bins + (threadIdx.x & (kLanes - 1));
}

// Count the 16-byte vectors v, v + stride, ... below end, kUnroll loads in
// flight, streaming (each byte is read once).
__device__ __forceinline__ void count_vectors(uint32_t* mine, const uint4* vec, int64_t v,
                                              int64_t end, int64_t stride) {
  for (; v + (kUnroll - 1) * stride < end; v += kUnroll * stride) {
    uint4 q[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) q[k] = __ldcs(vec + v + k * stride);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) count_vec(mine, q[k]);
  }
  for (; v < end; v += stride) count_vec(mine, __ldcs(vec + v));
}

// The ragged tail below valid_len, fewer than 16 bytes, counted by the
// calling block's first threads.
__device__ __forceinline__ void count_tail(uint32_t* mine, const uint8_t* data,
                                           int64_t valid_len) {
  const int64_t nvec = valid_len / 16;
  if (threadIdx.x < (valid_len & 15)) atomicAdd(&mine[data[nvec * 16 + threadIdx.x] * kLanes], 1u);
}

// After every count of the block: fold the 32 lane copies into row[0..255].
// Four threads a bin, each summing 8 lanes' copies (rotated by the bin, so
// that a warp's reads fall on 32 banks), then across the four.
__device__ __forceinline__ void fold_lane_bins(const uint32_t* bins, int* __restrict__ row) {
  __syncthreads();
  const int bin = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += bins[bin * kLanes + part * 8 + ((k + bin) & 7)];
  s += __shfl_xor_sync(kFull, s, 1);
  s += __shfl_xor_sync(kFull, s, 2);
  if (part == 0) row[bin] = (int)s;
}

// hist[y * 256 + b] = sum of partial[r * 256 + b] over the rows r of chunk
// y = blockIdx.y, runs.v[y] <= r < runs.v[y + 1] (one chunk: rows 0 ..
// rows - 1).  Block k takes bins 32k .. 32k+31; its 32 warps take every 32nd
// row (about four each, all loads in flight), each lane a bin.
__global__ void __launch_bounds__(kLanes * kSumGroups)
histogram_sum_kernel(const int* __restrict__ partial, RowValues runs, int* __restrict__ hist) {
  __shared__ int group_s[kSumGroups][kLanes];
  const int lane = threadIdx.x & (kLanes - 1);
  const int group = threadIdx.x / kLanes;
  const int bin = blockIdx.x * kLanes + lane;
  const int64_t first = runs.v[blockIdx.y], end = runs.v[blockIdx.y + 1];
  hist += (int64_t)blockIdx.y * kBins;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // every row written and visible
  int s = 0;
#pragma unroll 8
  for (int64_t r = first + group; r < end; r += kSumGroups) s += partial[r * kBins + bin];
  group_s[group][lane] = s;
  __syncthreads();
  if (group == 0) {
#pragma unroll
    for (int g = 1; g < kSumGroups; ++g) s += group_s[g][lane];
    hist[bin] = s;
  }
}

// Launch histogram_sum_kernel for `batch` chunks, chunk y's rows of
// `partial` at runs.v[y] .. runs.v[y + 1], on `stream`, right after a
// counting kernel that executed griddepcontrol.launch_dependents: a
// programmatic dependent launch, which starts at once and waits inside on
// the counting kernel's completion, so that its launch overlaps the counting.
inline int launch_histogram_sum(const int* partial, const RowValues& runs, int batch, int* hist,
                                cudaStream_t stream) {
  const cudaError_t err = cudaGetLastError();  // the counting kernel's launch
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t sum = {};
  sum.gridDim = dim3(kSumBlocks, batch);
  sum.blockDim = dim3(kLanes * kSumGroups);
  sum.stream = stream;
  sum.attrs = &early;
  sum.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&sum, histogram_sum_kernel, partial, runs, hist);
}

// The same for one chunk of `rows` rows.
inline int launch_histogram_sum(const int* partial, int rows, int* hist, cudaStream_t stream) {
  RowValues runs = {};
  runs.v[1] = rows;
  return launch_histogram_sum(partial, runs, 1, hist, stream);
}

}  // namespace
