// K1: 256-bin byte histogram of data[:valid_len], for each chunk of a batch.
//
// Replaces datacomp_tpu/ops/histogram_pallas.py::_hist_kernel (wrapper
// histogram_pallas), and its vmapped form in the JAX service's batched
// pipeline (tpu_service.py::_batched_pipeline), which prepends a batch axis
// to the Pallas grid.  The TPU kernel contracts packed-8 one-hots on the MXU
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
// The counting core and the summing kernel live in histogram_core.cuh, which
// K1p (histogram_variants.cu) shares; K1s shares the summing kernel.
//
// Batch: the chunks are rows of data, row_stride bytes apart, each with its
// own valid_len among the launch's parameters (rows.cuh).  The flat grid is
// cut into a run of blocks for each chunk, the SMs shared out in proportion
// to the chunks' lengths (about one block an SM in all, at least one a chunk,
// which writes its zeros when it is empty); block b writes row b of the
// scratch, so that a chunk's rows lie together, and the summing kernel,
// with a batch axis, adds each chunk's run of rows into hist[chunk].  One
// chunk is a batch of one.

#include "histogram_core.cuh"
#include "rows.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
histogram_kernel(const uint8_t* __restrict__ data, int64_t row_stride, RowValues valid_lens,
                 RowValues runs, int* __restrict__ partial) {
  __shared__ uint32_t bins[kBins * kLanes];
  asm volatile("griddepcontrol.launch_dependents;");  // the summing kernel may start
  const int row = row_of_block(runs, blockIdx.x);
  const int64_t block = blockIdx.x - runs.v[row];  // in the chunk's run
  const int64_t valid_len = valid_lens.v[row];
  data += row * row_stride;
  uint32_t* mine = lane_bins_init(bins);
  const int64_t stride = (runs.v[row + 1] - runs.v[row]) * kThreads;
  count_vectors(mine, reinterpret_cast<const uint4*>(data), block * kThreads + threadIdx.x,
                valid_len / 16, stride);
  if (block == 0) count_tail(mine, data, valid_len);
  fold_lane_bins(bins, partial + (int64_t)blockIdx.x * kBins);
}

}  // namespace

// data: uint8[rows][row_stride], 16-byte aligned, row_stride a multiple of
// 16; valid_lens: int64[rows] on the host, each <= row_stride; rows: 1 ..
// kMaxRows; hist: int32[rows][256], written whole; partial: int32[(max_blocks
// + rows) * 256] scratch, one row a block of the first kernel (max_blocks:
// the blocks to share out, the SM count).
extern "C" int dcz_histogram(const void* data, int64_t row_stride, const int64_t* valid_lens,
                             int rows, void* hist, void* partial, int max_blocks,
                             void* stream) {
  int64_t need[kMaxRows];  // blocks a chunk can use: at least one, to write its zeros
  for (int r = 0; r < rows; ++r) {
    const int64_t nvec = (valid_lens[r] + 15) / 16;
    need[r] = (nvec + kThreads - 1) / kThreads;
    need[r] = need[r] > 0 ? need[r] : 1;
  }
  const RowValues runs = block_runs(need, rows, max_blocks);
  cudaStream_t s = (cudaStream_t)stream;
  histogram_kernel<<<(unsigned)runs.v[rows], kThreads, 0, s>>>(
      static_cast<const uint8_t*>(data), row_stride, row_values(valid_lens, rows), runs,
      static_cast<int*>(partial));
  return launch_histogram_sum(static_cast<const int*>(partial), runs, rows,
                              static_cast<int*>(hist), s);
}

// Message for a code returned by any dcz_* entry point (all sources link
// into one library, so it is defined once, here).
extern "C" const char* dcz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
