// K2: canonical-Huffman encode of data[:valid_len] into an MSB-first stream
// of uint32 words (bit 31 of word 0 is the first bit), plus the start bit of
// every `subblock`-th symbol (the format-v2 gap array).
//
// Replaces datacomp_tpu/ops/encode_merge.py::encode_device_merge, an XLA op.
// The TPU version is shaped by the TPU's slow gathers and scatters: one-hot
// matmul table lookups, a five-level bitstream merge tree, a matmul prefix
// sum and an ownership scatter.  None of that is carried over: Hopper reads
// a 256-entry table from shared memory in one instruction and has atomics
// on device memory.
//
// What bounds it on the H100: per symbol, one shared-memory lookup, a step
// of a block-wide scan and an OR into the output; the bytes moved are small
// (n in, about n*L/8 out).  The atomics on device memory are the cost to
// keep low.
//
// Design: tiles of kTile = 4096 symbols, 256 threads x 16 consecutive
// symbols, each thread's 16 bytes read with one 16-byte load.  Two launches:
//   1. dcz_encode_block_sums: each tile's sum of code lengths;
//   2. (the wrapper takes the int64 exclusive cumsum of those sums on the
//      stream: each tile's start bit) dcz_encode_write: a block-local
//      exclusive scan of the per-thread sums gives each thread its start bit;
//      the thread then walks its 16 symbols, ORs each left-aligned code
//      v = (u64)code << (64 - L - (off & 31)) into a register that holds the
//      current output word, and issues an atomicOr only when it moves on to
//      another word.  So there is about one atomic per 32 output bits, and
//      the atomics resolve the words that two threads share.
// Writes at or beyond out_words are dropped (the wrapper's caller raises
// when the total exceeds the capacity).  Codes must be at most 32 bits; a
// longer one still moves the bit offsets by its length and stays within the
// bounds checks, but its bits are wrong.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSymsPerThread = 16;
constexpr int kTile = kThreads * kSymsPerThread;

__device__ __forceinline__ int byte_at(const uint4& q, int k) {
  const uint32_t w = k < 4 ? q.x : k < 8 ? q.y : k < 12 ? q.z : q.w;
  return (w >> (8 * (k & 3))) & 0xFF;
}

// The thread's 16 symbols (zeros past n; n is a multiple of 16).
__device__ __forceinline__ uint4 load_syms(const uint8_t* data, int64_t base,
                                           int64_t n) {
  return base < n ? *reinterpret_cast<const uint4*>(data + base)
                  : make_uint4(0, 0, 0, 0);
}

// Exclusive scan of one int per thread over the block; *total gets the sum.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  *total = warp_sums[kWarps - 1];
  return (warp ? warp_sums[warp - 1] : 0) + x - v;
}

__global__ void __launch_bounds__(kThreads)
block_sums_kernel(const uint8_t* __restrict__ data, int64_t n, int64_t valid_len,
                  const int* __restrict__ lengths, int64_t* __restrict__ sums) {
  __shared__ int len_s[256];
  len_s[threadIdx.x] = lengths[threadIdx.x];  // kThreads == 256
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x * kSymsPerThread;
  const uint4 q = load_syms(data, base, n);
  int s = 0;
#pragma unroll
  for (int k = 0; k < kSymsPerThread; ++k) {
    s += base + k < valid_len ? len_s[byte_at(q, k)] : 0;
  }
  int total;
  block_exclusive_scan(s, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__device__ __forceinline__ void flush(uint32_t* words, int64_t out_words,
                                      int64_t idx, uint32_t bits) {
  if (bits && idx >= 0 && idx < out_words) atomicOr(&words[idx], bits);
}

__global__ void __launch_bounds__(kThreads)
write_kernel(const uint8_t* __restrict__ data, int64_t n, int64_t valid_len,
             const int* __restrict__ lengths, const uint32_t* __restrict__ codes,
             const int64_t* __restrict__ tile_start, uint32_t* __restrict__ words,
             int64_t out_words, uint32_t* __restrict__ gaps, int subblock) {
  __shared__ int len_s[256];
  __shared__ uint32_t code_s[256];
  len_s[threadIdx.x] = lengths[threadIdx.x];
  code_s[threadIdx.x] = codes[threadIdx.x];
  __syncthreads();

  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x * kSymsPerThread;
  const uint4 q = load_syms(data, base, n);
  int len[kSymsPerThread];
  int s = 0;
#pragma unroll
  for (int k = 0; k < kSymsPerThread; ++k) {
    len[k] = base + k < valid_len ? len_s[byte_at(q, k)] : 0;
    s += len[k];
  }
  int total;
  int64_t off = tile_start[blockIdx.x] + block_exclusive_scan(s, &total);

  // at most one sub-block starts among the thread's 16 symbols (subblock >= 32)
  int gap_k = kSymsPerThread;
  if (subblock > 0 && base < n) {
    gap_k = (int)((subblock - base % subblock) % subblock);
  }

  int64_t cur = -1;  // output word held in `acc`
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < kSymsPerThread; ++k) {
    if (k == gap_k) gaps[(base + k) / subblock] = (uint32_t)off;
    const int l = len[k];
    if (l) {
      const int64_t wi = off >> 5;
      // a code of more than 32 bits (a codebook the codec refuses) may need
      // a negative shift: it writes nothing, so that no shift is undefined
      const int sh = 64 - l - (int)(off & 31);
      const uint64_t v = sh >= 0 ? (uint64_t)code_s[byte_at(q, k)] << sh : 0;
      if (wi != cur) {
        flush(words, out_words, cur, acc);
        cur = wi;
        acc = 0;
      }
      acc |= (uint32_t)(v >> 32);
      const uint32_t lo = (uint32_t)v;  // the part that spills into word wi + 1
      if (lo) {
        flush(words, out_words, cur, acc);
        cur = wi + 1;
        acc = lo;
      }
      off += l;
    }
  }
  flush(words, out_words, cur, acc);
}

}  // namespace

// Symbols per tile: the wrapper sizes `sums` and `tile_start` with it.
extern "C" int dcz_encode_tile_symbols() { return kTile; }

// data: uint8[n], n % 16 == 0, 16-byte aligned; lengths: int32[256];
// sums: int64[ceil(n / kTile)].
extern "C" int dcz_encode_block_sums(const void* data, int64_t n, int64_t valid_len,
                                     const void* lengths, void* sums, void* stream) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles > 0) {
    block_sums_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint8_t*>(data), n, valid_len,
        static_cast<const int*>(lengths), static_cast<int64_t*>(sums));
  }
  return (int)cudaGetLastError();
}

// codes: uint32[256]; tile_start: int64[tiles], the exclusive cumsum of sums;
// words: uint32[out_words], zeroed; gaps: uint32[ceil(n / subblock)], or
// unused when subblock == 0 (subblock is otherwise a multiple of 32).
extern "C" int dcz_encode_write(const void* data, int64_t n, int64_t valid_len,
                                const void* lengths, const void* codes,
                                const void* tile_start, void* words, int64_t out_words,
                                void* gaps, int subblock, void* stream) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles > 0) {
    write_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint8_t*>(data), n, valid_len,
        static_cast<const int*>(lengths), static_cast<const uint32_t*>(codes),
        static_cast<const int64_t*>(tile_start), static_cast<uint32_t*>(words),
        out_words, static_cast<uint32_t*>(gaps), subblock);
  }
  return (int)cudaGetLastError();
}
