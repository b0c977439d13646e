// K2: canonical-Huffman encode of data[:valid_len] into an MSB-first stream
// of uint32 words (bit 31 of word 0 is the first bit), plus the start bit of
// every `subblock`-th symbol (the format-v2 gap array), for each chunk of a
// batch.
//
// Replaces datacomp_tpu/ops/encode_merge.py::encode_device_merge, an XLA op,
// and its vmapped forms (encode_device_merge_batch_slotted, and the vmap of
// the JAX service's batched pipeline with host tables).
// The TPU version is shaped by the TPU's slow gathers and scatters: one-hot
// matmul table lookups, a five-level bitstream merge tree, a matmul prefix
// sum and an ownership scatter.  None of that is carried over: Hopper reads
// a 256-entry table from shared memory in one instruction and has atomics
// on device and shared memory.
//
// What bounds it on the H100: not the bytes (the chunk read once and about
// n*L/8 bytes of live words written once would take some 8 us at 16 MiB),
// but instructions and latency: most of all the per-thread packing loop (a
// serial chain of shifts and ORs a symbol), then each tile's load, scan and
// barriers, and least the tiles' look-back chain and the ticket.  The
// wrapper's zero-fill of the word capacity (9n/32 words) is the only other
// device operation of a call.  What the design does: one launch and one read
// of the chunk, and no device-memory atomics inside a tile's words.
//
// Design: one launch, a single-pass scan with decoupled look-back over tiles
// of kTile = 8192 symbols (256 threads x 32 consecutive symbols, each
// thread's 32 bytes read with two 16-byte loads):
//   1. A block takes its tile index from an atomic ticket, so that every
//      tile before it is already running.  A block-wide scan of the code
//      lengths gives each thread its bit offset inside the tile and the
//      tile's sum.
//   2. Warp 0 publishes the tile's sum (flag A) in a status array the wrapper
//      zeroes, then looks back over its 32 nearest predecessors at a time,
//      adding sums until it meets an inclusive prefix (flag P), and publishes
//      its own inclusive prefix.  The last tile writes total_bits.
//   3. Each thread packs its codes into the tile's words in shared memory
//      through a 64-bit accumulator: a finished word that lies inside the
//      thread's bit range is a plain store; only its first and last words,
//      which it may share with its neighbours, take a shared-memory atomicOr.
//   4. The block stores the words it alone owns with coalesced plain
//      stores; only its first and last words, which it may share with its
//      neighbouring tiles, go to device memory by atomicOr: at most 2 device
//      atomics a tile.
// Gap bits are written by the thread that holds every `subblock`-th symbol.
// Batch: the chunks are rows of data, each with its own valid_len (in the
// launch's parameters, rows.cuh), codebook, words (out_words each), gaps,
// total and tile statuses.  One ticket runs over rows x tiles, row-major:
// ticket k is tile k % tiles of row k / tiles.  A tile's look-back reads only
// its own row's statuses, and every tile it waits on holds an earlier ticket,
// so is already running: the forward-progress argument of the single scan
// holds row by row.  A batched block learns its row from its ticket, so it
// loads its codebook after the ticket (one more barrier); one chunk is a
// batch of one, instantiated without that step, which loads its codebook
// beside the ticket: the batched instantiation at one row took 5.8-7.2 %
// more device time (PERF.md).
// Writes at or beyond out_words are dropped (the wrapper's caller raises when
// the total exceeds the capacity).  Codes must be at most 32 bits; a longer
// one still moves the bit offsets by its length and writes nothing, so the
// total and the gap bits are right and every access stays in bounds, but the
// stream's bits are wrong (and words past the tile's shared-memory buffer
// stay zero).

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// 32 symbols a thread ran 13 % faster than 16 on the H100 (PERF.md)
constexpr int kSymsPerThread = 32;
constexpr int kVecs = kSymsPerThread / 16;  // 16-byte loads a thread
constexpr int kTile = kThreads * kSymsPerThread;
// a tile's words: 32-bit codes at most, plus the start's offset in its word
constexpr int kTileWords = kTile + 2;

// tile status: a flag in the top two bits, a bit count below
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kValue = (1ull << 62) - 1;

__device__ __forceinline__ int byte_at(const uint4* q, int k) {
  const uint4& v = q[k >> 4];
  k &= 15;
  const uint32_t w = k < 4 ? v.x : k < 8 ? v.y : k < 12 ? v.z : v.w;
  return (w >> (8 * (k & 3))) & 0xFF;
}

// Exclusive scan of one int per thread over the block; *total gets the sum.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  *total = warp_sums[kWarps - 1];
  return (warp ? warp_sums[warp - 1] : 0) + x - v;
}

__device__ __forceinline__ void publish(unsigned long long* status, int64_t t,
                                        unsigned long long v) {
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(status + t) = v;
}

// Called by warp 0 alone: the bits of all tiles before tile t.
__device__ int64_t look_back(unsigned long long* status, int64_t t, int64_t sum) {
  const int lane = threadIdx.x & 31;
  if (t == 0) {
    if (lane == 0) publish(status, 0, kPrefix | (unsigned long long)sum);
    return 0;
  }
  if (lane == 0) publish(status, t, kAggregate | (unsigned long long)sum);
  int64_t excl = 0;
  for (int64_t j = t - 1 - lane;; j -= 32) {  // lane l: tile t - 1 - l, then 32 back
    unsigned long long v;
    do {  // a tile before t has its ticket, so it publishes soon
      v = kPrefix;  // before the first tile: an inclusive prefix of 0
      if (j >= 0) v = *reinterpret_cast<volatile unsigned long long*>(status + j);
    } while (!__all_sync(kFull, (v >> 62) != 0));
    const unsigned prefixes = __ballot_sync(kFull, (v >> 62) == 2);
    // the lanes up to the nearest inclusive prefix contribute
    int64_t x = prefixes == 0 || lane < __ffs(prefixes) ? (int64_t)(v & kValue) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
    excl += x;
    if (prefixes) break;
  }
  if (lane == 0) publish(status, t, kPrefix | (unsigned long long)(excl + sum));
  return excl;
}

// n < 2^27 (the wrapper's check), so symbol indices are 32-bit.
template <bool kBatch>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const uint8_t* __restrict__ data, int n, RowValues valid_lens,
              const int* __restrict__ lengths, const uint32_t* __restrict__ codes,
              uint32_t* __restrict__ words, int64_t out_words, uint32_t* __restrict__ gaps,
              int subblock, unsigned long long* __restrict__ ws, int rows, int tiles) {
  __shared__ uint2 entry_s[256];  // (code, length)
  __shared__ uint32_t buf[kTileWords];
  __shared__ int64_t start_s;
  __shared__ int tile_s;
  if (threadIdx.x == 0) tile_s = (int)atomicAdd(&ws[0], 1ull);
  if (!kBatch) entry_s[threadIdx.x] = make_uint2(codes[threadIdx.x], lengths[threadIdx.x]);
  __syncthreads();

  const int row = kBatch ? tile_s / tiles : 0;
  const int t = tile_s - row * tiles;
  if (kBatch) {  // 256 threads: the row's codebook
    entry_s[threadIdx.x] = make_uint2(codes[row * 256 + threadIdx.x],
                                      lengths[row * 256 + threadIdx.x]);
    __syncthreads();
  }
  const int valid_len = (int)valid_lens.v[row];
  data += (int64_t)row * n;
  words += row * out_words;
  if (subblock > 0) gaps += (int64_t)row * ((n + subblock - 1) / subblock);
  unsigned long long* status = ws + 1 + rows + (int64_t)row * tiles;
  const int base = t * kTile + threadIdx.x * kSymsPerThread;
  uint4 q[kVecs];  // the thread's symbols (zeros past n; n is a multiple of 32)
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    q[i] = base < n ? reinterpret_cast<const uint4*>(data + base)[i] : make_uint4(0, 0, 0, 0);
  }
  const int live = min(max(valid_len - base, 0), kSymsPerThread);  // symbols before valid_len
  // at most one sub-block starts among the thread's symbols (subblock >= 32)
  const int gap_k = subblock > 0 && base < n ? (subblock - base % subblock) % subblock
                                             : kSymsPerThread;
  int s = 0, gap_bits = 0;  // the thread's bits, and those before its gap symbol
  bool plain = true;         // every code of the thread has 1 to 32 bits
#pragma unroll
  for (int k = 0; k < kSymsPerThread; ++k) {
    if (k == gap_k) gap_bits = s;
    const int l = k < live ? (int)entry_s[byte_at(q, k)].y : 0;
    plain &= k >= live || (unsigned)(l - 1) < 32u;
    s += l;
  }
  int sum;
  const int excl = block_exclusive_scan(s, &sum);
  // the words the tile may touch: its bits, after up to 31 of the word before
  const int nzero = (sum + 62) / 32 < kTileWords ? (sum + 62) / 32 : kTileWords;
  for (int j = threadIdx.x; j < nzero; j += kThreads) buf[j] = 0;
  if (threadIdx.x < 32) {
    const int64_t start = look_back(status, t, sum);
    if (threadIdx.x == 0) {
      start_s = start;
      if (t == tiles - 1) ws[1 + row] = (unsigned long long)(start + sum);  // total_bits
    }
  }
  __syncthreads();

  const int64_t start = start_s;
  const int shift = (int)(start & 31);
  if (gap_k < kSymsPerThread) gaps[(base + gap_k) / subblock] = (uint32_t)(start + excl + gap_bits);

  // pack: acc holds the current word's bits left-aligned, nb of them used
  // (those before the thread's first bit belong to its predecessor); the
  // thread's first word may be shared with the thread before, so it takes
  // an atomicOr, and the words after it are the thread's alone
  const int rel = shift + excl;  // the thread's first bit, from the tile's first word
  int w = rel >> 5;
  int nb = rel & 31;
  const int first = w;
  uint64_t acc = 0;
  if (plain && rel + s <= 32 * kTileWords) {
    // codes of 1 to 32 bits, all inside the buffer: nb < 32 before a code,
    // so at most one word finishes a code
#pragma unroll
    for (int k = 0; k < kSymsPerThread; ++k) {
      if (k < live) {
        const uint2 e = entry_s[byte_at(q, k)];
        const int l = (int)e.y;
        acc |= (uint64_t)e.x << (64 - nb - l);
        nb += l;
        if (nb >= 32) {
          const uint32_t bits = (uint32_t)(acc >> 32);
          if (w != first) {
            buf[w] = bits;
          } else if (bits) {
            atomicOr(&buf[w], bits);
          }
          ++w;
          acc <<= 32;
          nb -= 32;
        }
      }
    }
  } else {
    // a codebook the codec refuses (a code of 0 or more than 32 bits): the
    // offsets still move by every length, a code of more than 32 bits
    // writes nothing (so that no shift is undefined), and nothing past the
    // buffer is written
#pragma unroll 1
    for (int k = 0; k < live; ++k) {
      const uint2 e = entry_s[data[base + k]];
      const int l = (int)e.y;
      if (l >= 1 && l <= 32) acc |= (uint64_t)e.x << (64 - nb - l);
      nb += l;
      for (; nb >= 32; nb -= 32, ++w, acc <<= 32) {
        const uint32_t bits = (uint32_t)(acc >> 32);
        if (w >= kTileWords) continue;
        if (w != first) {
          buf[w] = bits;
        } else if (bits) {
          atomicOr(&buf[w], bits);
        }
      }
    }
  }
  if (nb > 0 && w < kTileWords && (acc >> 32)) {
    atomicOr(&buf[w], (uint32_t)(acc >> 32));  // shared with the thread after
  }
  __syncthreads();

  if (sum == 0) return;
  const int nw = (shift + sum + 31) >> 5;  // the words the tile's bits touch
  const int nstore = nw < kTileWords ? nw : kTileWords;
  const int64_t first_word = start >> 5;
  for (int j = threadIdx.x; j < nstore; j += kThreads) {
    const int64_t g = first_word + j;
    if (g >= out_words) break;
    const uint32_t v = buf[j];
    if (j == 0 || j == nw - 1) {  // may be shared with a neighbouring tile
      if (v) atomicOr(&words[g], v);
    } else {
      words[g] = v;
    }
  }
}

}  // namespace

// Symbols per tile: the wrapper sizes the tile-status array with it.
extern "C" int dcz_encode_tile_symbols() { return kTile; }

// data: uint8[rows][n], n % 32 == 0, n < 2^27, 16-byte aligned; valid_lens:
// int64[rows] on the host, each <= n; rows: 1 .. kMaxRows; lengths:
// int32[rows][256]; codes: uint32[rows][256]; words: uint32[rows][out_words],
// zeroed; gaps: uint32[rows][ceil(n / subblock)], or unused when subblock ==
// 0 (subblock is otherwise a multiple of 32); ws: int64[1 + rows + rows *
// ceil(n / kTile)], zeroed: [0] the tile ticket, [1 + r] gets row r's
// total_bits, [1 + rows + r * tiles + t] tile t of row r's status.
extern "C" int dcz_encode(const void* data, int64_t n, const int64_t* valid_lens, int rows,
                          const void* lengths, const void* codes, void* words,
                          int64_t out_words, void* gaps, int subblock, void* ws,
                          void* stream) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles > 0) {
    auto kernel = rows > 1 ? encode_kernel<true> : encode_kernel<false>;
    kernel<<<(unsigned)(tiles * rows), kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint8_t*>(data), (int)n, row_values(valid_lens, rows),
        static_cast<const int*>(lengths), static_cast<const uint32_t*>(codes),
        static_cast<uint32_t*>(words), out_words, static_cast<uint32_t*>(gaps), subblock,
        static_cast<unsigned long long*>(ws), rows, (int)tiles);
  }
  return (int)cudaGetLastError();
}
