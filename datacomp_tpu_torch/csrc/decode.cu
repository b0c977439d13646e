// K3: gap-array canonical-Huffman decode (format v2).  Sub-block i enters the
// stream at bit gaps[i] and yields `subblock` symbols; the output stops at
// n_out, so the last sub-block may be short.  One launch decodes a batch of
// chunks.
//
// Replaces datacomp_tpu/ops/decode.py::decode_device, an XLA op, and its
// vmapped form (tpu_service.py::_batched_decoder).  The TPU
// version is shaped by the TPU's lack of a vector gather: code lengths by
// broadcast compares, the symbol by a one-hot matmul, and W-word row refills
// to amortise the one gather it keeps.  On Hopper the tables sit in shared
// memory and a refill is an ordinary load.
//
// What bounds it on the H100: the instructions of the decode steps, not
// bytes.  A 16 MiB chunk has only about 4.2k sub-blocks: one thread a
// sub-block would be about one warp an SM, each thread a chain of 4032
// dependent steps.  So a WARP takes a sub-block and its 32 lanes split the
// sub-block's bit range: the chain is about subblock / 32 symbols a lane (126
// at the default), twice (a counting pass and a writing pass), plus the
// synchronisation rounds, all from shared memory, and some 20 warps an SM
// share the issue slots; each step costs a few tens of instructions (the
// window, the table read, the refill and the bitmap's bookkeeping, with
// divergent branches).  The worst case is a stream that never
// resynchronises: about 31 rounds of a whole segment, the serial depth of one
// thread a sub-block again, but from shared memory.
//
// Design (after Weissenberger & Schmidt, "Massively Parallel Huffman Decoding
// on GPUs", ICPP 2018):
//   * Span.  Sub-block i covers bits [lo, hi): lo = gaps[i], hi = gaps[i+1]
//     (the stream's end for the last), both clamped into the stream, hi >= lo,
//     and hi <= lo + maxlen * count (count = its symbols, maxlen = the deepest
//     length in use), which a valid sub-block always meets.
//   * Lanes.  Lane k owns the codewords that START in [lo + k*seg,
//     lo + (k+1)*seg), seg = ceil(span / 32) rounded up to a multiple of
//     lcm(32, g), g the gcd of the code lengths in use (a length l is in use
//     where limits[l-1] != limits[l-2]).  Every true codeword start lies a
//     multiple of g past lo, so with a fixed-length code every lane's start
//     is exact; the multiple of 32 gives each lane whole words of the bitmap
//     below.
//   * Pass A.  Each lane decodes from its start s_k (lane 0's, lo, is a true
//     codeword start), counting the codewords that start in its range, and
//     records its exit q_k (the first codeword start past its range) and its
//     count c_k; it marks each codeword start it visits in a per-warp bitmap.
//   * Rounds.  Lane k+1 takes q_k (__shfl_up_sync); a lane whose start
//     changed decodes again, until __any_sync sees no change (lanes whose
//     range lies past the span never count as changed).  After round r
//     lanes 0..r are exact, so there are at most 31 rounds.  A lane stops
//     early when its new parse lands on a start its previous parse visited:
//     from there the two parses agree, so its exit stays and its count is
//     the new prefix plus the previous parse's starts from there on.
//   * Output.  An exclusive warp scan of c_k gives each lane's first output
//     index; each lane decodes its symbols once more and writes those below
//     count into a staging buffer in shared memory (the bitmap's storage),
//     zero-filling what a corrupt stream leaves short; the warp then copies
//     the sub-block out with 16-byte stores (byte stores where the sub-block
//     does not start 16-byte aligned, which a subblock that is a multiple of
//     16 never does).
//   * Stream in shared memory.  The warp first copies the sub-block's words
//     [lo/32, hi/32 + 3) into its buffer with coalesced loads.
//   * Table.  Each block builds a direct table of 2^T uint16 entries
//     (length << 8 | symbol; 0 for a code longer than T bits), T =
//     min(12, maxlen), from limits/adj/sym: a code of at most T bits resolves
//     with one shared-memory read.  Longer codes take the 16 compares against
//     `limits`, held in registers, as the plain version does; the table's
//     entries equal that formula for every window, so the two agree on any
//     stream.
//   * Routes.  A sub-block whose buffer needs at most kWarpWords (1024) words
//     and whose count fits the staging buffer (4096 bytes) takes the staged
//     route above: at the default 4032 symbols, every sub-block of at most
//     about 8.1 bits a symbol, which covers any chunk the codec does not store
//     raw unless its rate varies a lot within it.  Any other (a denser
//     sub-block, a larger subblock, or a span stretched by a corrupt gap
//     array) takes the direct route in the same kernel: the same lanes and
//     rounds, reading the stream from device memory with bounds checks,
//     without the bitmap (a round re-decodes the lane's whole range) and
//     writing bytes straight to `out`.  Buffers sized for the worst case of
//     4032 16-bit codes (2048 words) hold fewer warps an SM and ran slower
//     on the H100 (PERF.md).
//   * Grid.  Persistent: as many blocks as fit on the card at once, each
//     warp walking sub-blocks i, i + warps in its row's run, ...; so each
//     block builds its table once.
//   * Statistics.  With `stats` (int64[2]) given, each warp adds its
//     sub-blocks and its sync rounds with one atomicAdd each, summed over
//     the batch.
//   * Batch.  The chunks (rows) of a batch: their words, gap arrays and
//     outputs lie concatenated, at offsets among the launch's parameters
//     (rows.cuh), and their tables are rows of limits, adj and sym.  The
//     flat grid is cut into a run of blocks for each row, the resident
//     blocks shared out in proportion to the rows' sub-blocks; a block
//     builds its row's direct table once and walks the row's sub-blocks.  A
//     row's stream is only its own words: stream_bits and the direct
//     route's bounds are the row's, so a short or corrupt row never reads its
//     neighbour.  One chunk is a batch of one.  The JAX service groups a
//     batch by its static decode parameters; here every row reads its own
//     tables at run time, so rows of any depth up to 16 mix.
// Codes must be at most 16 bits (the wrapper's caller routes deeper codebooks
// to the host decoder).  A corrupt stream decodes to garbage, never out of
// bounds, and always yields n_out bytes; the chunk's SHA-256 catches it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"
#include "decode_core.cuh"

namespace {

// kWarps and kWarpWords were chosen on the H100 (PERF.md): 2, 4 or 8
// warps a block decode at the same speed; 2048-word buffers ran 30 % slower.
constexpr int kWarps = 4;            // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpWords = 1024;     // a warp's stream buffer and bitmap, in words

struct __align__(16) Smem {
  uint32_t bitmap[kWarps][kWarpWords];  // also the output staging buffer
  uint32_t stream[kWarps][kWarpWords];
  uint16_t table[1 << kMaxDirectBits];
  int adj[kCodeBits];
  uint8_t sym[256];
};

// One sub-block by one warp: pass A, the rounds, the scan and the writing
// pass into dst[0, count).  bm is the warp's bitmap (staged route only).
// Returns the rounds taken.
template <class Src, bool kStaged, class Pos = typename Src::Pos>
__device__ __forceinline__ int decode_subblock(Src src, Decoder dec, Pos lo, Pos hi, Pos seg,
                                               int count, uint32_t* bm, uint8_t* dst) {
  const int lane = threadIdx.x & 31;
  const Pos b = lo + lane * seg;
  const Pos e = b + seg < hi ? b + seg : hi;
  const int bw0 = (int)((lane * seg) >> 5);
  const int bw1 = e > b ? (int)((e - lo + 31) >> 5) : bw0;

  Pos s = b;
  Pass<Pos> a = count_pass<Src, kStaged>(src, dec, s, e, lo, bm, bw0, bw1, false, Pos(0), 0);
  int rounds = 0;
  for (int r = 0; r < 32; ++r) {  // at most 31 rounds change a start
    Pos s_new = __shfl_up_sync(kFull, a.q, 1);
    if (lane == 0) s_new = s;
    const bool changed = s_new != s && e > b;  // a lane past the span decodes nothing
    if (!__any_sync(kFull, changed)) break;
    ++rounds;
    if (changed) {
      s = s_new;
      a = count_pass<Src, kStaged>(src, dec, s, e, lo, bm, bw0, bw1, true, a.q, a.c);
    }
  }

  int off = a.c;  // inclusive scan of the counts
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, off, o);
    if (lane >= o) off += y;
  }
  const int total = __shfl_sync(kFull, off, 31);
  off -= a.c;
  __syncwarp();  // the bitmap is done with: dst may be its storage

  const int n = a.c < count - off ? a.c : count - off;
  if (n > 0) {
    Reader<Src> r(src, s);
    for (int j = 0; j < n; ++j) {
      int sym;
      const int len = dec.decode(r.window(), &sym);
      dst[off + j] = (uint8_t)sym;
      r.advance(len);
    }
  }
  for (int j = total + lane; j < count; j += 32) dst[j] = 0;  // a short (corrupt) stream
  __syncwarp();
  return rounds;
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint32_t* __restrict__ words, RowValues word_off,
              const uint32_t* __restrict__ gaps, RowValues sub_off,
              const int* __restrict__ limits, const int* __restrict__ adj,
              const int* __restrict__ sym, int subblock, RowValues out_off, RowValues runs,
              uint8_t* __restrict__ out, unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = row_of_block(runs, blockIdx.x);
  const int64_t block = blockIdx.x - runs.v[row];  // in the row's run
  const int64_t blocks = runs.v[row + 1] - runs.v[row];
  words += word_off.v[row];
  const int64_t nwords = word_off.v[row + 1] - word_off.v[row];
  gaps += sub_off.v[row];
  const int64_t nsub = sub_off.v[row + 1] - sub_off.v[row];
  out += out_off.v[row];
  const int64_t n_out = out_off.v[row + 1] - out_off.v[row];
  limits += row * kCodeBits;
  adj += row * kCodeBits;
  sym += row * 256;

  int maxlen, g;
  const Decoder dec = make_decoder<kThreads>(limits, adj, sym, sm.table, sm.adj, sm.sym,
                                             &maxlen, &g);
  __syncthreads();

  const int unit = 32 * g / gcd(32, g);  // lcm(32, g)
  const int64_t stream_bits = 32 * nwords;
  uint32_t* buf = sm.stream[warp];
  uint32_t* bm = sm.bitmap[warp];
  uint8_t* stage = reinterpret_cast<uint8_t*>(bm);
  unsigned long long subs = 0, rounds = 0;

  for (int64_t i = block * kWarps + warp; i < nsub; i += blocks * kWarps) {
    const int64_t first = i * subblock;
    if (first >= n_out) break;
    const int count = (int)(n_out - first < subblock ? n_out - first : subblock);
    int64_t lo = gaps[i];
    lo = lo < stream_bits ? lo : stream_bits;
    int64_t hi = i + 1 < nsub ? (int64_t)gaps[i + 1] : stream_bits;
    hi = hi < lo ? lo : (hi > stream_bits ? stream_bits : hi);
    hi = hi < lo + (int64_t)maxlen * count ? hi : lo + (int64_t)maxlen * count;
    const int64_t per_lane = (hi - lo + 31) / 32;
    const int64_t seg = (per_lane > 0 ? (per_lane + unit - 1) / unit : 1) * unit;
    const int64_t base = lo >> 5;
    const int64_t nbuf = (hi >> 5) + 3 - base;

    int r;
    if (nbuf <= kWarpWords && count <= 4 * kWarpWords) {
#pragma unroll 8
      for (int j = lane; j < nbuf; j += 32) {
        buf[j] = base + j < nwords ? __ldg(words + base + j) : 0u;
      }
      __syncwarp();
      // positions count from the first staged word
      r = decode_subblock<SmemStream, true>(SmemStream{buf}, dec, (int)(lo - (base << 5)),
                                            (int)(hi - (base << 5)), (int)seg, count, bm,
                                            stage);
      uint8_t* o = out + first;
      if ((reinterpret_cast<uintptr_t>(o) & 15) == 0) {
        const int nv = count >> 4;
        for (int j = lane; j < nv; j += 32) {
          reinterpret_cast<uint4*>(o)[j] = reinterpret_cast<const uint4*>(stage)[j];
        }
        for (int j = (nv << 4) + lane; j < count; j += 32) o[j] = stage[j];
      } else {
        for (int j = lane; j < count; j += 32) o[j] = stage[j];
      }
      __syncwarp();  // the buffers are free for the next sub-block
    } else {
      r = decode_subblock<GlobalStream, false>(GlobalStream{words, nwords}, dec, lo, hi, seg,
                                               count, nullptr, out + first);
    }
    ++subs;
    rounds += r;
  }
  if (stats && lane == 0 && subs) {
    atomicAdd(&stats[0], subs);
    atomicAdd(&stats[1], rounds);
  }
}

}  // namespace

// words: uint32[word_off[rows]], row r's stream at [word_off[r],
// word_off[r + 1]); gaps: uint32[sub_off[rows]], likewise; limits, adj:
// int32[rows][16]; sym: int32[rows][256]; out: uint8[out_off[rows]], row r's
// n_out = out_off[r + 1] - out_off[r] <= its sub-blocks x subblock bytes at
// out_off[r]; the offsets: int64[rows + 1] on the host; rows: 1 ..
// kMaxRows; stats: int64[2] (sub-blocks decoded, sync rounds taken; added
// to) or null.
extern "C" int dcz_decode(const void* words, const int64_t* word_off, const void* gaps,
                          const int64_t* sub_off, const void* limits, const void* adj,
                          const void* sym, int rows, int subblock, const int64_t* out_off,
                          void* out, void* stats, void* stream) {
  int64_t need[kMaxRows], busy = 0;  // blocks each row can use
  for (int r = 0; r < rows; ++r) {
    const int64_t n_out = out_off[r + 1] - out_off[r];
    const int64_t nsub = sub_off[r + 1] - sub_off[r];
    const int64_t live = (n_out + subblock - 1) / subblock;  // sub-blocks with output
    need[r] = ((live < nsub ? live : nsub) + kWarps - 1) / kWarps;
    busy += need[r];
  }
  if (busy <= 0) return (int)cudaGetLastError();
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t resident = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  const RowValues runs = block_runs(need, rows, resident);  // the rows share the card
  decode_kernel<<<(unsigned)runs.v[rows], kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(words), row_values(word_off, rows + 1),
      static_cast<const uint32_t*>(gaps), row_values(sub_off, rows + 1),
      static_cast<const int*>(limits), static_cast<const int*>(adj),
      static_cast<const int*>(sym), subblock, row_values(out_off, rows + 1), runs,
      static_cast<uint8_t*>(out), static_cast<unsigned long long*>(stats));
  return (int)cudaGetLastError();
}
