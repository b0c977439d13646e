// K5: the gap array of a format-1 chunk, found on the card.  Format 1 stores
// no gap array, so no symbol's position is known until the stream has been
// parsed from its start.  For each chunk of a batch, K5 finds the bit where
// every `subblock`-th symbol starts: exactly the gap array format 2 would
// have stored (ops/encode.py's starts[::subblock]).  It also finds the bit
// where symbol n_out would start, the decoded stream's end, which the caller
// holds to the payload's length.  K3 then decodes the chunk from that array,
// which never leaves the card.
//
// Replaces no kernel of the JAX package, which sends format 1 to the host
// decoder as the reference does; added so that format-1 restores run on the
// card.
//
// What bounds it on the H100: as for K3, the instructions of the decode
// steps, not bytes (the payload read once and 4 bytes a gap written take
// about 3 us at 3.35 TB/s for a 16 MiB chunk).  Every codeword is decoded
// about once, plus a short resynchronising walk a thread and the walk to
// each gap, each step a few tens of instructions on shared memory.
//
// Design (after Weissenberger & Schmidt, "Massively Parallel Huffman
// Decoding on GPUs", ICPP 2018: K3's lanes lifted from a warp to a block, and
// K2's single-pass scan with decoupled look-back across the blocks):
//   * Tiles.  A row's stream (its words, zeros past them) is cut into tiles
//     of kTileBits = 127 windows of kWindow = 512 bits.  A block of 128
//     threads takes a tile: thread i >= 1 owns the codewords that START in
//     window i - 1 of the tile; thread 0 parses the window just before the
//     tile (the margin) and owns nothing.  Blocks take tiles in the order of
//     an atomic ticket over rows x tiles, row-major, so every tile before a
//     block's is already running, and walk tickets until none is left
//     (persistent: a block builds a row's direct table once).  The tile's
//     words are staged in shared memory with coalesced loads.
//   * Speculative parse.  Each thread decodes from its window's first bit
//     that is a multiple of g (the gcd of the lengths in use: every true
//     codeword start is one), counting the codewords that start in its
//     window, recording its exit (the first codeword start past the window)
//     and marking the starts it visits in the tile's bitmap.
//   * Rounds.  Thread i + 1 takes thread i's exit as its start; a thread
//     whose start changed parses again, and stops where it lands on a start
//     its previous parse visited (the two parses agree from there), as K3's
//     lanes do; until no start changes, at most 127 rounds.  Thread 0's start
//     stays put, so the tile's parse is the one from the margin's first bit
//     and its exit X is the first start past the tile.  A tile publishes X at
//     once: it waited for nothing.
//   * Verification.  The tile reads its predecessor's X.  Where its own
//     parse enters the tile at that bit (thread 1's start), the two parses
//     agree: if the predecessor's X is true, so are this tile's parse, count
//     and X.  Else the tile parses again from the predecessor's X at once
//     (thread 1 until it meets its previous parse, then the rounds), without
//     waiting for anything more, so such tiles re-parse side by side; it
//     notes whether its exit stayed X.  Most Huffman codes resynchronise
//     within a few dozen bits; on dczbench's `binary` data (codes of 4 to
//     10 bits), 1.8 % of parses started at a random bit take more than the
//     margin's 512 bits, and some up to 17,000, so there some tiles re-parse.
//   * Look-back.  Each tile then publishes an aggregate (its count, and
//     whether it kept its X), and warp 0 looks back over its predecessors 32
//     at a time, as K2's tiles do, adding counts until it meets an inclusive
//     prefix (a true exit and the symbols before it).  The sum holds where
//     every aggregate on the way kept its X and the inclusive tile's true
//     exit is its X.  Else the tile waits for its predecessor's inclusive
//     prefix and, where that true exit is not its entry, parses again from
//     it: a chain, which only a stream that does not resynchronise within a
//     tile takes.  The tile then publishes its inclusive prefix.
//   * Output.  A block scan of the counts gives each thread the index of its
//     first codeword; a thread whose codewords include a multiple of
//     `subblock`, or n_out, walks to it and writes its bit.  Indices past
//     the stream's last codeword lie past the stream's end, where every
//     window is zeros and every code has the shortest length in use: the
//     row's last tile writes those bits.
//   * Bounds.  Every walk stops at its window's end and moves at least one
//     bit a step, the rounds are at most 127 and the chain follows the
//     tickets, so a stream that never resynchronises, or a corrupt one,
//     finishes (slowly), and nothing is written outside a row's gaps and
//     end.  Bit positions fit uint32 where 32 * words + 16 * n_out < 2^32
//     (the wrapper's check).
// Codes must be at most 16 bits, as for K3.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"
#include "decode_core.cuh"

namespace {

constexpr int kThreads = 128;                        // a block, one tile at a time
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 512;                         // a thread's window, in bits
constexpr int kTileBits = (kThreads - 1) * kWindow;  // the bits a tile owns
constexpr int kSpanWords = kThreads * kWindow / 32;  // the margin and the tile, in words
constexpr int kBufWords = kSpanWords + 3;            // and the words a walk reads past them

// A tile's status: a flag in the top two bits, whether the tile kept the
// exit it published first, and a count (an aggregate's codewords, or an
// inclusive prefix's symbols before its true exit).  An exit's word carries
// kPublished once it is written.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kKept = 1ull << 61;
constexpr unsigned long long kCount = kKept - 1;
constexpr unsigned long long kPublished = 1ull << 63;

struct __align__(16) Smem {
  uint32_t stream[kBufWords];  // bit 0 of word 0 is the margin's first bit
  uint32_t bitmap[kSpanWords];
  uint16_t table[1 << kMaxDirectBits];
  int adj[kCodeBits];
  uint8_t sym[256];
  int exits[kThreads];
  int warp_sums[kWarps];
  long long ticket, entry, before;  // the tile, an entry and the symbols before it
};

__device__ __forceinline__ unsigned long long load_volatile(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void publish(unsigned long long* p, unsigned long long v) {
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Exclusive scan of one int a thread over the block; *total gets the sum.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
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
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int y = warp_sums[w];
    if (w < warp) before += y;
    sum += y;
  }
  __syncthreads();  // warp_sums is free again
  *total = sum;
  return before + x - v;
}

// The rounds: thread i > first takes thread i - 1's exit as its start, and a
// thread whose start changed parses again until it meets its previous parse;
// until no start changes.  Afterwards exits[i] holds thread i's exit.
__device__ __forceinline__ void rounds(SmemStream src, Decoder dec, int first, int b, int e,
                                       int bw0, int bw1, uint32_t* bm, int* exits, int* s,
                                       Pass<int>* a) {
  const int i = threadIdx.x;
  for (int r = 0; r < kThreads; ++r) {  // at most 127 rounds change a start
    exits[i] = a->q;
    __syncthreads();
    const int s_new = i > first ? exits[i - 1] : *s;
    const bool changed = s_new != *s && e > b;  // a thread past the tile decodes nothing
    if (!__syncthreads_or(changed)) break;
    if (changed) {
      *s = s_new;
      *a = count_pass<SmemStream, true>(src, dec, *s, e, 0, bm, bw0, bw1, true, a->q, a->c);
    }
  }
}

// The tile's parse again from buffer bit `start` (in window 1, at most 15
// bits past the tile's first bit): thread 1 parses from there until it meets
// its previous parse, and the rounds carry the change on.
__device__ __forceinline__ void from_entry(SmemStream src, Decoder dec, long long start, int b,
                                           int e, int bw0, int bw1, uint32_t* bm, int* exits,
                                           int* s, Pass<int>* a) {
  if (threadIdx.x == 1) {
    *s = (int)start;
    *a = count_pass<SmemStream, true>(src, dec, *s, e, 0, bm, bw0, bw1, true, a->q, a->c);
  }
  rounds(src, dec, 1, b, e, bw0, bw1, bm, exits, s, a);
}

// Warp 0 of tile t (t >= 1, the row's tiles from status[0]): the tile's true
// entry (its predecessor's true exit) and the symbols before it, where the
// predecessor published exit x_prev.  The sum back to the nearest inclusive
// prefix holds where every aggregate on the way kept its published exit
// and the inclusive tile's true exit is its published one; else the tile
// waits for its predecessor's inclusive prefix.
__device__ void look_back(const unsigned long long* exits, const unsigned long long* status,
                          const unsigned long long* finals, int64_t t,
                          unsigned long long x_prev, long long* entry, long long* before) {
  const int lane = threadIdx.x & 31;
  long long sum = 0, e = (long long)x_prev;
  bool chained = true;
  for (int64_t j0 = t - 1;; j0 -= 32) {  // lane l: tile j0 - l
    const int64_t j = j0 - lane;
    unsigned long long v;
    do {  // a tile before t holds an earlier ticket, so it publishes soon
      v = j >= 0 ? load_volatile(status + j) : kInclusive;  // nothing before the row
    } while (!__all_sync(kFull, (v >> 62) != 0));
    const bool inclusive = (v >> 62) == 2;
    const unsigned stops = __ballot_sync(kFull, inclusive || !(v & kKept));
    const int stop = stops ? __ffs(stops) - 1 : 32;  // the nearest inclusive or moved tile
    long long x = lane <= stop ? (long long)(v & kCount) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
    sum += x;
    if (stops) {
      if (!__shfl_sync(kFull, inclusive, stop)) {
        chained = false;  // an aggregate whose exit moved
      } else if (j0 == t - 1 && stop == 0) {  // the predecessor's own true exit
        __threadfence();
        e = (long long)load_volatile(finals + t - 1);
      } else {  // the tiles after it parsed from its published exit
        bool same = false;
        if (lane == stop) {
          __threadfence();
          same = load_volatile(finals + j) == (load_volatile(exits + j) & ~kPublished);
        }
        chained = __shfl_sync(kFull, same, stop);
      }
      break;
    }
  }
  if (!chained) {
    unsigned long long v;
    do {
      v = load_volatile(status + t - 1);
    } while ((v >> 62) != 2);
    __threadfence();
    sum = (long long)(v & kCount);
    e = (long long)load_volatile(finals + t - 1);
  }
  *entry = e;
  *before = sum;
}

__global__ void __launch_bounds__(kThreads)
gap_finder_kernel(const uint32_t* __restrict__ words, RowValues word_off,
                  const int* __restrict__ limits, const int* __restrict__ adj,
                  const int* __restrict__ sym, int subblock, RowValues n_outs,
                  RowValues gap_off, RowValues tile_off, int rows, uint32_t* __restrict__ gaps,
                  long long* __restrict__ ends, unsigned long long* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int i = threadIdx.x;
  const int tiles = (int)tile_off.v[rows];
  unsigned long long* exits_all = ws + 1;
  unsigned long long* status_all = exits_all + tiles;
  unsigned long long* finals_all = status_all + tiles;
  int row = -1, maxlen = 1, g = 1;
  Decoder dec;

  for (;;) {
    if (i == 0) sm.ticket = (long long)atomicAdd(ws, 1ull);
    __syncthreads();
    const int64_t ticket = sm.ticket;
    if (ticket >= tiles) break;
    const int r = row_of_block(tile_off, ticket);
    if (r != row) {  // the block's first tile of this row
      row = r;
      dec = make_decoder<kThreads>(limits + row * kCodeBits, adj + row * kCodeBits,
                                   sym + row * 256, sm.table, sm.adj, sm.sym, &maxlen, &g);
    }
    const int64_t first_tile = tile_off.v[row];
    const int64_t t = ticket - first_tile;  // in the row
    const int64_t last_tile = tile_off.v[row + 1] - 1 - first_tile;
    const unsigned long long* row_exits = exits_all + first_tile;
    const unsigned long long* row_status = status_all + first_tile;
    const unsigned long long* row_finals = finals_all + first_tile;
    const uint32_t* rw = words + word_off.v[row];
    const int64_t nwords = word_off.v[row + 1] - word_off.v[row];
    const int64_t stream_bits = 32 * nwords;
    const int64_t n_out = n_outs.v[row];
    const int64_t ngaps = (n_out + subblock - 1) / subblock;

    // bit 0 of the buffer is the margin's first bit, kWindow before the tile
    const int64_t tile_lo = t * kTileBits;
    const int64_t origin = tile_lo - kWindow;
    const int64_t base = origin >> 5;
    for (int j = i; j < kBufWords; j += kThreads) {
      const int64_t k = base + j;
      sm.stream[j] = k >= 0 && k < nwords ? __ldg(rw + k) : 0u;
    }
    __syncthreads();  // also the table, where it was built

    // thread i's window [b, e), from the buffer's first bit; none before the stream
    const int64_t tile_hi = tile_lo + kTileBits < stream_bits ? tile_lo + kTileBits : stream_bits;
    const int hi = (int)(tile_hi - origin);
    const int b = i * kWindow;
    int e = b + kWindow < hi ? b + kWindow : hi;
    if (e < b || (t == 0 && i == 0)) e = b;
    const int bw0 = b >> 5;
    const int bw1 = e > b ? (e + 31) >> 5 : bw0;
    int s = b;
    if (e > b) s = (int)((origin + b + g - 1) / g * g - origin);  // origin + b >= 0 here
    const SmemStream src{sm.stream};
    Pass<int> a = count_pass<SmemStream, true>(src, dec, s, e, 0, sm.bitmap, bw0, bw1, false,
                                               0, 0);
    rounds(src, dec, t == 0 ? 1 : 0, b, e, bw0, bw1, sm.bitmap, sm.exits, &s, &a);

    // the tile's parse enters the tile at `entry` and leaves it at x_spec,
    // published at once; where the predecessor's exit is not `entry`, the
    // tile parses again from it before it counts
    const int last = hi > kWindow ? (hi - 1) / kWindow : 0;  // the last window owned
    long long entry = t == 0 ? 0 : origin + sm.exits[0];
    const long long x_spec = last ? origin + sm.exits[last] : tile_lo;
    if (i < 32) {
      if (i == 0) publish(exits_all + ticket, kPublished | (unsigned long long)x_spec);
      unsigned long long x_prev = 0;
      if (t > 0) {
        do {  // the predecessor publishes its exit before it waits for anything
          x_prev = load_volatile(row_exits + t - 1);
        } while (!(x_prev & kPublished));
        x_prev &= ~kPublished;
      }
      if (i == 0) sm.entry = (long long)x_prev;
    }
    __syncthreads();
    const long long x_prev = sm.entry;
    if (x_prev != entry) {
      from_entry(src, dec, x_prev - origin, b, e, bw0, bw1, sm.bitmap, sm.exits, &s, &a);
      entry = x_prev;
    }
    long long x = last ? origin + sm.exits[last] : tile_lo;
    int count;
    block_scan(i ? a.c : 0, sm.warp_sums, &count);

    if (i < 32) {
      long long e_true = 0, before = 0;
      if (t > 0) {
        if (i == 0) {
          publish(status_all + ticket,
                  kAggregate | (x == x_spec ? kKept : 0) | (unsigned long long)count);
        }
        look_back(row_exits, row_status, row_finals, t, (unsigned long long)x_prev, &e_true,
                  &before);
      }
      if (i == 0) {
        sm.entry = e_true;
        sm.before = before;
      }
    }
    __syncthreads();
    const long long e_true = sm.entry;
    const long long before = sm.before;
    if (e_true != entry) {  // the predecessor's exit moved: from its true exit
      from_entry(src, dec, e_true - origin, b, e, bw0, bw1, sm.bitmap, sm.exits, &s, &a);
      x = last ? origin + sm.exits[last] : tile_lo;
    }
    const int own = i ? a.c : 0;
    const long long idx = before + block_scan(own, sm.warp_sums, &count);
    const long long total = before + count;  // symbols before x
    if (i == 0) {
      publish(finals_all + ticket, (unsigned long long)x);
      publish(status_all + ticket, kInclusive | (unsigned long long)total);
    }

    // the bits of the gaps, and of the end, among the thread's codewords
    uint32_t* row_gaps = gaps + gap_off.v[row];
    if (own > 0) {
      long long next = (idx + subblock - 1) / subblock * subblock;  // the next gap's symbol
      bool end_here = n_out >= idx && n_out < idx + own;
      long long k = idx;
      Reader<SmemStream> rd(src, s);
      for (;;) {
        long long target = next < idx + own && next / subblock < ngaps ? next : -1;
        if (end_here && (target < 0 || n_out < target)) target = n_out;
        if (target < 0) break;
        for (; k < target; ++k) {
          int unused;
          rd.advance(dec.decode(rd.window(), &unused));
        }
        const long long bit = origin + rd.p;
        if (target == n_out && end_here) {
          ends[row] = bit;
          end_here = false;
        } else {
          row_gaps[next / subblock] = (uint32_t)bit;
          next += subblock;
        }
      }
    }
    if (t == last_tile) {  // past the stream: zeros, the shortest code's length a step
      int unused;
      const int z = dec.decode(0, &unused);
      for (long long k = (total + subblock - 1) / subblock + i; k < ngaps; k += kThreads) {
        row_gaps[k] = (uint32_t)(x + (k * subblock - total) * z);
      }
      if (i == 0 && n_out >= total) ends[row] = x + (n_out - total) * z;
    }
    __syncthreads();  // the buffers are free for the next tile
  }
}

}  // namespace

// The bits a tile owns: the wrapper sizes the workspace with it.
extern "C" int dcz_gap_tile_bits() { return kTileBits; }

// words: uint32[word_off[rows]], row r's stream at [word_off[r],
// word_off[r + 1]); limits, adj: int32[rows][16]; sym: int32[rows][256];
// n_outs: int64[rows]; gaps: uint32[gap_off[rows]], row r's ceil(n_out /
// subblock) gap bits at gap_off[r]; ends: int64[rows], row r's end bit;
// the offsets and n_outs on the host; rows: 1 .. kMaxRows; ws: int64[1 + 3 *
// tiles], zeroed, where row r has max(1, ceil(32 * its words / tile bits))
// tiles: [0] the ticket, then each tile's exit, status and true exit.
extern "C" int dcz_find_gaps(const void* words, const int64_t* word_off, const void* limits,
                             const void* adj, const void* sym, int rows, int subblock,
                             const int64_t* n_outs, const int64_t* gap_off, void* gaps,
                             void* ends, void* ws, void* stream) {
  int64_t tile_off[kMaxRows + 1];
  tile_off[0] = 0;
  for (int r = 0; r < rows; ++r) {
    const int64_t bits = 32 * (word_off[r + 1] - word_off[r]);
    const int64_t tiles = (bits + kTileBits - 1) / kTileBits;
    tile_off[r + 1] = tile_off[r] + (tiles > 0 ? tiles : 1);
  }
  const int smem = (int)sizeof(Smem);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gap_finder_kernel, kThreads,
                                                        smem);
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t resident = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  const int64_t blocks = tile_off[rows] < resident ? tile_off[rows] : resident;
  gap_finder_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(words), row_values(word_off, rows + 1),
      static_cast<const int*>(limits), static_cast<const int*>(adj),
      static_cast<const int*>(sym), subblock, row_values(n_outs, rows),
      row_values(gap_off, rows + 1), row_values(tile_off, rows + 1), rows,
      static_cast<uint32_t*>(gaps), static_cast<long long*>(ends),
      static_cast<unsigned long long*>(ws));
  return (int)cudaGetLastError();
}
