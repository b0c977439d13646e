// The decoding step that K3 (decode.cu) and K5 (gap_finder.cu) share: the
// canonical limits and the direct table, a bit reader over a stream in shared
// or device memory, and the counting pass with its bitmap of codeword
// starts and its early stop where a walk meets an earlier one.
//
// Included by several sources: everything here has internal linkage.

#pragma once

#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCodeBits = 16;        // the deepest code (TABLE_BITS)
constexpr int kMaxDirectBits = 12;   // the direct table's largest T

__device__ __forceinline__ int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// The 16 canonical limits as scalars: an array, once indexed where the
// compiler cannot resolve the index, would move the whole decoder to local
// memory.
struct Limits {
  int l0, l1, l2, l3, l4, l5, l6, l7, l8, l9, l10, l11, l12, l13, l14, l15;
  // how many limits are at most w: the code length less one
  __device__ __forceinline__ int count_le(int w) const {
    return (l0 <= w) + (l1 <= w) + (l2 <= w) + (l3 <= w) + (l4 <= w) + (l5 <= w) +
           (l6 <= w) + (l7 <= w) + (l8 <= w) + (l9 <= w) + (l10 <= w) + (l11 <= w) +
           (l12 <= w) + (l13 <= w) + (l14 <= w) + (l15 <= w);
  }
};

__device__ __forceinline__ Limits load_limits(const int* l) {
  return {l[0], l[1], l[2], l[3], l[4], l[5], l[6], l[7],
          l[8], l[9], l[10], l[11], l[12], l[13], l[14], l[15]};
}

// One canonical decode step on a left-aligned 16-bit window: the plain
// version's formula, through the direct table where the code is short.
struct Decoder {
  const uint16_t* table;
  const int* adj;
  const uint8_t* sym;
  int shift;  // 16 - T
  Limits lim;

  __device__ __forceinline__ int decode(uint32_t win, int* s) const {
    const uint32_t e = table[win >> shift];
    if (e) {
      *s = e & 0xFF;
      return (int)(e >> 8);
    }
    int len = 1 + lim.count_le((int)win);
    len = len < kCodeBits ? len : kCodeBits;
    int idx = (int)(win >> (kCodeBits - len)) + adj[len - 1];
    idx = idx < 0 ? 0 : (idx > 255 ? 255 : idx);
    *s = sym[idx];
    return len;
  }
};

// A stream and the type of a bit position in it.  The staged route counts
// bits from the first staged word in 32-bit integers; the direct route
// counts them from the stream's start.
struct SmemStream {  // words staged in shared memory
  using Pos = int;
  const uint32_t* buf;
  __device__ __forceinline__ uint32_t word(int j) const { return buf[j]; }
};

struct GlobalStream {  // the stream in device memory, zeros past its end
  using Pos = int64_t;
  const uint32_t* words;
  int64_t n;
  __device__ __forceinline__ uint32_t word(int64_t j) const {
    return j < n ? __ldg(words + j) : 0u;
  }
};

// A bit position with its two words in registers: a step of at most 16 bits
// crosses at most one word boundary, and the word it then loads is needed
// one step later at the earliest.
template <class Src>
struct Reader {
  using Pos = typename Src::Pos;
  Src src;
  Pos p, wi;
  uint32_t w0, w1;
  __device__ __forceinline__ Reader(Src s, Pos pos)
      : src(s), p(pos), wi(pos >> 5), w0(s.word(pos >> 5)), w1(s.word((pos >> 5) + 1)) {}
  __device__ __forceinline__ uint32_t window() const {
    return __funnelshift_l(w1, w0, (uint32_t)p & 31) >> 16;
  }
  __device__ __forceinline__ void advance(int len) {
    p += len;
    if ((p >> 5) != wi) {
      ++wi;
      w0 = w1;
      w1 = src.word(wi + 1);
    }
  }
};

template <class Pos>
struct Pass {
  Pos q;  // exit: the first codeword start at or past the lane's range
  int c;  // codewords that start in the lane's range
};

// Decode from s while the position is below `end`.  With the bitmap, the
// lane's words [bw0, bw1) end up holding this parse's codeword starts; with
// `check`, the walk stops where it meets the previous parse (whose exit was
// q_prev and count c_prev): the previous parse's starts from there on are
// c_prev less those in the words this walk overwrote and those below the
// meeting point in its word.  Src and Decoder travel by value, so that they
// stay in registers.
template <class Src, bool kBitmap, class Pos = typename Src::Pos>
__device__ __forceinline__ Pass<Pos> count_pass(Src src, Decoder dec, Pos s, Pos end, Pos lo,
                                                uint32_t* bm, int bw0, int bw1, bool check,
                                                Pos q_prev, int c_prev) {
  int c = 0;
  int cw = bw0;  // the bitmap word being assembled
  uint32_t cb = 0;
  int passed = 0;  // the previous parse's starts in the words overwritten so far
  if (s < end) {
    Reader<Src> r(src, s);
    do {
      if (kBitmap) {
        const int b = (int)(r.p - lo);
        const int bwi = b >> 5;
        const uint32_t m = 1u << (b & 31);
        for (; cw < bwi; ++cw) {
          if (check) passed += __popc(bm[cw]);
          bm[cw] = cb;
          cb = 0;
        }
        if (check) {
          const uint32_t old = bm[bwi];
          if (old & m) {  // the previous parse started a codeword here
            const uint32_t keep = old & ~(m - 1u);
            bm[bwi] = keep | cb;
            return {q_prev, c + c_prev - passed - __popc(old & (m - 1u))};
          }
        }
        cb |= m;
      }
      int sym;
      r.advance(dec.decode(r.window(), &sym));
      ++c;
    } while (r.p < end);
    s = r.p;
  }
  if (kBitmap) {
    for (; cw < bw1; ++cw) {
      bm[cw] = cb;
      cb = 0;
    }
  }
  return {s, c};
}

// The decoder of one row's tables: the limits in registers, and adj, sym and
// the direct table in shared memory, filled by the block's kBlock threads
// (the caller synchronises before the first decode).  The table has 2^T
// uint16 entries (length << 8 | symbol; 0 for a code longer than T bits), T
// = min(12, maxlen); its entries equal the limits' formula for every
// window.  *maxlen_out gets the deepest length in use and *g_out the gcd of
// the lengths in use (a length l is in use where limits[l-1] !=
// limits[l-2]), each 1 where none is.
template <int kBlock>
__device__ __forceinline__ Decoder make_decoder(const int* limits, const int* adj,
                                                const int* sym, uint16_t* table, int* sadj,
                                                uint8_t* ssym, int* maxlen_out, int* g_out) {
  Decoder dec;
  dec.lim = load_limits(limits);
  int maxlen = 0, g = 0, prev = 0;
  for (int l = 0; l < kCodeBits; ++l) {
    const int v = limits[l];
    if (v != prev) {  // length l + 1 is in use
      maxlen = l + 1;
      g = gcd(l + 1, g);
    }
    prev = v;
  }
  maxlen = maxlen ? maxlen : 1;
  g = g ? g : 1;
  const int tbits = maxlen < kMaxDirectBits ? maxlen : kMaxDirectBits;
  dec.shift = kCodeBits - tbits;
  dec.table = table;
  dec.adj = sadj;
  dec.sym = ssym;

  for (int i = threadIdx.x; i < kCodeBits; i += kBlock) sadj[i] = adj[i];
  for (int i = threadIdx.x; i < 256; i += kBlock) ssym[i] = (uint8_t)sym[i];
  const int tlim = limits[tbits - 1];
  for (int v = threadIdx.x; v < (1 << tbits); v += kBlock) {
    const int w = v << dec.shift;  // the window's low bits do not matter below T bits
    uint16_t entry = 0;
    if (w < tlim) {
      const int len = 1 + dec.lim.count_le(w);
      int idx = (w >> (kCodeBits - len)) + adj[len - 1];
      idx = idx < 0 ? 0 : (idx > 255 ? 255 : idx);
      entry = (uint16_t)((len << 8) | (sym[idx] & 0xFF));
    }
    table[v] = entry;
  }
  *maxlen_out = maxlen;
  *g_out = g;
  return dec;
}

}  // namespace
