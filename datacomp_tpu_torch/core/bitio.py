"""Host bitstream encode/decode for canonical Huffman chunks.

The port's copy of ``datacomp_tpu/core/bitio.py``, held to the same bytes by
``tests/test_torch_host.py``.

Bit order matches the reference's ``BitOutputStream.writeBits``
(``service/cpu/CpuCompressionService.java:716-728``): MSB-first within each
byte, codewords written high-bit-first, final partial byte zero-padded on the
right.  The numpy encoder packs into big-endian uint32 words (bit 31 of word 0
is the first bit of the stream) and serializes big-endian, which yields the
identical byte stream.

The fast production host decode lives in the C++ native library
(:mod:`datacomp_tpu_torch.native`); :func:`decode_bitstream_py` is a pure-Python
canonical decoder used as a portable fallback and as the correctness oracle in
tests.
"""

from __future__ import annotations

import numpy as np

from .huffman import ALPHABET_SIZE, MAX_CODE_LEN, CorruptChunkError


def symbol_bit_lengths(data: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Per-input-byte code length (int64)."""
    return lengths.astype(np.int64)[data]


def encode_bitstream(data: np.ndarray, lengths: np.ndarray, codes: np.ndarray) -> bytes:
    """Encode ``data`` (uint8 array) into the canonical-Huffman bitstream.

    Vectorized numpy implementation: exclusive scan of code lengths gives each
    symbol its absolute bit position; each symbol contributes to at most two
    32-bit output words (codes are capped at 32 bits), OR-scattered with
    ``np.bitwise_or.at``.  Equivalent to (but ~2 orders faster than) the
    reference's serial ``BitOutputStream`` loop.
    """
    data = np.asarray(data, dtype=np.uint8)
    n = data.size
    if n == 0:
        return b""
    lens = lengths.astype(np.int64)[data]
    cws = codes.astype(np.uint32)[data]
    ends = np.cumsum(lens)
    total_bits = int(ends[-1])
    starts = ends - lens

    nwords = (total_bits + 31) // 32
    words = np.zeros(nwords, dtype=np.uint32)

    sw = (starts >> 5).astype(np.int64)  # first word touched
    ws = sw << 5
    drop = np.maximum(starts + lens - ws - 32, 0)  # tail bits spilling to next word
    shift_left = np.maximum(ws + 32 - starts - lens, 0)
    c1 = ((cws >> drop.astype(np.uint32)) << shift_left.astype(np.uint32)).astype(np.uint32)
    np.bitwise_or.at(words, sw, c1)

    spill = drop > 0
    if spill.any():
        c2 = (cws[spill] << (32 - drop[spill]).astype(np.uint32)).astype(np.uint32)
        np.bitwise_or.at(words, sw[spill] + 1, c2)

    out = words.astype(">u4").tobytes()
    return out[: (total_bits + 7) // 8]


def encoded_size_bits(data: np.ndarray, lengths: np.ndarray) -> int:
    data = np.asarray(data, dtype=np.uint8)
    if data.size == 0:
        return 0
    return int(np.bincount(data, minlength=ALPHABET_SIZE).astype(np.int64) @ lengths.astype(np.int64))


class CanonicalDecodeTables:
    """Per-length canonical decode tables: for length L, codes occupy
    ``[first[L], first[L]+count[L])``; symbol = ``sym_index[base[L] + code - first[L]]``
    with symbols laid out sorted by (length, symbol)."""

    def __init__(self, lengths: np.ndarray):
        lengths = np.asarray(lengths, dtype=np.int64)
        used = lengths > 0
        self.max_len = int(lengths[used].max()) if used.any() else 0
        self.min_len = int(lengths[used].min()) if used.any() else 0
        max_len = self.max_len
        counts = np.bincount(lengths[used], minlength=max_len + 1).astype(np.int64)
        first = np.zeros(max_len + 2, dtype=np.int64)
        code = 0
        for ln in range(1, max_len + 1):
            code = (code + counts[ln - 1]) << 1
            first[ln] = code
        self.first = first
        self.counts = counts
        self.base = np.zeros(max_len + 2, dtype=np.int64)
        self.base[1 : max_len + 1] = np.cumsum(counts[: max_len + 1])[:max_len]
        order = np.lexsort((np.arange(ALPHABET_SIZE), lengths))
        self.sym_sorted = order[np.sort(lengths, kind="stable") > 0].astype(np.int64)
        # limit[L] in L-bit space (exclusive upper bound of valid codes)
        self.limit = first[: max_len + 1] + counts[: max_len + 1]


def decode_bitstream_py(payload: bytes, n_symbols: int, lengths: np.ndarray) -> np.ndarray:
    """Pure-Python canonical decoder (portable fallback / test oracle)."""
    if n_symbols == 0:
        return np.zeros(0, dtype=np.uint8)
    t = CanonicalDecodeTables(lengths)
    if t.max_len == 0:
        raise CorruptChunkError("no symbols in codebook but n_symbols > 0")
    buf = payload + b"\x00" * 8  # slack so window reads never run off the end
    out = np.empty(n_symbols, dtype=np.uint8)
    first = t.first
    limit = t.limit
    base = t.base
    sym_sorted = t.sym_sorted
    min_len, max_len = t.min_len, t.max_len
    pos = 0
    for i in range(n_symbols):
        byte0 = pos >> 3
        window = int.from_bytes(buf[byte0 : byte0 + 8], "big")
        window = (window >> (64 - MAX_CODE_LEN - (pos & 7))) & 0xFFFFFFFF
        # window now holds the next 32 bits, left-aligned at bit 31
        for ln in range(min_len, max_len + 1):
            code = window >> (MAX_CODE_LEN - ln)
            if code < limit[ln]:
                out[i] = sym_sorted[base[ln] + code - first[ln]]
                pos += ln
                break
        else:
            raise CorruptChunkError(f"invalid Huffman code at bit {pos}")
    return out
