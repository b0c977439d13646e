"""K3: the gap-array canonical-Huffman decoder, as a CUDA kernel and as plain
PyTorch, with the host helpers that prepare its input.

Counterpart of ``datacomp_tpu/ops/decode.py::decode_device``: sub-block ``i``
enters the stream at bit ``gaps[i]`` and yields ``subblock`` symbols, decoded
with the comparison tables of :func:`build_decode_tables`.  Unlike the JAX
decoder, the output stops at ``n_out``: nothing is written past the end.  The
kernel is ``csrc/decode.cu``: one warp a sub-block, its 32 lanes splitting
the sub-block's bit range and synchronising their starts in rounds (at most
31), the stream staged in shared memory, a direct table for codes of up to 12
bits, and 16-byte stores of the decoded bytes.  Its header sets out the
schedule; ``tests/test_torch_decode_schedule.py`` holds a numpy model of it
to the plain version.  :func:`decode_batch` decodes a batch of chunks in one
launch (the vmapped decoder of the JAX service's batched decode).

The numpy helpers here are the JAX package's, re-homed because importing
anything under ``datacomp_tpu.ops`` loads jax; tests hold them equal.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bitio import CanonicalDecodeTables
from ..core.huffman import CorruptChunkError, validate_lengths

from . import _build

#: deepest code the decoder's 16-bit window resolves
TABLE_BITS = 16

kernel_launches = _build.LaunchCounter()
reference_calls = _build.LaunchCounter()
batch_launches = _build.LaunchCounter()
batch_reference_calls = _build.LaunchCounter()


def build_decode_tables(lengths: np.ndarray, table_bits: int = TABLE_BITS):
    """Comparison-decode constants:

    * ``limits`` int32[16] — monotone canonical boundaries
      ``(first[l] + count[l]) << (16 - l)`` (``1 << 16`` for unused lengths,
      so the running count saturates at the true code length);
    * ``adj`` int32[16] — ``base[l] - first[l]`` (canonical index offset);
    * ``sym`` int32[256] — symbols sorted by (length, symbol), zero-padded.

    Raises :class:`CorruptChunkError` when the lengths are no prefix code,
    and ValueError when any code exceeds ``table_bits``.
    """
    if not validate_lengths(lengths):
        raise CorruptChunkError("the code-length table is no prefix code")
    t = CanonicalDecodeTables(lengths)
    if t.max_len > table_bits:
        raise ValueError(f"max code length {t.max_len} > table bits {table_bits}")
    limits = np.full(table_bits, 1 << table_bits, np.int64)
    adj = np.zeros(table_bits, np.int64)
    for ln in range(1, t.max_len + 1):
        limits[ln - 1] = (int(t.first[ln]) + int(t.counts[ln])) << (table_bits - ln)
        adj[ln - 1] = int(t.base[ln]) - int(t.first[ln])
    sym = np.zeros(256, np.int32)
    sym[: len(t.sym_sorted)] = t.sym_sorted
    return limits.astype(np.int32), adj.astype(np.int32), sym


def max_code_len(lengths: np.ndarray) -> int:
    lengths = np.asarray(lengths)
    used = lengths[lengths > 0]
    return int(used.max()) if used.size else 0


def payload_to_words(payload: bytes) -> np.ndarray:
    """Byte stream → uint32 words (big-endian bit order) + 2 zero pad words."""
    pad = (-len(payload)) % 4
    buf = bytes(payload) + b"\x00" * (pad + 8)
    return np.frombuffer(buf, dtype=">u4").astype(np.uint32)


def decode_tables_to_torch(limits: np.ndarray, adj: np.ndarray, sym: np.ndarray,
                           device) -> tuple:
    """The tables of :func:`build_decode_tables` as int32 tensors on ``device``."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
        for a in (limits, adj, sym)
    )


def _check_tables(words, gaps, limits, adj, sym, subblock, stats, rows: int) -> None:
    _build.check_tensor(words, "words", torch.uint32)
    if stats is not None:
        _build.check_tensor(stats, "stats", torch.int64, 2)
    _build.check_tensor(gaps, "gaps", torch.uint32)
    _build.check_matrix(limits, "limits", torch.int32, rows, TABLE_BITS)
    _build.check_matrix(adj, "adj", torch.int32, rows, TABLE_BITS)
    _build.check_matrix(sym, "sym", torch.int32, rows, 256)
    if subblock <= 0:
        raise ValueError(f"subblock must be positive, got {subblock}")


def _check_rows(word_offsets: list, gap_offsets: list, n_outs: list, words, gaps,
                subblock: int) -> None:
    """Raise unless the offsets cut ``words`` and ``gaps`` into one piece a
    row, and each row's ``n_out`` fits its sub-blocks."""
    rows = len(n_outs)
    for name, offsets, t in (("word", word_offsets, words), ("gap", gap_offsets, gaps)):
        if (len(offsets) != rows + 1 or offsets[0] != 0 or offsets[-1] != t.numel()
                or any(a > b for a, b in zip(offsets, offsets[1:]))):
            raise ValueError(
                f"{name} offsets {offsets} must rise from 0 to {t.numel()} in {rows + 1} steps"
            )
    for b, n_out in enumerate(n_outs):
        nsub = gap_offsets[b + 1] - gap_offsets[b]
        if not 0 <= n_out <= nsub * subblock:
            raise ValueError(
                f"n_out {n_out} outside [0, {nsub} sub-blocks x {subblock}]"
            )


def _decode_plain(words, gaps, limits, adj, sym, subblock: int, n_out: int):
    dev = words.device
    w = torch.cat([words.long(), torch.zeros(2, dtype=torch.int64, device=dev)])
    last = w.numel() - 2
    lim, adj_, sym_ = limits.long(), adj.long(), sym.long()
    pos = gaps.long()
    out = torch.empty((gaps.numel(), subblock), dtype=torch.uint8, device=dev)
    for j in range(subblock):
        wi = (pos >> 5).clamp(max=last)
        win48 = (w[wi] << 16) | (w[wi + 1] >> 16)
        win = (win48 >> (32 - (pos & 31))) & 0xFFFF
        ln = (1 + (win[:, None] >= lim[None, :]).sum(1)).clamp(max=TABLE_BITS)
        idx = ((win >> (TABLE_BITS - ln)) + adj_[ln - 1]).clamp(0, 255)
        out[:, j] = sym_[idx].to(torch.uint8)
        pos = pos + ln
    return out.reshape(-1)[:n_out]


def decode_reference(words, gaps, limits, adj, sym, subblock: int, n_out: int):
    """Plain PyTorch: vectorised over sub-blocks, one loop step per symbol.

    Each lane keeps its absolute bit position and reads the 48 bits that start
    at its word (two int64-held words), which cover any 16-bit window."""
    reference_calls.add()
    return _decode_plain(words, gaps, limits, adj, sym, subblock, n_out)


def decode_batch_reference(words, word_offsets, gaps, gap_offsets, limits, adj, sym,
                           subblock: int, n_outs):
    """Plain PyTorch: the plain decoder on each row, outputs concatenated."""
    batch_reference_calls.add()
    wo, go = list(word_offsets), list(gap_offsets)
    return torch.cat([
        _decode_plain(words[wo[b] : wo[b + 1]], gaps[go[b] : go[b + 1]], limits[b], adj[b],
                      sym[b], subblock, int(n_out))
        for b, n_out in enumerate(n_outs)
    ])


def _launch(words, word_offsets, gaps, gap_offsets, limits, adj, sym, subblock: int,
            n_outs: list, stats, counter) -> torch.Tensor:
    """One launch over the rows: row ``b``'s stream is ``words[word_offsets[b]
    : word_offsets[b + 1]]``, its gap array the same cut of ``gaps``, its
    tables row ``b`` of ``limits``, ``adj`` and ``sym``; its ``n_outs[b]``
    bytes follow the rows before it in the output."""
    out_offsets = [0]
    for n_out in n_outs:
        out_offsets.append(out_offsets[-1] + n_out)
    out = torch.empty(out_offsets[-1], dtype=torch.uint8, device=words.device)
    lib = _build.library()
    with torch.cuda.device(words.device):
        rc = lib.dcz_decode(
            words.data_ptr(), _build.row_values(word_offsets), gaps.data_ptr(),
            _build.row_values(gap_offsets), limits.data_ptr(), adj.data_ptr(),
            sym.data_ptr(), len(n_outs), subblock, _build.row_values(out_offsets),
            out.data_ptr(), stats.data_ptr() if stats is not None else None,
            _build.stream(words),
        )
    _build.check(rc, "decode")
    counter.add()
    return out


def decode(words: torch.Tensor, gaps: torch.Tensor, limits: torch.Tensor,
           adj: torch.Tensor, sym: torch.Tensor, subblock: int,
           n_out: int, stats: torch.Tensor | None = None) -> torch.Tensor:
    """Decode ``n_out`` symbols → uint8[n_out].

    ``words`` uint32 is the stream (:func:`payload_to_words`), ``gaps``
    uint32[nsub] the start bit of each sub-block, ``limits``/``adj``/``sym``
    the tables of :func:`build_decode_tables` (codes at most 16 bits).  A CUDA
    tensor launches the kernel; a CPU tensor takes the plain version.

    ``stats``, an int64[2] CUDA tensor, is for measurement: the kernel adds
    the sub-blocks it decoded to ``stats[0]`` and the synchronisation rounds
    they took to ``stats[1]``.  The plain version has no rounds, so it takes
    ``None`` only.
    """
    subblock, n_out = int(subblock), int(n_out)
    for name, t, numel in (("limits", limits, TABLE_BITS), ("adj", adj, TABLE_BITS),
                           ("sym", sym, 256)):
        _build.check_tensor(t, name, torch.int32, numel)
    limits, adj, sym = limits.view(1, -1), adj.view(1, -1), sym.view(1, -1)
    _check_tables(words, gaps, limits, adj, sym, subblock, stats, 1)
    _check_rows([0, words.numel()], [0, gaps.numel()], [n_out], words, gaps, subblock)
    extra = () if stats is None else (stats,)
    if _build.on_cpu(words, gaps, limits, adj, sym, *extra):
        if stats is not None:
            raise ValueError("stats counts the kernel's rounds: it needs CUDA tensors")
        return decode_reference(words, gaps, limits[0], adj[0], sym[0], subblock, n_out)
    return _launch(words, [0, words.numel()], gaps, [0, gaps.numel()], limits, adj, sym,
                   subblock, [n_out], stats, kernel_launches)


def decode_batch(words: torch.Tensor, word_offsets, gaps: torch.Tensor, gap_offsets,
                 limits: torch.Tensor, adj: torch.Tensor, sym: torch.Tensor, subblock: int,
                 n_outs, stats: torch.Tensor | None = None) -> torch.Tensor:
    """Decode a batch of chunks → uint8[sum(n_outs)], the rows' outputs
    concatenated, row by row equal to :func:`decode`.

    Row ``b``'s stream is ``words[word_offsets[b] : word_offsets[b + 1]]``
    (its :func:`payload_to_words`), its gap array the same cut of ``gaps`` by
    ``gap_offsets``, its tables row ``b`` of ``limits``/``adj`` (int32[rows,
    16]) and ``sym`` (int32[rows, 256]); the offsets and ``n_outs`` are ints
    on the host, 1 to ``MAX_ROWS`` rows.  A CUDA tensor launches the kernel
    once for all rows; a CPU tensor takes the plain version.  ``stats`` sums
    over the rows, as :func:`decode`'s.
    """
    subblock = int(subblock)
    word_offsets = [int(o) for o in word_offsets]
    gap_offsets = [int(o) for o in gap_offsets]
    n_outs = [int(n) for n in n_outs]
    rows = _build.check_matrix(limits, "limits", torch.int32, cols=TABLE_BITS)
    _check_tables(words, gaps, limits, adj, sym, subblock, stats, rows)
    if len(n_outs) != rows:
        raise ValueError(f"{len(n_outs)} output lengths for {rows} rows")
    _check_rows(word_offsets, gap_offsets, n_outs, words, gaps, subblock)
    extra = () if stats is None else (stats,)
    if _build.on_cpu(words, gaps, limits, adj, sym, *extra):
        if stats is not None:
            raise ValueError("stats counts the kernel's rounds: it needs CUDA tensors")
        return decode_batch_reference(words, word_offsets, gaps, gap_offsets, limits, adj,
                                      sym, subblock, n_outs)
    return _launch(words, word_offsets, gaps, gap_offsets, limits, adj, sym, subblock,
                   n_outs, stats, batch_launches)
