"""K5: the gap array of a format-1 chunk, found on the device, as a CUDA
kernel and as a plain version (NumPy on CPU tensors' memory).

Format 1 stores no gap array.  :func:`find_gaps` finds, for each row of a
batch, the bit where every ``subblock``-th symbol starts (the gap array that
format 2 would have stored, ``ops/encode.py``'s ``starts[::subblock]``), so
that K3 (:func:`ops.decode_batch`) can decode the row from it, and the bit
where symbol ``n_out`` would start: the decoded stream's end, which a valid
stream keeps within its payload.  Both follow the one parse of the stream
from bit 0 that the decoder's formula gives (zeros past the row's words), on
any stream, valid or not.  The kernel is ``csrc/gap_finder.cu``: blocks
parse tiles of the stream speculatively, resynchronise, and chain their
exits and counts with a decoupled look-back; its header sets out the
design.  The JAX package has no counterpart: it decodes format 1 on the
host, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .decode import TABLE_BITS

kernel_launches = _build.LaunchCounter()
reference_calls = _build.LaunchCounter()

#: positions the plain version's tables hold at once
_SLICE = 1 << 22
#: the plain version walks in hops of 2^this codewords (4032 = 63 hops)
_HOP_BITS = 6


def fits(stream_words: int, n_out: int) -> bool:
    """Whether every bit K5 can report for a row of ``stream_words`` words
    and ``n_out`` symbols fits a uint32, as format 2's gaps do: its stream's
    bits, and 16 bits a symbol past them."""
    return 32 * stream_words + TABLE_BITS * (n_out + 2) < 1 << 32


def gap_offsets(n_outs, subblock: int) -> list:
    """Where each row's ``ceil(n_out / subblock)`` gaps start in
    :func:`find_gaps`' output, and its length last."""
    offsets = [0]
    for n_out in n_outs:
        offsets.append(offsets[-1] + -(-int(n_out) // subblock))
    return offsets


def _lengths(words: np.ndarray, limits: np.ndarray, dtype) -> np.ndarray:
    """The code length the decoder reads at each bit of the stream."""
    table = (1 + (np.arange(1 << TABLE_BITS)[:, None] >= limits[None, :]).sum(1)).clip(
        max=TABLE_BITS).astype(dtype)
    w = np.concatenate([words.astype(np.int64), np.zeros(2, np.int64)])
    n = 32 * words.size
    out = np.empty(n, dtype)
    for lo in range(0, n, _SLICE):
        p = np.arange(lo, min(n, lo + _SLICE))
        wi = p >> 5
        win48 = (w[wi] << 16) | (w[wi + 1] >> 16)
        out[lo : lo + p.size] = table[(win48 >> (32 - (p & 31))) & 0xFFFF]
    return out


def _then(first: np.ndarray, then: np.ndarray, then_steps: int, n: int, z: int) -> np.ndarray:
    """The jump of ``first``'s steps followed by ``then_steps`` more, as the
    jump ``then`` takes them from each bit below ``n`` (past it, every step
    is ``z`` bits)."""
    out = np.empty_like(first)
    for lo in range(0, first.size, _SLICE):
        f = first[lo : lo + _SLICE]
        out[lo : lo + f.size] = np.where(f < n, then[np.minimum(f, max(n - 1, 0))],
                                         f + then_steps * z)
    return out


def _gaps_plain(words: np.ndarray, limits: np.ndarray, subblock: int, n_out: int):
    """One row: its gap bits (int64) and its end bit."""
    n = 32 * words.size
    z = min(1 + int((limits <= 0).sum()), TABLE_BITS)  # the all-zero window
    ngaps = -(-n_out // subblock)
    hop = 1 << _HOP_BITS
    # every table entry lies below n + hop * 16: int32 where that fits
    dtype = np.int32 if n + hop * TABLE_BITS < 1 << 31 else np.int64
    near = _lengths(words, limits, dtype)
    far, steps = np.arange(n, dtype=dtype) + near, 1  # the next codeword's bit
    while steps < hop:  # the jump of `hop` codewords from every bit, by squaring
        far = _then(far, far, steps, n, z)
        steps *= 2

    def walk(bit: int, count: int) -> int:
        """The bit ``count`` codewords on from ``bit``."""
        for _ in range(count // hop):
            bit = int(far[bit]) if bit < n else bit + hop * z
        for _ in range(count % hop):
            bit = bit + int(near[bit]) if bit < n else bit + z
        return bit

    gaps = np.zeros(ngaps, np.int64)
    for k in range(1, ngaps):
        gaps[k] = walk(int(gaps[k - 1]), subblock)
    end = walk(int(gaps[-1]), n_out - (ngaps - 1) * subblock) if ngaps else 0
    return gaps, end


def find_gaps_reference(words, word_offsets, limits, adj, sym, subblock: int, n_outs):
    """Plain version, on the CPU tensors' memory with NumPy, one thread: for
    each row, the code length at every bit of its stream (one table read a
    bit), the jump of 64 codewords from every bit by repeated squaring, then
    a walk from bit 0 in hops of 64 codewords and single steps.  Only the
    lengths matter, so ``adj`` and ``sym`` go unread.  (PyTorch's CPU ops
    spread these passes over every core and spin there between them, which
    cost the tests' parallel workers five to eight times the CPU time.)"""
    reference_calls.add()
    stream = words.view(torch.int32).numpy().view(np.uint32)
    gaps, ends = [], []
    for b, n_out in enumerate(n_outs):
        g, end = _gaps_plain(stream[word_offsets[b] : word_offsets[b + 1]],
                             limits[b].numpy().astype(np.int64), subblock, n_out)
        gaps.append(g)
        ends.append(end)
    flat = np.concatenate(gaps).astype(np.uint32).view(np.int32)
    return torch.from_numpy(flat).view(torch.uint32), torch.tensor(ends, dtype=torch.int64)


def _launch(words, word_offsets, limits, adj, sym, subblock: int, n_outs: list):
    lib = _build.library()
    tile_bits = lib.dcz_gap_tile_bits()
    tiles = sum(max(1, -(-32 * (hi - lo) // tile_bits))
                for lo, hi in zip(word_offsets, word_offsets[1:]))
    offsets = gap_offsets(n_outs, subblock)
    dev = words.device
    gaps = torch.empty(offsets[-1], dtype=torch.uint32, device=dev)
    ends = torch.empty(len(n_outs), dtype=torch.int64, device=dev)
    ws = torch.zeros(1 + 3 * tiles, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.dcz_find_gaps(
            words.data_ptr(), _build.row_values(word_offsets), limits.data_ptr(),
            adj.data_ptr(), sym.data_ptr(), len(n_outs), subblock, _build.row_values(n_outs),
            _build.row_values(offsets), gaps.data_ptr(), ends.data_ptr(), ws.data_ptr(),
            _build.stream(words),
        )
    _build.check(rc, "find_gaps")
    kernel_launches.add()
    return gaps, ends


def find_gaps(words: torch.Tensor, word_offsets, limits: torch.Tensor, adj: torch.Tensor,
              sym: torch.Tensor, subblock: int, n_outs) -> tuple:
    """The gap arrays and ends of a batch of format-1 chunks →
    ``(gaps, ends)``: ``gaps`` uint32, row ``b``'s ``ceil(n_outs[b] /
    subblock)`` gap bits at ``gap_offsets(n_outs, subblock)[b]``, ready for
    :func:`ops.decode_batch`; ``ends`` int64[rows], the bit where each row's
    symbol ``n_out`` starts.

    The rows are :func:`ops.decode_batch`'s: row ``b``'s stream is
    ``words[word_offsets[b] : word_offsets[b + 1]]`` (its
    :func:`ops.payload_to_words`), its tables row ``b`` of ``limits``/``adj``
    (int32[rows, 16]) and ``sym`` (int32[rows, 256]), codes of at most 16
    bits; the offsets and ``n_outs`` are ints on the host, 1 to ``MAX_ROWS``
    rows.  A CUDA tensor launches the kernel once for all rows, and nothing
    waits for it; a CPU tensor takes the plain version.
    """
    subblock = int(subblock)
    word_offsets = [int(o) for o in word_offsets]
    n_outs = [int(n) for n in n_outs]
    _build.check_tensor(words, "words", torch.uint32)
    rows = _build.check_matrix(limits, "limits", torch.int32, cols=TABLE_BITS)
    _build.check_matrix(adj, "adj", torch.int32, rows, TABLE_BITS)
    _build.check_matrix(sym, "sym", torch.int32, rows, 256)
    if subblock <= 0:
        raise ValueError(f"subblock must be positive, got {subblock}")
    if len(n_outs) != rows:
        raise ValueError(f"{len(n_outs)} output lengths for {rows} rows")
    if (len(word_offsets) != rows + 1 or word_offsets[0] != 0
            or word_offsets[-1] != words.numel()
            or any(a > b for a, b in zip(word_offsets, word_offsets[1:]))):
        raise ValueError(f"word offsets {word_offsets} must rise from 0 to {words.numel()} "
                         f"in {rows + 1} steps")
    for lo, hi, n_out in zip(word_offsets, word_offsets[1:], n_outs):
        if n_out < 0 or not fits(hi - lo, n_out):
            raise ValueError(f"a row of {hi - lo} words and {n_out} symbols: its bits would "
                             "not fit a uint32 gap")
    if _build.on_cpu(words, limits, adj, sym):
        return find_gaps_reference(words, word_offsets, limits, adj, sym, subblock, n_outs)
    return _launch(words, word_offsets, limits, adj, sym, subblock, n_outs)
