"""K2: the canonical-Huffman encoder, as a CUDA kernel and as plain PyTorch.

Counterpart of ``datacomp_tpu/ops/encode_merge.py::encode_device_merge`` with
the same contract: an MSB-first stream of uint32 words (bit 31 of word 0 is
the first bit), the total bit count and, when ``subblock`` is set, the start
bit of every ``subblock``-th symbol (the format-v2 gap array).  The kernel is
``csrc/encode.cu``: one launch, a single-pass scan of the code lengths with
decoupled look-back over 8192-symbol tiles, each tile's words packed in
shared memory and stored once, with device-memory atomics only on the two
words a tile may share with its neighbours.  Besides the launch, a call
makes one zero-fill: the word capacity and the tiles' status array.
:func:`encode_batch` encodes a batch of chunks in one launch (the vmapped
encoder of the JAX service's batched pipeline,
``encode_merge.py::encode_device_merge_batch_slotted``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

#: the padded chunk length must be a multiple of this (as in the JAX encoder)
GROUP = 32
#: deepest code the kernel packs (a code spans at most two output words)
MAX_CODE_LEN = 32

_MASK32 = 0xFFFFFFFF

kernel_launches = _build.LaunchCounter()
reference_calls = _build.LaunchCounter()
batch_launches = _build.LaunchCounter()
batch_reference_calls = _build.LaunchCounter()


def codebook_to_torch(lengths: np.ndarray, codes: np.ndarray, device) -> tuple:
    """The host codebook (``core.huffman.build_codebook``) as the encoder's
    tensors: int32[256] lengths and uint32[256] codes on ``device``."""
    lens = torch.from_numpy(np.ascontiguousarray(lengths, dtype=np.int32))
    cws = torch.from_numpy(np.ascontiguousarray(codes, dtype=np.uint32))
    return lens.to(device), cws.to(device)


def words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Serialize stream words (uint32, MSB-first bit order) to the byte
    stream, truncated to the exact encoded length."""
    nbytes = (int(total_bits) + 7) // 8
    return np.asarray(words, dtype=np.uint32).astype(">u4").tobytes()[:nbytes]


def _check_args(n, out_words, subblock) -> None:
    """The checks of the chunk length ``n`` and the outputs' shape."""
    if n == 0 or n % GROUP:
        raise ValueError(f"padded chunk length {n} must be a positive multiple of {GROUP}")
    if n >= 1 << 27:
        raise ValueError(f"{n} symbols can exceed the uint32 range of the bit offsets")
    if out_words <= 0:
        raise ValueError("out_words must be positive")
    if subblock < 0 or subblock % GROUP:
        raise ValueError(f"subblock {subblock} must be 0 or a multiple of {GROUP}")


def _encode_plain(data, valid_len: int, lengths, codes, out_words: int, subblock: int):
    n = data.numel()
    valid = torch.arange(n, device=data.device) < valid_len
    x = data.long()
    lens = torch.where(valid, lengths.long()[x], 0)
    cws = torch.where(valid, codes.long()[x], 0)
    ends = torch.cumsum(lens, 0)
    starts = ends - lens
    o = starts & 31
    spill = (o + lens - 32).clamp(min=0)  # bits that run into the next word
    hi = (cws >> spill) << (32 - o - lens).clamp(min=0)
    lo = torch.where(spill > 0, (cws << (32 - spill).clamp(max=31)) & _MASK32, 0)
    # index out_words is a spare slot that collects the dropped writes
    wi = starts >> 5
    words = torch.zeros(out_words + 1, dtype=torch.int64, device=data.device)
    words.index_add_(0, wi.clamp(max=out_words), hi)
    words.index_add_(0, (wi + 1).clamp(max=out_words), lo)
    gaps = starts[::subblock].to(torch.uint32) if subblock else None
    return words[:out_words].to(torch.uint32), ends[-1], gaps


def encode_reference(data, valid_len: int, lengths, codes, out_words: int,
                     subblock: int = 0):
    """Plain PyTorch.  The bit ranges of the symbols are disjoint, so OR equals
    add, and an ``index_add_`` of each code's two word halves into int64 words
    is exact.  (PyTorch has no shifts and no ``index_put`` for uint32 on the
    CPU, so words are carried as int64 holding 32 bits.)"""
    reference_calls.add()
    return _encode_plain(data, valid_len, lengths, codes, out_words, subblock)


def encode_batch_reference(data, valid_lens, lengths, codes, out_words: int,
                           subblock: int = 0):
    """Plain PyTorch: the plain encoder on each row."""
    batch_reference_calls.add()
    rows = [_encode_plain(data[b], int(v), lengths[b], codes[b], out_words, subblock)
            for b, v in enumerate(valid_lens)]
    words, totals, gaps = zip(*rows)
    return torch.stack(words), torch.stack(totals), torch.stack(gaps) if subblock else None


def _launch(data, valid_lens: list, lengths, codes, out_words: int, subblock: int, counter):
    """One launch over the rows of ``data`` (uint8[rows, n]) and of the
    codebooks (int32/uint32[rows, 256]); returns (words uint32[rows,
    out_words], total_bits int64[rows], gaps uint32[rows, nsub] or None).
    One chunk (uint8[n], codebooks of 256) gets the same without the row
    axis."""
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned for the kernel's vector loads")
    rows, n = len(valid_lens), data.shape[-1]
    batched = data.dim() == 2
    lib = _build.library()
    tiles = -(-n // lib.dcz_encode_tile_symbols())
    dev = data.device
    # one zero-fill: [tile ticket, each row's total_bits, each row's tile
    # statuses...] as int64, then the rows' words (an even offset in int32
    # units keeps the int64 aligned)
    ws_len = 2 * (1 + rows + rows * tiles)
    zeroed = torch.zeros(ws_len + rows * out_words, dtype=torch.int32, device=dev)
    ws = zeroed[:ws_len].view(torch.int64)
    words = zeroed[ws_len:].view(torch.uint32)
    nsub = (n + subblock - 1) // subblock if subblock else 0
    gaps = (
        torch.empty((rows, nsub) if batched else nsub, dtype=torch.uint32, device=dev)
        if subblock else None
    )
    with torch.cuda.device(dev):
        rc = lib.dcz_encode(
            data.data_ptr(), n, _build.row_values(valid_lens), rows, lengths.data_ptr(),
            codes.data_ptr(), words.data_ptr(), out_words,
            gaps.data_ptr() if gaps is not None else None, subblock, ws.data_ptr(),
            _build.stream(data),
        )
    _build.check(rc, "encode")
    counter.add()
    if not batched:
        return words, ws[1], gaps
    return words.view(rows, out_words), ws[1 : 1 + rows], gaps


def encode(data: torch.Tensor, valid_len: int, lengths: torch.Tensor,
           codes: torch.Tensor, out_words: int, subblock: int = 0):
    """Encode ``data[:valid_len]`` → ``(words uint32[out_words], total_bits
    int64 scalar tensor, gaps uint32[ceil(n / subblock)] or None)``.

    ``data`` is the padded uint8 chunk (length a multiple of 32); ``lengths``
    int32[256] and ``codes`` uint32[256] are the codebook, codes at most
    :data:`MAX_CODE_LEN` bits.  Words at or beyond ``out_words`` are dropped:
    the caller compares ``total_bits`` with ``32 * out_words``.  A CUDA tensor
    launches the kernel; a CPU tensor takes the plain version.
    """
    valid_len, out_words, subblock = int(valid_len), int(out_words), int(subblock)
    _build.check_tensor(data, "data", torch.uint8)
    _build.check_tensor(lengths, "lengths", torch.int32, 256)
    _build.check_tensor(codes, "codes", torch.uint32, 256)
    _build.check_valid_lens([valid_len], 1, data.numel())
    _check_args(data.numel(), out_words, subblock)
    if _build.on_cpu(data, lengths, codes):
        return encode_reference(data, valid_len, lengths, codes, out_words, subblock)
    return _launch(data, [valid_len], lengths, codes, out_words, subblock, kernel_launches)


def encode_batch(data: torch.Tensor, valid_lens, lengths: torch.Tensor,
                 codes: torch.Tensor, out_words: int, subblock: int = 0):
    """Encode each row ``data[b, :valid_lens[b]]`` with its codebook
    ``lengths[b]``, ``codes[b]`` → ``(words uint32[rows, out_words],
    total_bits int64[rows], gaps uint32[rows, ceil(n / subblock)] or None)``,
    row by row equal to :func:`encode`.

    ``data`` is uint8[rows, n] (1 to ``MAX_ROWS`` rows of padded chunks),
    ``valid_lens`` ints on the host, ``lengths`` int32[rows, 256] and
    ``codes`` uint32[rows, 256].  A CUDA tensor launches the kernel once for
    all rows; a CPU tensor takes the plain version.
    """
    out_words, subblock = int(out_words), int(subblock)
    rows = _build.check_matrix(data, "data", torch.uint8)
    _build.check_matrix(lengths, "lengths", torch.int32, rows, 256)
    _build.check_matrix(codes, "codes", torch.uint32, rows, 256)
    n = data.shape[1]
    valid_lens = _build.check_valid_lens(valid_lens, rows, n)
    _check_args(n, out_words, subblock)
    if _build.on_cpu(data, lengths, codes):
        return encode_batch_reference(data, valid_lens, lengths, codes, out_words, subblock)
    return _launch(data, valid_lens, lengths, codes, out_words, subblock, batch_launches)
