"""GPU backend: the device chunk codec and the compression service.

Port of ``datacomp_tpu/services/tpu_service.py`` to PyTorch and CUDA:

* encode with a host codebook (``codebook_mode`` ``java`` or ``fast``): the
  shared host prepass (SHA-256, native histogram, codebook, raw-store
  decision), then the encoder kernel K2 on the device, one copy of the live
  words back and the shared container write;
* encode with a device codebook (``codebook_mode="device"``): histogram K1,
  codebook K4 and encode K2 on the device, with nothing fetched in between.
  In v2 the host prepass keeps SHA-256, the histogram and the raw-store
  decision, and one copy brings back the lengths, the gap array and the live
  words; v1 has no host histogram.  The device's codes are optimal and
  uncapped (``max_code_len`` is ignored), so v2 files differ from the host
  codec's, which caps v2 codes;
* decode: raw-stored chunks pass through; v2 chunks with codes of at most
  16 bits run the gap-array decoder kernel K3; v1 chunks and deeper codebooks
  go to the host codec through a counted route;
* availability: a 1 KB histogram on the device (kernel K1);
* batches (``device.batch_chunks``, auto 4 on a CUDA device): the pipeline
  hands the codec groups of chunks, and each group's device members run
  every kernel once (``histogram_batch``, ``codebook_batch``,
  ``encode_batch``, ``decode_batch``), with one upload and one copy back, as
  ``TpuChunkCodec.encode_chunk_batch`` and ``decode_chunk_batch`` do.

Unlike the JAX service, whose ``device.fallback_on_error`` is on by default,
there is no fallback to the CPU: a device error propagates, and a config
that sets ``fallback_on_error`` is refused.  The device is
``config.device.platform`` unless the caller names one; ``"cpu"`` runs the
kernels' plain PyTorch versions.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import AppConfig, load_config
from ..core import container as ct, huffman
from ..models import (
    CompressionMetrics,
    MetricsService,
    OperationType,
    Stage,
    StageMetrics,
)
from ..ops import (
    MAX_CODE_LEN,
    TABLE_BITS,
    build_decode_tables,
    codebook,
    codebook_batch,
    codebook_to_torch,
    decode,
    decode_batch,
    decode_tables_to_torch,
    encode,
    encode_batch,
    histogram,
    histogram_batch,
    max_code_len,
    payload_to_words,
    words_to_bytes,
)
from ..ops._build import LaunchCounter
from ..utils.checksum import compute_sha256
from .base import CompressionService, FrequencyService, ProgressCallback
from .cpu_service import CpuChunkCodec
from .pipeline import ChunkCodec, ChunkedPipeline, EncodedChunk

#: chunks that bypassed the device because of their codebook
host_encode_routes = LaunchCounter()  # codes deeper than the encoder's 32 bits
host_decode_routes = LaunchCounter()  # v1 container or codes deeper than 16 bits


def pick_device(platform: str = "any", index: int = -1) -> torch.device:
    """The compute device: ``platform="cpu"`` selects the CPU (the kernels'
    plain versions); anything else a CUDA device, and raises when there is
    none.

    ``index`` -1 is auto: ``cuda:LOCAL_RANK`` in a process that ``torchrun``
    started (one process a GPU), else ``cuda:0``.  An explicit index always
    wins (``device.device_index``, also ``DATACOMP_DEVICE_DEVICE_INDEX``):
    that is how several ranks share one card on purpose.  An index, explicit
    or from ``LOCAL_RANK``, that names no device raises: unlike the JAX
    service, which takes the first device instead, a misconfigured rank does
    not quietly share another rank's card."""
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is False); "
            "force the host codec with force_cpu, or select the plain versions "
            "with device.platform='cpu'"
        )
    count = torch.cuda.device_count()
    source = "device.device_index"
    if index == -1:
        source = "LOCAL_RANK"
        index = int(os.environ.get("LOCAL_RANK", "0"))
    if not 0 <= index < count:
        raise RuntimeError(
            f"{source} {index} names no CUDA device: this process sees {count}; "
            "set device.device_index (DATACOMP_DEVICE_DEVICE_INDEX) to share one"
        )
    return torch.device("cuda", index)


def get_available_devices() -> list:
    """One line per CUDA device."""
    if not torch.cuda.is_available():
        return ["no CUDA devices available"]
    lines = []
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        lines.append(
            f"[{i}] {p.name}  sm_{p.major}{p.minor}  SMs={p.multi_processor_count}  "
            f"memory={p.total_memory / 2**30:.1f} GiB"
        )
    return lines


def _check_depth(lengths: np.ndarray) -> None:
    """Raise the host codec's error for a code deeper than the format's 32-bit
    codewords (``core.huffman.build_code_lengths``)."""
    ml = int(lengths.max())
    if ml > MAX_CODE_LEN:
        raise ValueError(
            f"Huffman code length {ml} exceeds {MAX_CODE_LEN} "
            "bits; chunk too skewed — reduce chunk size"
        )


def _as_int32(t: torch.Tensor) -> torch.Tensor:
    """A 32- or 64-bit integer tensor's bits as a 1-D int32 tensor (a view)."""
    return t.reshape(-1).view(torch.int32)


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A host array as a CPU tensor, shared where it can be (read-only arrays
    are copied: torch tensors are writable)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


class GpuFrequencyService(FrequencyService):
    """Device histogram service (counterpart of ``TpuFrequencyService``)."""

    def __init__(self, config: Optional[AppConfig] = None, device=None):
        self.config = config or load_config()
        self.device = (
            torch.device(device) if device is not None
            else pick_device(self.config.device.platform, self.config.device.device_index)
        )
        self._available: Optional[bool] = None

    def compute_histogram(self, data, offset: int = 0, length: Optional[int] = None) -> np.ndarray:
        data = np.asarray(data, dtype=np.uint8)
        if length is None:
            length = data.size - offset
        x = _host_tensor(data[offset : offset + length]).to(self.device)
        return histogram(x, length).cpu().numpy().astype(np.int64)

    def is_available(self) -> bool:
        """Probe with a 1 KB histogram on the device, held against numpy."""
        if self._available is None:
            probe = (np.arange(1024) % 251).astype(np.uint8)
            self._available = bool(np.array_equal(
                self.compute_histogram(probe), np.bincount(probe, minlength=256)
            ))
        return self._available

    def get_service_name(self) -> str:
        name = (
            torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
            else "CPU, plain PyTorch"
        )
        return f"GPU Frequency Analysis ({name})"


def resolve_batch_chunks(setting: int, device) -> int:
    """Chunks a device call takes (``ChunkCodec.batch_chunks``):
    ``device.batch_chunks`` when it is set, else the JAX service's auto rule
    for a directly attached device (``TpuChunkCodec.batch_chunks``): 4 on a
    CUDA device, and 1 on the CPU, where the plain versions would only
    serialise chunks that the pipeline's workers already run side by side.
    The JAX rule for its relay has no counterpart here."""
    if setting:
        return setting
    return 4 if torch.device(device).type == "cuda" else 1


def _fetch(parts: list) -> np.ndarray:
    """The int32 views of ``parts``, concatenated on the device, in one copy
    to the host."""
    return torch.cat([_as_int32(p) for p in parts]).cpu().numpy()


def _split(flat: np.ndarray, sizes: list) -> list:
    """``flat`` cut into consecutive pieces of ``sizes`` elements."""
    return np.split(flat, np.cumsum(sizes)[:-1])


def _is_raw_stored(meta, header) -> bool:
    return (
        header.version >= ct.VERSION_V2
        and not meta.code_lengths.any()
        and meta.compressed_size == meta.original_size
    )


def _decodes_on_device(meta, header) -> bool:
    """A v2 chunk with a gap array and codes of 1 to 16 bits: K3 takes it."""
    return (
        header.version >= ct.VERSION_V2
        and meta.gap_bits is not None
        and meta.gap_bits.size > 0
        and header.subblock_symbols > 0
        and 0 < max_code_len(meta.code_lengths) <= TABLE_BITS
    )


class GpuChunkCodec(ChunkCodec):
    """Per-chunk device codec: host codebook → device encode (K2), or in
    device-codebook mode histogram (K1) → codebook (K4) → encode (K2) on the
    device; gap-array device decode (K3) for v2 containers.  A group of
    chunks (:meth:`encode_chunk_batch`, :meth:`decode_chunk_batch`) launches
    each kernel's batched entry point once for all of its device members."""

    def __init__(self, config: AppConfig, device: torch.device):
        self.config = config
        self.device = device
        self.freq = GpuFrequencyService(config, device)
        self._cpu = CpuChunkCodec(config)  # host histogram, v1 and deep decode
        self.padded_size = config.chunk_size_bytes
        self.subblock = config.compression.subblock_symbols
        # an optimal code spends at most H + 1 <= 9 bits a byte on the chunk
        # it was built from; the encode raises if a stream ever exceeds this
        self.out_words = (9 * self.padded_size + 31) // 32 + 2

    @property
    def batch_chunks(self) -> int:
        return resolve_batch_chunks(self.config.device.batch_chunks, self.device)

    # -- encode -------------------------------------------------------------

    def _host_prepass(self, data: np.ndarray, metrics: StageMetrics):
        """SHA-256, host histogram, host codebook and the raw-store decision
        (``TpuChunkCodec._host_prepass``).

        Returns ``(sha, lengths, codes, opt_bits, finished)``; ``finished`` is
        a complete :class:`EncodedChunk` (empty input, or an incompressible
        v2 chunk stored raw) that never touches the device, else None.
        ``opt_bits`` is the chunk's exact encoded size under the codebook.
        In device-codebook mode ``lengths`` and ``codes`` are None; in v2
        ``opt_bits`` then comes from the uncapped host ``fast`` code, an
        optimal code over the same histogram as the device's, and v1 has
        neither histogram nor ``opt_bits`` (None)."""
        n = data.size
        comp = self.config.compression
        device_codebook = comp.codebook_mode == "device"
        v2 = comp.format_version >= 2
        with metrics.timed(Stage.CHECKSUM_COMPUTE, n):
            sha = compute_sha256(data)
        if n == 0:
            return sha, None, None, 0, EncodedChunk(b"", np.zeros(256, np.int32), sha, None)
        if device_codebook and not v2:
            return sha, None, None, None, None
        with metrics.timed(Stage.FREQUENCY_ANALYSIS, n):
            hist = self._cpu.freq.compute_histogram(data)
        lengths = codes = None
        with metrics.timed(Stage.HUFFMAN_TREE_BUILD, n):
            if device_codebook:  # raises, as the host codec does, past 32 bits
                opt_lengths = huffman.build_code_lengths(hist, mode="fast")
            else:
                lengths, codes = huffman.build_codebook(
                    hist, mode=comp.codebook_mode, max_len=comp.effective_max_code_len(),
                )
                opt_lengths = lengths
        opt_bits = int(hist @ opt_lengths.astype(np.int64))
        if v2 and opt_bits >= n * 8:
            # incompressible: store raw (v2 marker: all-zero lengths)
            return sha, lengths, codes, opt_bits, EncodedChunk(
                data.tobytes(), np.zeros(256, np.int32), sha, None
            )
        return sha, lengths, codes, opt_bits, None

    @staticmethod
    def _host_route(lengths) -> bool:
        """True, and counted, for a host codebook deeper than the encoder's
        32 bits: such a chunk encodes on the host."""
        if lengths is not None and max_code_len(lengths) > MAX_CODE_LEN:
            host_encode_routes.add()
            return True
        return False

    def _upload(self, datas: list, device=None) -> torch.Tensor:
        """The chunks as the rows of one uint8[len(datas), padded_size]
        tensor on ``device`` (by default the codec's): each copied into its
        row, the row's tail zeroed on the device.  A group's rows are its
        live members only: the JAX service pads a group with empty chunks up
        to ``batch_chunks`` rows so that one static executable serves every
        group, and an empty row encodes to nothing, so leaving them out
        changes no byte."""
        x = torch.empty((len(datas), self.padded_size), dtype=torch.uint8,
                        device=device or self.device)
        for row, data in zip(x, datas):
            row[: data.size].copy_(_host_tensor(data))
            row[data.size :].zero_()
        return x

    def encode_chunk(self, data: np.ndarray, metrics: StageMetrics) -> EncodedChunk:
        sha, lengths, codes, opt_bits, finished = self._host_prepass(data, metrics)
        if finished is not None:
            return finished
        if self._host_route(lengths):
            return self._cpu.encode_chunk(data, metrics)
        return self._encode_prepared(data, sha, lengths, codes, opt_bits, metrics)

    def _encode_prepared(self, data, sha, lengths, codes, opt_bits, metrics) -> EncodedChunk:
        """One chunk on the device, after its host prepass."""
        if lengths is None:
            if self.config.compression.format_version >= 2:
                return self._encode_device_codebook_v2(data, sha, opt_bits, metrics)
            return self._encode_device_codebook_v1(data, sha, metrics)

        n = data.size
        v2 = self.config.compression.format_version >= 2
        with metrics.timed(Stage.ENCODING, n):
            x = self._upload([data])[0]
            lens_t, codes_t = codebook_to_torch(lengths, codes, self.device)
            words, total_bits, gaps = encode(
                x, n, lens_t, codes_t, self.out_words, self.subblock if v2 else 0
            )
            tb = int(total_bits)
            self._check_total(tb, opt_bits)
            payload = words_to_bytes(words[: (tb + 31) // 32].cpu().numpy(), tb)
            gap_bits = None
            if v2:
                nsub = (n + self.subblock - 1) // self.subblock
                gap_bits = gaps[:nsub].cpu().numpy()
        return EncodedChunk(payload, lengths.astype(np.int32), sha, gap_bits)

    def _encode_device_codebook_v2(self, data, sha, opt_bits: int, metrics) -> EncodedChunk:
        """K1 → K4 → K2 with nothing fetched in between, then ONE copy back of
        the total bits, lengths, gap array and live words (the fused branch of
        ``TpuChunkCodec._encode_chunk``).  ``opt_bits`` sizes the live words
        before anything is fetched; the device's total must equal it."""
        n = data.size
        nsub = (n + self.subblock - 1) // self.subblock
        nw = self._live_words(opt_bits)
        with metrics.timed(Stage.ENCODING, n):
            x = self._upload([data])[0]
            lens_t, codes_t = codebook(histogram(x, n))
            words, total_bits, gaps = encode(x, n, lens_t, codes_t, self.out_words, self.subblock)
            return self._v2_chunk(_fetch([total_bits, lens_t, gaps[:nsub], words[:nw]]), nsub,
                                  sha, opt_bits)

    def _v2_chunk(self, flat: np.ndarray, nsub: int, sha: bytes, opt_bits: int) -> EncodedChunk:
        """A device-codebook v2 chunk from its one copy back (``flat``, int32:
        total bits, lengths, ``nsub`` gap entries, live words), its depth and
        total checked."""
        tb = int(flat[:2].view(np.int64)[0])
        lengths = flat[2:258].copy()
        _check_depth(lengths)
        self._check_total(tb, opt_bits)
        return EncodedChunk(words_to_bytes(flat[258 + nsub :].view(np.uint32), tb), lengths, sha,
                            flat[258 : 258 + nsub].view(np.uint32).copy())

    def _encode_device_codebook_v1(self, data, sha, metrics) -> EncodedChunk:
        """K1 → K4 on the device, one copy back of the histogram and lengths
        (the depth is checked before K2 runs, and the histogram gives the live
        word count), K2, then one copy of the total bits and live words (the
        v1 device branch of ``TpuChunkCodec._encode_chunk``)."""
        n = data.size
        with metrics.timed(Stage.FREQUENCY_ANALYSIS, n):
            x = self._upload([data])[0]
            hist_t = histogram(x, n)
        with metrics.timed(Stage.HUFFMAN_TREE_BUILD, n):
            lens_t, codes_t = codebook(hist_t)
            hist, lengths = torch.cat([hist_t, lens_t]).cpu().numpy().reshape(2, 256)
            _check_depth(lengths)
            opt_bits = int(hist.astype(np.int64) @ lengths.astype(np.int64))
        with metrics.timed(Stage.ENCODING, n):
            words, total_bits, _ = encode(x, n, lens_t, codes_t, self.out_words)
            flat = _fetch([total_bits, words[: self._live_words(opt_bits)]])
            tb = int(flat[:2].view(np.int64)[0])
            self._check_total(tb, opt_bits)
            payload = words_to_bytes(flat[2:].view(np.uint32), tb)
        return EncodedChunk(payload, lengths.copy(), sha, None)

    # -- batched encode -----------------------------------------------------

    def encode_chunk_batch(self, datas, metrics: StageMetrics) -> list:
        """Encode a group of chunks (``TpuChunkCodec.encode_chunk_batch``).

        Each member's host prepass runs first.  Empty and raw-stored members
        are then finished, and a host codebook deeper than 32 bits takes the
        counted host route; every other member joins one device group, whose
        kernels each launch once, with one copy back (two in device-codebook
        v1).  A group of one takes the per-chunk path."""
        if len(datas) == 1 or self.batch_chunks <= 1:
            return [self.encode_chunk(d, metrics) for d in datas]
        results: list = [None] * len(datas)
        group = []  # (index, data, sha, lengths, codes, opt_bits)
        for i, data in enumerate(datas):
            sha, lengths, codes, opt_bits, finished = self._host_prepass(data, metrics)
            if finished is not None:
                results[i] = finished
            elif self._host_route(lengths):
                results[i] = self._cpu.encode_chunk(data, metrics)
            else:
                group.append((i, data, sha, lengths, codes, opt_bits))
        if len(group) == 1:
            i, *member = group[0]
            results[i] = self._encode_prepared(*member, metrics)
        elif group:
            if group[0][3] is not None:  # the mode decides: every member alike
                encs = self._encode_group(group, metrics)
            elif self.config.compression.format_version >= 2:
                encs = self._encode_group_device_codebook_v2(group, metrics)
            else:
                encs = self._encode_group_device_codebook_v1(group, metrics)
            for (i, *_), enc in zip(group, encs):
                results[i] = enc
        return results

    def _members(self, group: list) -> tuple:
        """The group's (datas, valid lengths, gap-array lengths)."""
        datas = [m[1] for m in group]
        valid = [d.size for d in datas]
        return datas, valid, [(n + self.subblock - 1) // self.subblock for n in valid]

    def _live_words(self, opt_bits: int) -> int:
        return min((opt_bits + 31) // 32, self.out_words)

    def _check_total(self, tb: int, opt_bits: int) -> None:
        if tb != opt_bits:
            raise RuntimeError(f"device encode wrote {tb} bits; the codebook predicts {opt_bits}")
        if tb > self.out_words * 32:
            raise RuntimeError("encoded stream exceeded device word capacity")

    def _encode_group(self, group: list, metrics: StageMetrics) -> list:
        """Host codebooks (``java``/``fast``, v1 and v2): the codebooks go up
        in one copy, K2 runs once, and one copy brings back every member's
        total bits, gap array (v2) and live words, sized by its ``opt_bits``."""
        v2 = self.config.compression.format_version >= 2
        datas, valid, nsubs = self._members(group)
        nsubs = nsubs if v2 else []
        nws = [self._live_words(m[5]) for m in group]
        with metrics.timed(Stage.ENCODING, sum(valid)):
            x = self._upload(datas)
            tables = np.stack([np.stack([m[3] for m in group]).astype(np.int32),
                               np.stack([m[4] for m in group]).astype(np.uint32).view(np.int32)])
            t = _host_tensor(tables).to(self.device)  # int32[2, rows, 256]
            words, totals, gaps = encode_batch(x, valid, t[0], t[1].view(torch.uint32),
                                               self.out_words, self.subblock if v2 else 0)
            parts = [totals] + [gaps[b, :k] for b, k in enumerate(nsubs)]
            pieces = _split(_fetch(parts + [words[b, :k] for b, k in enumerate(nws)]),
                            [2 * len(group)] + nsubs + nws)
            tbs = pieces[0].view(np.int64)
            out = []
            for b, (_, _, sha, lengths, _, opt_bits) in enumerate(group):
                self._check_total(int(tbs[b]), opt_bits)
                gap_bits = pieces[1 + b].view(np.uint32).copy() if v2 else None
                payload = words_to_bytes(pieces[1 + len(nsubs) + b].view(np.uint32), int(tbs[b]))
                out.append(EncodedChunk(payload, lengths.astype(np.int32), sha, gap_bits))
        return out

    def _encode_group_device_codebook_v2(self, group: list, metrics: StageMetrics) -> list:
        """Batched K1 → K4 → K2 with nothing fetched in between, then one copy
        back of every member's total bits, lengths, gap array and live words;
        each member's depth and total are checked as the per-chunk path does."""
        datas, valid, nsubs = self._members(group)
        nws = [self._live_words(m[5]) for m in group]
        rows = len(group)
        with metrics.timed(Stage.ENCODING, sum(valid)):
            x = self._upload(datas)
            lens_t, codes_t = codebook_batch(histogram_batch(x, valid))
            words, totals, gaps = encode_batch(x, valid, lens_t, codes_t, self.out_words,
                                               self.subblock)
            parts = [totals, lens_t] + [gaps[b, :k] for b, k in enumerate(nsubs)]
            pieces = _split(_fetch(parts + [words[b, :k] for b, k in enumerate(nws)]),
                            [2 * rows, 256 * rows] + nsubs + nws)
            tbs = pieces[0].view(np.int64)
            lengths = pieces[1].reshape(rows, 256)
            out = []
            for b, (_, _, sha, _, _, opt_bits) in enumerate(group):
                _check_depth(lengths[b])
                self._check_total(int(tbs[b]), opt_bits)
                payload = words_to_bytes(pieces[2 + rows + b].view(np.uint32), int(tbs[b]))
                out.append(EncodedChunk(payload, lengths[b].copy(), sha,
                                        pieces[2 + b].view(np.uint32).copy()))
        return out

    def _encode_group_device_codebook_v1(self, group: list, metrics: StageMetrics) -> list:
        """Batched K1 → K4, one copy back of the histograms and lengths, every
        member's depth checked before K2 (the host codec's error past 32
        bits), batched K2, then one copy of the totals and live words."""
        datas, valid, _ = self._members(group)
        rows = len(group)
        with metrics.timed(Stage.FREQUENCY_ANALYSIS, sum(valid)):
            x = self._upload(datas)
            hist_t = histogram_batch(x, valid)
        with metrics.timed(Stage.HUFFMAN_TREE_BUILD, sum(valid)):
            lens_t, codes_t = codebook_batch(hist_t)
            hist, lengths = torch.cat([hist_t, lens_t]).cpu().numpy().reshape(2, rows, 256)
            for row in lengths:
                _check_depth(row)
            opt_bits = (hist.astype(np.int64) * lengths.astype(np.int64)).sum(1)
        with metrics.timed(Stage.ENCODING, sum(valid)):
            words, totals, _ = encode_batch(x, valid, lens_t, codes_t, self.out_words)
            nws = [self._live_words(int(bits)) for bits in opt_bits]
            pieces = _split(_fetch([totals] + [words[b, :k] for b, k in enumerate(nws)]),
                            [2 * rows] + nws)
            tbs = pieces[0].view(np.int64)
            out = []
            for b, (_, _, sha, _, _, _) in enumerate(group):
                self._check_total(int(tbs[b]), int(opt_bits[b]))
                payload = words_to_bytes(pieces[1 + b].view(np.uint32), int(tbs[b]))
                out.append(EncodedChunk(payload, lengths[b].copy(), sha, None))
        return out

    # -- decode -------------------------------------------------------------

    def decode_chunk(self, payload, meta, header, metrics: StageMetrics) -> np.ndarray:
        if _is_raw_stored(meta, header):
            with metrics.timed(Stage.DECODING, meta.original_size):
                return np.frombuffer(payload, dtype=np.uint8)
        if not _decodes_on_device(meta, header):
            host_decode_routes.add()
            return self._cpu.decode_chunk(payload, meta, header, metrics)

        with metrics.timed(Stage.HUFFMAN_TREE_BUILD):
            tables = decode_tables_to_torch(
                *build_decode_tables(meta.code_lengths), self.device
            )
        with metrics.timed(Stage.DECODING, meta.original_size):
            words = _host_tensor(payload_to_words(payload)).to(self.device)
            gaps = _host_tensor(meta.gap_bits.astype(np.uint32)).to(self.device)
            out = decode(words, gaps, *tables, header.subblock_symbols, meta.original_size)
            return out.cpu().numpy()

    def decode_chunk_batch(self, payloads, metas, header, metrics: StageMetrics) -> list:
        """Decode a group of chunks (``TpuChunkCodec.decode_chunk_batch``):
        raw-stored members pass through, v1 members and codes deeper than 16
        bits take the counted host route, and all other members go to one
        launch of K3, whatever their depth; a lone such member takes the
        per-chunk path.  The JAX service groups by its decoder's static
        parameters; K3 reads each member's tables at run time."""
        if self.batch_chunks <= 1 or len(payloads) == 1:
            return [self.decode_chunk(p, m, header, metrics) for p, m in zip(payloads, metas)]
        group = [j for j, m in enumerate(metas)
                 if not _is_raw_stored(m, header) and _decodes_on_device(m, header)]
        if len(group) == 1:
            group = []
        results = [None if j in group else self.decode_chunk(p, m, header, metrics)
                   for j, (p, m) in enumerate(zip(payloads, metas))]
        if group:
            outs = self._decode_group([payloads[j] for j in group], [metas[j] for j in group],
                                      header, metrics)
            for j, out in zip(group, outs):
                results[j] = out
        return results

    def _decode_group(self, payloads, metas, header, metrics: StageMetrics) -> list:
        """Batched K3: the members' streams, gap arrays and tables go up in
        one copy, and their outputs come back in one."""
        with metrics.timed(Stage.HUFFMAN_TREE_BUILD):
            tables = [build_decode_tables(m.code_lengths) for m in metas]
        n_outs = [m.original_size for m in metas]
        with metrics.timed(Stage.DECODING, sum(n_outs)):
            args = self._decode_inputs(payloads, metas, tables, self.device)
            out = decode_batch(*args, header.subblock_symbols, n_outs).cpu().numpy()
        return _split(out, n_outs)

    @staticmethod
    def _decode_inputs(payloads, metas, tables, device) -> tuple:
        """The rows' streams, gap arrays and decode tables on ``device``, in
        one copy: ``(words, word_offsets, gaps, gap_offsets, limits, adj,
        sym)`` as :func:`ops.decode_batch` takes them."""
        rows = len(metas)
        words = [payload_to_words(p).view(np.int32) for p in payloads]
        gaps = [m.gap_bits.astype(np.uint32).view(np.int32) for m in metas]
        word_offsets = np.cumsum([0] + [w.size for w in words]).tolist()
        gap_offsets = np.cumsum([0] + [g.size for g in gaps]).tolist()
        limits, adj, sym = (np.stack([t[k] for t in tables]).astype(np.int32) for k in range(3))
        host = np.concatenate(words + gaps + [limits.ravel(), adj.ravel(), sym.ravel()])
        t = _host_tensor(host).to(device)
        w, g = word_offsets[-1], gap_offsets[-1]
        pieces = torch.split(t, [w, g, TABLE_BITS * rows, TABLE_BITS * rows, 256 * rows])
        return (pieces[0].view(torch.uint32), word_offsets, pieces[1].view(torch.uint32),
                gap_offsets, pieces[2].view(rows, TABLE_BITS), pieces[3].view(rows, TABLE_BITS),
                pieces[4].view(rows, 256))


class GpuCompressionService(CompressionService):
    """Compression service on one CUDA device (or, with ``device="cpu"``, on
    the kernels' plain versions).  Errors propagate: there is no fallback,
    and a config whose ``device.fallback_on_error`` asks for the JAX
    service's host redo (``tpu_service.py:866-888``) is refused."""

    def __init__(self, config: Optional[AppConfig] = None, device: Optional[str] = None):
        self.config = config or load_config()
        if self.config.device.fallback_on_error:
            raise ValueError(
                "device.fallback-on-error = true is not supported: the GPU service never "
                "redoes a failed operation on the host; set it to false, or set "
                "device.force-cpu (DATACOMP_DEVICE_FORCE_CPU=1) for the host codec"
            )
        self.device = pick_device(
            device or self.config.device.platform, self.config.device.device_index
        )
        self._stage_metrics = StageMetrics()
        self._codec = GpuChunkCodec(self.config, self.device)
        self._pipeline = ChunkedPipeline(
            self.config, self._codec, workers=max(2, self.config.device.parallel_chunks)
        )

    @property
    def backend(self) -> str:
        return "GPU" if self.device.type == "cuda" else "CPU"

    def _run(self, op, input_path, output_path, progress, compressing: bool) -> None:
        self._stage_metrics = StageMetrics()
        t0 = time.perf_counter()
        op(input_path, output_path, progress, self._stage_metrics)
        self._record(input_path, output_path, compressing, time.perf_counter() - t0)

    def compress(self, input_path, output_path, progress: ProgressCallback = None) -> None:
        self._run(self._pipeline.compress, input_path, output_path, progress, True)

    def decompress(self, input_path, output_path, progress: ProgressCallback = None) -> None:
        self._run(self._pipeline.decompress, input_path, output_path, progress, False)

    def resume_compression(self, input_path, output_path, last_completed_chunk, progress=None) -> None:
        self._stage_metrics = StageMetrics()
        t0 = time.perf_counter()
        self._pipeline.resume_compression(
            input_path, output_path, last_completed_chunk, progress, self._stage_metrics
        )
        self._record(input_path, output_path, True, time.perf_counter() - t0)

    def verify_integrity(self, compressed_path, deep: bool = False) -> bool:
        return self._pipeline.verify_integrity(compressed_path, deep=deep)

    def get_service_name(self) -> str:
        return "GPU Compression"

    def is_available(self) -> bool:
        return self._codec.freq.is_available()

    def close(self) -> None:
        self._pipeline.close()

    def _record(self, input_path, output_path, compressing, duration_s) -> None:
        try:
            in_size = os.path.getsize(input_path)
            out_size = os.path.getsize(output_path)
        except OSError:
            return
        MetricsService.get_instance().add_metrics(
            CompressionMetrics(
                file_name=os.path.basename(input_path),
                operation=OperationType.COMPRESSION if compressing else OperationType.DECOMPRESSION,
                original_size=in_size,
                processed_size=out_size,
                duration_s=max(duration_s, 1e-9),
                backend=self.backend,
            )
        )
