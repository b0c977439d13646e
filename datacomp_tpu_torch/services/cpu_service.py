"""CPU backend: host-native chunk codec + compression service.

The port's copy of ``datacomp_tpu/services/cpu_service.py``, held to the same bytes by
``tests/test_torch_host.py``.

Re-expression of the reference CPU backend
(``service/cpu/CpuCompressionService.java``, ``CpuFrequencyService.java``):
thread-pool chunk parallelism with ordered streaming writes, per-chunk
SHA-256 → histogram → canonical codebook → bit-serial encode, batched parallel
table-based decode.  Hot loops run in the C++ native library
(:mod:`datacomp_tpu_torch.native`), with numpy / pure-Python fallbacks.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from .. import native
from ..config import AppConfig, load_config
from ..core import bitio, container as ct, huffman
from ..models import Stage, StageMetrics
from ..utils.checksum import compute_sha256
from .base import CompressionService, FrequencyService, ProgressCallback
from .pipeline import ChunkCodec, ChunkedPipeline, EncodedChunk


class CpuFrequencyService(FrequencyService):
    """256-bin byte histogram (parity: ``CpuFrequencyService.java``; the
    ForkJoin divide-and-conquer is subsumed by the native single pass —
    callers parallelize across chunks)."""

    def compute_histogram(self, data, offset: int = 0, length: Optional[int] = None) -> np.ndarray:
        data = np.asarray(data, dtype=np.uint8)
        if length is None:
            length = data.size - offset
        view = data[offset : offset + length]
        if native.is_available():
            return native.histogram(view)
        return np.bincount(view, minlength=256).astype(np.int64)

    def get_service_name(self) -> str:
        return "CPU Frequency Analysis"

    def is_available(self) -> bool:
        return True


class CpuChunkCodec(ChunkCodec):
    def __init__(self, config: AppConfig):
        self.config = config
        self.freq = CpuFrequencyService()

    def encode_chunk(self, data: np.ndarray, metrics: StageMetrics) -> EncodedChunk:
        n = data.size
        with metrics.timed(Stage.CHECKSUM_COMPUTE, n):
            sha = compute_sha256(data)  # hashlib takes the buffer, no copy
        with metrics.timed(Stage.FREQUENCY_ANALYSIS, n):
            hist = self.freq.compute_histogram(data)
        with metrics.timed(Stage.HUFFMAN_TREE_BUILD, n):
            lengths, codes = huffman.build_codebook(
                hist,
                mode=self.config.compression.codebook_mode,
                max_len=self.config.compression.effective_max_code_len(),
            )
        v2 = self.config.compression.format_version >= 2 and n > 0
        sub = self.config.compression.subblock_symbols
        gap_bits = None
        nbits = int(hist @ lengths.astype(np.int64))
        if v2 and nbits >= n * 8:
            # incompressible chunk: store raw (v2-only; marked by all-zero
            # code lengths + compressedSize == originalSize).  The reference
            # always Huffman-encodes and expands on such data
            # (docs: random ⇒ 100%+, e.g. its 3.05 GB video run).
            with metrics.timed(Stage.ENCODING, n):
                # pass the view through: the pipeline writes it while the
                # source mmap is still open
                return EncodedChunk(data, np.zeros(256, np.int32), sha, None)
        with metrics.timed(Stage.ENCODING, n):
            if native.is_available():
                if v2:
                    payload, gap_bits = native.encode(
                        data, lengths, codes, nbits=nbits, subblock=sub
                    )
                else:
                    payload = native.encode(data, lengths, codes, nbits=nbits)
            else:
                payload = bitio.encode_bitstream(data, lengths, codes)
                if v2:
                    lens = lengths.astype(np.int64)[data]
                    starts = np.cumsum(lens) - lens
                    gap_bits = starts[::sub].astype(np.uint32)
        return EncodedChunk(payload, lengths, sha, gap_bits)

    def decode_chunk(self, payload, meta, header, metrics: StageMetrics,
                     decode_span: Optional[str] = None) -> np.ndarray:
        """The chunk's bytes; ``decode_span`` names the span of its bit
        decoding (by default the DECODING stage's, ``decode``)."""
        if (
            header.version >= ct.VERSION_V2
            and not meta.code_lengths.any()
            and meta.compressed_size == meta.original_size
        ):
            # raw-stored incompressible chunk
            with metrics.timed(Stage.DECODING, meta.original_size):
                return np.frombuffer(payload, dtype=np.uint8)
        with metrics.timed(Stage.HUFFMAN_TREE_BUILD, span="decode_tables"):
            if not huffman.validate_lengths(meta.code_lengths):
                raise huffman.CorruptChunkError(f"invalid code-length table in chunk {meta.index}")
        with metrics.timed(Stage.DECODING, meta.original_size, span=decode_span):
            if native.is_available():
                try:  # the native decoder's ValueError is its non-zero rc: a corrupt stream
                    if (
                        meta.gap_bits is not None
                        and meta.gap_bits.size > 0
                        and header.subblock_symbols > 0
                    ):
                        return native.decode_gaps(
                            payload, meta.original_size, meta.code_lengths,
                            meta.gap_bits, header.subblock_symbols,
                        )
                    return native.decode(payload, meta.original_size, meta.code_lengths)
                except ValueError as e:
                    raise huffman.CorruptChunkError(str(e)) from e
            return bitio.decode_bitstream_py(payload, meta.original_size, meta.code_lengths)


class CpuCompressionService(CompressionService):
    def __init__(self, config: Optional[AppConfig] = None, chunk_size_mb: Optional[int] = None):
        if config is None:
            config = load_config()
        if chunk_size_mb is not None:
            from dataclasses import replace

            config = replace(
                config, compression=replace(config.compression, chunk_size_mb=chunk_size_mb)
            )
        self.config = config
        self._stage_metrics = StageMetrics()
        self._codec = CpuChunkCodec(config)
        self._pipeline = ChunkedPipeline(config, self._codec)

    def compress(self, input_path, output_path, progress: ProgressCallback = None) -> None:
        self._stage_metrics = StageMetrics()
        t0 = time.perf_counter()
        self._pipeline.compress(input_path, output_path, progress, self._stage_metrics)
        self._record_op(input_path, output_path, True, time.perf_counter() - t0)

    def decompress(self, input_path, output_path, progress: ProgressCallback = None) -> None:
        self._stage_metrics = StageMetrics()
        t0 = time.perf_counter()
        self._pipeline.decompress(input_path, output_path, progress, self._stage_metrics)
        self._record_op(input_path, output_path, False, time.perf_counter() - t0)

    def resume_compression(self, input_path, output_path, last_completed_chunk, progress=None) -> None:
        self._stage_metrics = StageMetrics()
        t0 = time.perf_counter()
        self._pipeline.resume_compression(
            input_path, output_path, last_completed_chunk, progress, self._stage_metrics
        )
        self._record_op(input_path, output_path, True, time.perf_counter() - t0)

    def verify_integrity(self, compressed_path, deep: bool = False) -> bool:
        return self._pipeline.verify_integrity(compressed_path, deep=deep)

    def get_service_name(self) -> str:
        return "CPU Compression"

    def is_available(self) -> bool:
        return True

    def close(self) -> None:
        self._pipeline.close()

    def _record_op(self, input_path, output_path, compressing: bool, duration_s: float) -> None:
        import os

        from ..models import CompressionMetrics, MetricsService, OperationType

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
                backend=self.get_service_name().split()[0].upper(),
            )
        )
