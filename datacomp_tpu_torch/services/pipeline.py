"""Shared chunked compression pipeline.

The port's copy of ``datacomp_tpu/services/pipeline.py``, which writes the
same ``.dcz`` bytes (``tests/test_torch_host.py`` holds the two to that).

File orchestration common to the host and GPU services: chunk scheduling with a
worker pool and ordered streaming writes (the reference's sliding-window
scheduler, ``gpu/GpuCompressionService.java:232-320``), dual-format container
reads, SHA-256 integrity, progress callbacks, stage metrics, and a *real*
``resume_compression`` (the reference stubs it,
``cpu/CpuCompressionService.java:635-641``) backed by an append-only sidecar
progress file written alongside the output.

Per-chunk compute is delegated to a :class:`ChunkCodec`, so the host service
(numpy + native C++) and the GPU service (CUDA kernels) share everything else.
A device codec may take several chunks per call (:attr:`ChunkCodec.batch_chunks`,
:meth:`ChunkCodec.encode_chunk_batch`, :meth:`ChunkCodec.decode_chunk_batch`);
the pipeline groups its jobs by that count.
"""

from __future__ import annotations

import abc
import contextlib
import os
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..config import AppConfig
from ..core import container as ct
from ..core.huffman import CorruptChunkError
from ..models import Stage, StageMetrics
from ..models.stage_metrics import current_span, span
from ..utils.checksum import compute_sha256, sha256_digest
from .base import ProgressCallback

PARTIAL_MAGIC = 0x44435A50  # "DCZP"
PARTIAL_SUFFIX = ".partial"


@dataclass
class EncodedChunk:
    payload: bytes
    code_lengths: np.ndarray  # int32[256]
    sha256: bytes
    gap_bits: Optional[np.ndarray] = None  # uint32, v2 only


class ChunkCodec(abc.ABC):
    """Per-chunk compute backend."""

    #: chunks encoded per :meth:`encode_chunk_batch` call.  Device codecs
    #: raise this to vmap several chunks into ONE device program, amortizing
    #: per-program dispatch + transfer-call overhead (the role of the
    #: reference's sliding-window device scheduler,
    #: ``gpu/GpuCompressionService.java:232-320``); the pipeline groups its
    #: jobs accordingly.
    batch_chunks: int = 1

    def close(self) -> None:
        """Release what the codec holds (nothing, by default)."""

    @abc.abstractmethod
    def encode_chunk(self, data: np.ndarray, metrics: StageMetrics) -> EncodedChunk:
        ...

    def encode_chunk_batch(
        self, datas: List[np.ndarray], metrics: StageMetrics
    ) -> List[EncodedChunk]:
        """Encode several chunks; default = per-chunk loop (host codecs)."""
        return [self.encode_chunk(d, metrics) for d in datas]

    @abc.abstractmethod
    def decode_chunk(
        self, payload: bytes, meta: ct.ChunkMeta, header: ct.ContainerHeader,
        metrics: StageMetrics,
    ) -> np.ndarray:
        ...

    def decode_chunk_batch(
        self, payloads: List[bytes], metas: List[ct.ChunkMeta],
        header: ct.ContainerHeader, metrics: StageMetrics,
    ) -> List[np.ndarray]:
        """Decode several chunks; default = per-chunk loop (host codecs).
        Device codecs override to vmap compatible chunks into one program
        (same dispatch-amortization story as :meth:`encode_chunk_batch`)."""
        return [
            self.decode_chunk(p, m, header, metrics)
            for p, m in zip(payloads, metas)
        ]


# ---------------------------------------------------------------------------
# Sidecar progress file (resume support)
# ---------------------------------------------------------------------------


def _partial_path(output_path: str) -> str:
    return output_path + PARTIAL_SUFFIX


def _write_partial_header(fp, header: ct.ContainerHeader) -> None:
    name = header.original_file_name.encode("utf-8")
    fp.write(struct.pack(">iii", PARTIAL_MAGIC, header.version, len(name)))
    fp.write(name)
    fp.write(
        struct.pack(
            ">qqii",
            header.original_file_size,
            header.original_timestamp,
            header.chunk_size_bytes,
            header.subblock_symbols,
        )
    )


def _append_partial_chunk(fp, c: ct.ChunkMeta) -> None:
    fp.write(
        struct.pack(
            ">iqiqi", c.index, c.original_offset, c.original_size,
            c.compressed_offset, c.compressed_size,
        )
    )
    fp.write(c.sha256)
    fp.write(c.code_lengths.astype(">i2").tobytes())
    gaps = c.gap_bits if c.gap_bits is not None else np.zeros(0, np.uint32)
    fp.write(struct.pack(">i", len(gaps)))
    fp.write(np.asarray(gaps, dtype=">u4").tobytes())
    fp.flush()


def read_partial(path: str):
    """Parse a sidecar file → (header, [ChunkMeta...]); truncated trailing
    records are dropped (crash-safe append-only log)."""
    with open(path, "rb") as f:
        data = f.read()
    r = ct._Reader(data)
    magic = r.i32()
    if magic != PARTIAL_MAGIC:
        raise ct.ContainerError("not a .dcz partial progress file")
    version = r.i32()
    name_len = r.i32()
    try:
        name = r.take(name_len).decode("utf-8")
    except UnicodeDecodeError as e:  # torn sidecar write
        raise ct.ContainerError(f"invalid partial-file name encoding: {e}") from e
    size = r.i64()
    ts = r.i64()
    chunk_size = r.i32()
    subblock = r.i32()
    header = ct.ContainerHeader(
        original_file_name=name, original_file_size=size, original_timestamp=ts,
        global_sha256=b"\x00" * 32, chunk_size_bytes=chunk_size,
        version=version, subblock_symbols=subblock,
    )
    chunks: List[ct.ChunkMeta] = []
    while True:
        start = r.off
        try:
            idx = r.i32()
            oo = r.i64()
            osz = r.i32()
            co = r.i64()
            cs = r.i32()
            sha = r.take(32)
            lens = np.frombuffer(r.take(512), dtype=">i2").astype(np.int32)
            ngaps = r.i32()
            gaps = np.frombuffer(r.take(4 * ngaps), dtype=">u4").astype(np.uint32) if ngaps else None
        except ct.ContainerError:
            r.off = start
            break
        chunks.append(ct.ChunkMeta(idx, oo, osz, co, cs, sha, lens, gaps))
    return header, chunks


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


class ChunkedPipeline:
    def __init__(self, config: AppConfig, codec: ChunkCodec, workers: Optional[int] = None):
        self.config = config
        self.codec = codec
        self.workers = workers or config.effective_cpu_threads()
        self._executor = ThreadPoolExecutor(max_workers=self.workers)
        # Hard backpressure for compress: at most `window` chunks may be
        # in flight (running OR completed-but-unwritten) at once, so a slow
        # head-of-line chunk (e.g. one deep-codebook package-merge among
        # raw-store neighbors) cannot balloon RSS with finished payloads.
        # 2x workers keeps the pool fed across the ordered writer's stalls —
        # the reference's sliding-window scheduler bounds in-flight chunks
        # the same way (gpu/GpuCompressionService.java:232-320).
        self.window = max(2 * self.workers, 4)
        self._closed = False

    # -- compress -----------------------------------------------------------

    def compress(
        self, input_path: str, output_path: str, progress: ProgressCallback = None,
        metrics: Optional[StageMetrics] = None, resume_from: int = 0,
        resume_chunks: Optional[List[ct.ChunkMeta]] = None,
    ) -> StageMetrics:
        metrics = metrics if metrics is not None else StageMetrics()
        chunk_size = self.config.chunk_size_bytes
        file_size = os.path.getsize(input_path)
        num_chunks = (file_size + chunk_size - 1) // chunk_size
        version = self.config.compression.format_version
        subblock = self.config.compression.subblock_symbols if version >= 2 else 0

        header = ct.ContainerHeader(
            original_file_name=os.path.basename(input_path),
            original_file_size=file_size,
            original_timestamp=int(os.path.getmtime(input_path) * 1000),
            global_sha256=b"\x00" * 32,
            chunk_size_bytes=chunk_size,
            version=version,
            subblock_symbols=subblock,
        )

        done: List[ct.ChunkMeta] = list(resume_chunks or [])
        if len(done) != resume_from:
            raise ValueError("resume metadata does not match resume_from")
        compressed_offset = done[-1].compressed_offset + done[-1].compressed_size if done else 0

        read_lock = threading.Lock()
        with span("open"):
            infile = open(input_path, "rb")
            # memory-mapped reads (reference parity: compression.use-memory-mapped-io)
            mm = None
            if self.config.compression.use_memory_mapped_io and file_size > 0:
                try:
                    import mmap as _mmap

                    mm = _mmap.mmap(infile.fileno(), 0, access=_mmap.ACCESS_READ)
                except (OSError, ValueError):
                    mm = None
        partial_fp = None
        try:
            out_mode = "r+b" if resume_from > 0 and os.path.exists(output_path) else "wb"
            with span("open"):
                out = open(output_path, out_mode)
            with out:
                if out_mode == "r+b":
                    with span("open"):
                        out.truncate(compressed_offset)
                        out.seek(compressed_offset)
                partial = _partial_path(output_path)
                with span("sidecar"):
                    if resume_from > 0 and os.path.exists(partial):
                        partial_fp = open(partial, "r+b")
                        partial_fp.seek(0, 2)
                    else:
                        partial_fp = open(partial, "wb")
                        _write_partial_header(partial_fp, header)
                        for c in done:
                            _append_partial_chunk(partial_fp, c)

                def read_chunk(index: int):
                    offset = index * chunk_size
                    n = min(chunk_size, file_size - offset)
                    with metrics.timed(Stage.FILE_IO, n, span="read"):
                        if mm is not None:
                            # one explicit copy pins a consistent per-chunk
                            # snapshot: the chunk's SHA-256, codebook, payload
                            # and raw-store bytes must all come from the same
                            # data even if another process rewrites the input
                            # mid-compress (a zero-copy view here once let
                            # sha and payload diverge, bricking the archive)
                            data = np.frombuffer(
                                mm, dtype=np.uint8, count=n, offset=offset
                            ).copy()
                        else:
                            with read_lock:
                                infile.seek(offset)
                                data = np.frombuffer(infile.read(n), dtype=np.uint8)
                    return index, offset, n, data

                def job(indices: List[int], parent):
                    with span("job", parent=parent, job=True, chunks=indices) as recording:
                        reads = [read_chunk(i) for i in indices]
                        if recording is not None:
                            recording.nbytes = sum(r[2] for r in reads)
                        encs = self.codec.encode_chunk_batch(
                            [r[3] for r in reads], metrics
                        )
                    return [
                        (i, o, n, e) for (i, o, n, _), e in zip(reads, encs)
                    ]

                # group chunk indices into codec-sized batches, then run a
                # bounded sliding window of batch jobs: submit up to
                # `window` CHUNKS worth of jobs (the backpressure bound is
                # counted in chunks, so batch codecs don't inflate it by
                # their batch factor), one-in-one-out as the ordered writer
                # drains the head
                from collections import deque
                from itertools import islice

                bs = max(1, getattr(self.codec, "batch_chunks", 1))
                idx_it = iter(range(resume_from, num_chunks))
                todo = iter(
                    lambda: list(islice(idx_it, bs)), []
                )  # consecutive index groups of size <= bs
                # floor division keeps the chunk bound tight, but batch
                # codecs need >= 2 jobs in flight or the host prepass
                # (sha256 + host histogram) never overlaps device encode
                # and the sliding window degenerates to fully serial
                # (round-3 advisor finding: window=4, bs=4 -> 1 job).  For
                # bs > 1 the bound is therefore 2 batches (2*bs chunks) of
                # buffered payloads — the price of overlap.
                window_jobs = max(2 if bs > 1 else 1, self.window // bs)
                request = current_span()
                inflight = deque(
                    self._executor.submit(job, g, request)
                    for g in islice(todo, window_jobs)
                )
                while inflight:
                    with span("wait"):
                        results = inflight.popleft().result()
                    nxt = next(todo, None)
                    if nxt is not None:
                        inflight.append(self._executor.submit(job, nxt, request))
                    for index, offset, n, enc in results:
                        with metrics.timed(Stage.FILE_IO, len(enc.payload), span="write"):
                            out.write(enc.payload)
                        meta = ct.ChunkMeta(
                            index, offset, n, compressed_offset, len(enc.payload),
                            enc.sha256, enc.code_lengths, enc.gap_bits,
                        )
                        compressed_offset += len(enc.payload)
                        done.append(meta)
                        with span("sidecar"):
                            _append_partial_chunk(partial_fp, meta)
                        if progress is not None:
                            progress(len(done) / max(num_chunks, 1))
                    results = None  # payloads may be zero-copy views over `mm`

                with span("footer"):
                    # global checksum = sha256 over per-chunk digests in order
                    # (reference parity: CpuCompressionService.java:101-126)
                    g = sha256_digest()
                    for c in done:
                        g.update(c.sha256)
                    header.global_sha256 = g.digest()
                    header.chunks = done

                    with metrics.timed(Stage.HEADER_WRITE, span="footer"):
                        footer_start = compressed_offset
                        out.write(ct.serialize_footer(header))
                        out.write(struct.pack(">q", footer_start))
                        out.flush()
            with span("footer"):
                partial_fp.close()
                partial_fp = None
                os.remove(_partial_path(output_path))
        finally:
            if mm is not None:
                try:
                    mm.close()
                except BufferError:
                    # a chunk view escaped (e.g. an exception mid-stream);
                    # GC closes the map once the last view dies
                    pass
            infile.close()
            if partial_fp is not None:
                partial_fp.close()
        return metrics

    def resume_compression(
        self, input_path: str, output_path: str, last_completed_chunk: int,
        progress: ProgressCallback = None, metrics: Optional[StageMetrics] = None,
    ) -> StageMetrics:
        """Resume using the sidecar progress log.  ``last_completed_chunk`` is
        the highest chunk index known good (−1 ⇒ restart); chunks beyond it in
        the sidecar are discarded."""
        partial = _partial_path(output_path)
        if not os.path.exists(partial):
            raise FileNotFoundError(
                f"no partial progress file for {output_path}; cannot resume"
            )
        saved_header, chunks = read_partial(partial)
        keep = min(last_completed_chunk + 1, len(chunks))
        chunks = chunks[:keep]
        # sanity: the partial log must match this input and config
        if saved_header.original_file_size != os.path.getsize(input_path):
            raise ValueError("input file size changed since partial compression")
        if saved_header.chunk_size_bytes != self.config.chunk_size_bytes:
            raise ValueError("chunk size changed since partial compression")
        if keep < len(read_partial(partial)[1]):
            # rewrite the sidecar truncated to `keep` records
            with open(partial, "wb") as f:
                _write_partial_header(f, saved_header)
                for c in chunks:
                    _append_partial_chunk(f, c)
        return self.compress(
            input_path, output_path, progress=progress, metrics=metrics,
            resume_from=keep, resume_chunks=chunks,
        )

    # -- decompress ---------------------------------------------------------

    def decompress(
        self, input_path: str, output_path: str, progress: ProgressCallback = None,
        metrics: Optional[StageMetrics] = None,
    ) -> StageMetrics:
        metrics = metrics if metrics is not None else StageMetrics()
        with metrics.timed(Stage.FILE_IO, span="open"):
            header, data_start = ct.read_container(input_path)
        num_chunks = header.num_chunks
        completed = 0
        # Fully parallel pipeline: every chunk's original offset is in the
        # metadata, so each job does a lock-free positional read, decode,
        # verify AND positional write — no ordering barrier anywhere (the
        # reference serializes ordered batch writes,
        # CpuCompressionService.java:398-490).
        with contextlib.ExitStack() as files:
            with span("open"):
                in_fd = files.enter_context(open(input_path, "rb")).fileno()
                out = files.enter_context(open(output_path, "wb"))
                out.truncate(header.original_file_size)
            out_fd = out.fileno()

            def job(group: List[ct.ChunkMeta], parent):
                with span("job", parent=parent, job=True) as recording:
                    if recording is not None:
                        recording.nbytes = sum(c.original_size for c in group)
                        recording.chunks = tuple(c.index for c in group)
                    payloads = []
                    for c in group:
                        with metrics.timed(Stage.FILE_IO, c.compressed_size, span="pread"):
                            payload = os.pread(
                                in_fd, c.compressed_size, data_start + c.compressed_offset
                            )
                        if len(payload) != c.compressed_size:
                            raise IOError(f"short read on chunk {c.index}")
                        payloads.append(payload)
                    datas = self.codec.decode_chunk_batch(payloads, group, header, metrics)
                    for c, data in zip(group, datas):
                        if data.size != c.original_size:
                            raise IOError(f"size mismatch in chunk {c.index}")
                        with metrics.timed(Stage.CHECKSUM_VERIFY, data.size, span="verify"):
                            digest = compute_sha256(data)  # buffer protocol, no copy
                            if digest != c.sha256:
                                raise IOError(
                                    f"Checksum mismatch in chunk {c.index}: "
                                    f"expected {c.sha256.hex()}, got {digest.hex()} "
                                    f"(chunk {c.original_size} B, compressed "
                                    f"{c.compressed_size} B)"
                                )
                        with metrics.timed(Stage.FILE_IO, data.size, span="pwrite"):
                            os.pwrite(out_fd, data, c.original_offset)
                return len(group)

            # group consecutive chunks into codec-sized batches (size 1 for
            # host codecs — identical to the per-chunk pipeline); jobs stay
            # fully parallel and barrier-free either way
            bs = max(1, getattr(self.codec, "batch_chunks", 1))
            groups = [
                list(header.chunks[i : i + bs])
                for i in range(0, len(header.chunks), bs)
            ]
            request = current_span()
            futures = [self._executor.submit(job, g, request) for g in groups]
            for fut in futures:
                with span("wait"):
                    completed += fut.result()
                if progress is not None:
                    progress(completed / max(num_chunks, 1))
        return metrics

    # -- verify -------------------------------------------------------------

    def verify_integrity(self, compressed_path: str, deep: bool = False) -> bool:
        try:
            header, data_start = ct.read_container(compressed_path)
        except ct.ContainerError:
            found = ct.scan_for_footer(compressed_path)
            if found is None:
                return False
            header, footer_off = found
            if footer_off == 0:
                # legacy header-first layout: payloads are at the END of the
                # file (CpuCompressionService.java:328-393) — data_start=0
                # would deep-verify the wrong byte ranges
                data_start = (
                    os.path.getsize(compressed_path)
                    - header.total_compressed_size()
                )
                if data_start < 0:
                    return False
            else:
                data_start = 0
        total = os.path.getsize(compressed_path)
        expected_payload = header.total_compressed_size()
        if data_start + expected_payload > total:
            return False
        g = sha256_digest()
        for i, c in enumerate(header.chunks):
            if c.index != i or c.compressed_size < 0 or c.original_size < 0:
                return False
            g.update(c.sha256)
        if header.chunks and g.digest() != header.global_sha256:
            return False
        if deep:
            metrics = StageMetrics()
            with open(compressed_path, "rb") as f:
                fd = f.fileno()

                def check(c: ct.ChunkMeta) -> bool:
                    payload = os.pread(fd, c.compressed_size, data_start + c.compressed_offset)
                    try:
                        data = self.codec.decode_chunk(payload, c, header, metrics)
                    except CorruptChunkError:  # the JAX copy catches every Exception
                        return False
                    return compute_sha256(data) == c.sha256

                futures = [self._executor.submit(check, c) for c in header.chunks]
                results = [fut.result() for fut in futures]  # a device error propagates
                if not all(results):
                    return False
        return True

    def close(self) -> None:
        if not self._closed:
            self._executor.shutdown(wait=True)
            self._closed = True
