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
* decode: raw-stored chunks pass through; chunks with codes of at most 16
  bits run the gap-array decoder kernel K3, a v2 chunk from its stored gap
  array and a v1 chunk from the one the gap finder K5 finds on the device
  first; deeper codebooks go to the host codec through a counted route
  (``host_decode_routes``), its bit decoding a ``host_decode`` span of stage
  DECODING;
* the chunk's SHA-256, in either mode: on a helper thread of the codec's
  own from :data:`INLINE_HASH_BYTES` up, while the worker goes on with the
  prepass and the device encode, joined when the chunk is built;
* availability: a 1 KB histogram on the device (kernel K1);
* batches (``device.batch_chunks``, auto 4 on a CUDA device): the pipeline
  hands the codec groups of chunks, and each group's device members run
  every kernel once (``histogram_batch``, ``codebook_batch``,
  ``encode_batch``, ``decode_batch``), with one upload and one copy back, as
  ``TpuChunkCodec.encode_chunk_batch`` and ``decode_chunk_batch`` do.  A
  lone chunk is a group of one: ``encode_chunk`` and ``decode_chunk`` take
  the same path.

Unlike the JAX service, whose ``device.fallback_on_error`` is on by default,
there is no fallback to the CPU: a device error propagates, and a config
that sets ``fallback_on_error`` is refused.  The device is
``config.device.platform`` unless the caller names one; ``"cpu"`` runs the
kernels' plain PyTorch versions.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import Future, ThreadPoolExecutor, wait
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import AppConfig, load_config
from ..core import container as ct, huffman
from ..core.huffman import CorruptChunkError
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
    codebook_batch,
    decode_batch,
    encode_batch,
    find_gaps,
    gap_finder_fits,
    gap_offsets,
    histogram,
    histogram_batch,
    max_code_len,
    payload_to_words,
    words_to_bytes,
)
from ..models.stage_metrics import current_span, span
from ..ops._build import LaunchCounter
from ..utils.checksum import compute_sha256
from .base import CompressionService, FrequencyService, ProgressCallback
from .cpu_service import CpuChunkCodec
from .pipeline import ChunkCodec, ChunkedPipeline, EncodedChunk

#: chunks that bypassed the device because of their codebook.  Nothing
#: increments ``host_encode_routes``: a host codebook deeper than the
#: encoder's 32 bits never exists (``build_code_lengths`` raises past 32
#: bits), so every chunk encodes on the device; readers of the counts keep it
host_encode_routes = LaunchCounter()
host_decode_routes = LaunchCounter()  # the chunks decode_route sends to the host

#: chunks of fewer bytes are hashed on their worker.  On the H100 host
#: (gVisor, 8 vCPUs) handing a hash to a helper thread and joining it costs
#: 20-36 us at the median (a futex wake each way), and SHA-256 runs at
#: 1.1-1.3 GB/s: 64 KiB takes 52-60 us, the smallest power of two whose hash
#: outlasts the median hand-off in every reading (32 KiB takes 27-30 us).
#: The worker pays only the submit and, if the hash is still running, the
#: join, so from here up the hand-off takes time off the critical path.
#: ``tools/hash_handoff.py`` measures both.
INLINE_HASH_BYTES = 64 << 10

#: symbols a sub-block when a format-1 chunk decodes on the device: K5 finds
#: the start of each, and K3 decodes them; format 2's default, for which K3's
#: staged route is sized (``csrc/decode.cu``)
FORMAT1_SUBBLOCK = 4032


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


def _settle(shas: list) -> None:
    """Cancel the hashes of ``shas`` (digests, or futures of them) that have
    not started and wait for those running: no job ends with its hash under
    way, whatever it raised."""
    pending = [f for f in shas if isinstance(f, Future)]
    for f in pending:
        f.cancel()
    wait(pending)


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


def decode_route(meta, header) -> str:
    """Where a chunk restores, for every codec path: ``"raw"`` (a v2 chunk
    stored raw passes through), ``"device"`` (codes of 1 to 16 bits: K3,
    from the stored gap array in v2 and from the gap finder K5's in v1, whose
    bits must fit K5's uint32 gaps) or ``"host"`` (the counted host route:
    deeper codes, a v2 chunk without a gap array, a v1 stream too long for
    K5, an empty v1 chunk)."""
    v2 = header.version >= ct.VERSION_V2
    if v2 and not meta.code_lengths.any() and meta.compressed_size == meta.original_size:
        return "raw"
    if not 0 < max_code_len(meta.code_lengths) <= TABLE_BITS:
        return "host"
    if v2:
        fits = meta.gap_bits is not None and meta.gap_bits.size > 0 and header.subblock_symbols > 0
    else:
        fits = gap_finder_fits(-(-meta.compressed_size // 4) + 2, meta.original_size)
    return "device" if fits else "host"


def upload_rows(datas: list, row_bytes: int, device) -> torch.Tensor:
    """The chunks as the rows of one uint8[len(datas), row_bytes] tensor on
    ``device``: each copied into its row, the row's tail zeroed on the
    device.  A group's rows are its live members only: the JAX service pads
    a group with empty chunks up to ``batch_chunks`` rows so that one static
    executable serves every group, and an empty row encodes to nothing, so
    leaving them out changes no byte."""
    x = torch.empty((len(datas), row_bytes), dtype=torch.uint8, device=device)
    for row, data in zip(x, datas):
        row[: data.size].copy_(_host_tensor(data))
        row[data.size :].zero_()
    return x


def decode_inputs(payloads, metas, tables, device) -> tuple:
    """The rows' streams, gap arrays and decode tables on ``device``, in one
    copy: ``(words, word_offsets, gaps, gap_offsets, limits, adj, sym)`` as
    :func:`ops.decode_batch` takes them; a chunk without a gap array (v1) has
    an empty one."""
    rows = len(metas)
    words = [payload_to_words(p).view(np.int32) for p in payloads]
    gaps = [np.zeros(0, np.int32) if m.gap_bits is None
            else m.gap_bits.astype(np.uint32).view(np.int32) for m in metas]
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


class PreparedChunk(NamedTuple):
    """A chunk bound for the device after its host prepass."""

    data: np.ndarray
    sha: object  # its digest, or the future of one
    lengths: Optional[np.ndarray]  # the host codebook; None where the device builds it
    codes: Optional[np.ndarray]
    #: the chunk's exact encoded size under its codebook; in device-codebook
    #: v1 None until K4's lengths come back
    opt_bits: Optional[int]


class GpuChunkCodec(ChunkCodec):
    """Device codec for groups of chunks, a lone chunk being a group of one:
    host codebook → encode (K2), or in device-codebook mode histogram (K1) →
    codebook (K4) → encode (K2) on the device; gap-array decode (K3), from
    the stored gap arrays in v2 containers and from the gap finder's (K5) in
    v1.  Each group launches every kernel's batched entry point once for all
    of its device members, with one upload and one copy back."""

    def __init__(self, config: AppConfig, device: torch.device):
        self.config = config
        self.device = device
        self.freq = GpuFrequencyService(config, device)
        self._cpu = CpuChunkCodec(config)  # host histogram and deep decode
        self.padded_size = config.chunk_size_bytes
        self.subblock = config.compression.subblock_symbols
        # an optimal code spends at most H + 1 <= 9 bits a byte on the chunk
        # it was built from; the encode raises if a stream ever exceeds this
        self.out_words = (9 * self.padded_size + 31) // 32 + 2
        # the chunks' SHA-256, one after another beside the workers: on the
        # H100 host four at once ran no faster and their rates spread wider;
        # not the pipeline's pool, whose workers wait on these
        self._hashes = ThreadPoolExecutor(max_workers=1, thread_name_prefix="dcz-sha256")

    @property
    def batch_chunks(self) -> int:
        return resolve_batch_chunks(self.config.device.batch_chunks, self.device)

    def close(self) -> None:
        """Shut the hash pool down."""
        self._hashes.shutdown(wait=True)

    # -- encode -------------------------------------------------------------

    def _start_hash(self, data: np.ndarray, metrics: StageMetrics):
        """The chunk's SHA-256, started: a future on the hash pool, whose
        ``sha256`` span takes the span open on this thread (the job) as its
        parent; a chunk under :data:`INLINE_HASH_BYTES` is hashed here and
        its digest returned."""
        if data.size < INLINE_HASH_BYTES:
            return self._hash(data, metrics, None)
        return self._hashes.submit(self._hash, data, metrics, current_span())

    @staticmethod
    def _hash(data: np.ndarray, metrics: StageMetrics, parent) -> bytes:
        with metrics.timed(Stage.CHECKSUM_COMPUTE, data.size, parent=parent):
            return compute_sha256(data)

    @staticmethod
    def _joined(encs: list) -> list:
        """``encs`` with each digest still a future read from it, the wait
        for them a ``wait`` span (a hash's error raises here)."""
        pending = [e for e in encs if isinstance(e.sha256, Future)]
        if pending:
            with span("wait"):
                for e in pending:
                    e.sha256 = e.sha256.result()
        return encs

    def _host_prepass(self, data: np.ndarray, sha, metrics: StageMetrics):
        """Host histogram, host codebook and the raw-store decision
        (``TpuChunkCodec._host_prepass``); ``sha`` is the chunk's digest, or
        the future of one, and passes through.

        Returns a complete :class:`EncodedChunk` for a chunk that never
        touches the device (empty input, or an incompressible v2 chunk stored
        raw), else a :class:`PreparedChunk`.  In device-codebook mode its
        ``lengths`` and ``codes`` are None; in v2 ``opt_bits`` then comes
        from the uncapped host ``fast`` code, an optimal code over the same
        histogram as the device's, and v1 has neither histogram nor
        ``opt_bits``."""
        n = data.size
        comp = self.config.compression
        device_codebook = comp.codebook_mode == "device"
        v2 = comp.format_version >= 2
        if n == 0:
            return EncodedChunk(b"", np.zeros(256, np.int32), sha, None)
        if device_codebook and not v2:
            return PreparedChunk(data, sha, None, None, None)
        with metrics.timed(Stage.FREQUENCY_ANALYSIS, n):
            hist = self._cpu.freq.compute_histogram(data)
        lengths = codes = None
        with metrics.timed(Stage.HUFFMAN_TREE_BUILD, n):
            if device_codebook:  # raises, as the host codec does, past 32 bits
                opt_lengths = huffman.build_code_lengths(hist, mode="fast")
            else:  # raises past 32 bits too, so K2 always takes the codebook
                lengths, codes = huffman.build_codebook(
                    hist, mode=comp.codebook_mode, max_len=comp.effective_max_code_len(),
                )
                opt_lengths = lengths
        opt_bits = int(hist @ opt_lengths.astype(np.int64))
        if v2 and opt_bits >= n * 8:
            # incompressible: store raw (v2 marker: all-zero lengths)
            return EncodedChunk(data.tobytes(), np.zeros(256, np.int32), sha, None)
        return PreparedChunk(data, sha, lengths, codes, opt_bits)

    def encode_chunk(self, data: np.ndarray, metrics: StageMetrics) -> EncodedChunk:
        """A group of one."""
        return self.encode_chunk_batch([data], metrics)[0]

    def encode_chunk_batch(self, datas, metrics: StageMetrics) -> list:
        """Encode a group of chunks (``TpuChunkCodec.encode_chunk_batch``):
        its device members in one launch of each kernel (:meth:`_encode_rows`)."""
        return self.encode_group(datas, metrics, self._encode_rows)

    def encode_group(self, datas, metrics: StageMetrics, encode_rows) -> list:
        """The host side of a group's encode, and the mesh route's seam into
        the codec (``parallel/multihost.py``, which puts the device members
        on a device each).

        Every member's SHA-256 starts on the hash pool, then each member's
        host prepass runs: empty and raw-stored members are finished there,
        and ``encode_rows(members, metrics)`` turns the others, a list of
        :class:`PreparedChunk` in order, into their :class:`EncodedChunk`.
        The digests are joined once every member is built, and no hash is
        left running whatever is raised."""
        shas = [self._start_hash(d, metrics) for d in datas]
        try:
            results = [self._host_prepass(d, sha, metrics) for d, sha in zip(datas, shas)]
            rows = [i for i, r in enumerate(results) if isinstance(r, PreparedChunk)]
            if rows:
                for i, enc in zip(rows, encode_rows([results[i] for i in rows], metrics)):
                    results[i] = enc
            return self._joined(results)
        finally:
            _settle(shas)

    def _encode_rows(self, members: list, metrics: StageMetrics) -> list:
        """The device members of a group (one codebook mode for all), each
        kernel launched once: with host codebooks (``java``/``fast``) the
        codebooks go up in one copy; in device-codebook v2 K1 → K4 build them
        with nothing fetched; in v1 one copy brings back K1's histograms and
        K4's lengths, every member's depth is checked before K2 (the host
        codec's error past 32 bits) and they give its ``opt_bits``.  Then K2,
        and :meth:`unpack_rows`."""
        datas = [m.data for m in members]
        valid = [d.size for d in datas]
        n = sum(valid)
        v2 = self.config.compression.format_version >= 2
        host_codebook = members[0].lengths is not None
        fused = v2 and not host_codebook  # K1 → K4 → K2, nothing fetched in between
        if not (host_codebook or fused):
            with metrics.timed(Stage.FREQUENCY_ANALYSIS, n):
                with span("upload"):
                    x = upload_rows(datas, self.padded_size, self.device)
                with span("launch"):
                    hist_t = histogram_batch(x, valid)
            with metrics.timed(Stage.HUFFMAN_TREE_BUILD, n):
                with span("launch"):
                    lens_t, codes_t = codebook_batch(hist_t)
                with span("fetch"):
                    hist, lengths = torch.cat([hist_t, lens_t]).cpu().numpy().reshape(
                        2, len(members), 256)
                with span("unpack"):
                    for row in lengths:
                        _check_depth(row)
                    opt_bits = (hist.astype(np.int64) * lengths.astype(np.int64)).sum(1)
            members = [m._replace(lengths=lens, opt_bits=int(bits))
                       for m, lens, bits in zip(members, lengths, opt_bits)]
        with metrics.timed(Stage.ENCODING, n):
            if host_codebook or fused:
                with span("upload"):
                    x = upload_rows(datas, self.padded_size, self.device)
                    if host_codebook:
                        tables = np.stack([
                            np.stack([m.lengths for m in members]).astype(np.int32),
                            np.stack([m.codes for m in members]).astype(np.uint32).view(np.int32)])
                        t = _host_tensor(tables).to(self.device)  # int32[2, rows, 256]
                        lens_t, codes_t = t[0], t[1].view(torch.uint32)
            with span("launch"):
                if fused:
                    lens_t, codes_t = codebook_batch(histogram_batch(x, valid))
                words, totals, gaps = encode_batch(x, valid, lens_t, codes_t, self.out_words,
                                                   self.subblock if v2 else 0)
            return self.unpack_rows(members, words, totals, gaps, lens_t if fused else None)

    def unpack_rows(self, members: list, words, totals, gaps, lengths=None) -> list:
        """The :class:`EncodedChunk` of each of ``members`` from K2's outputs
        for their rows, in one copy back and one unpack: the mesh route's
        second seam into the codec.

        ``words``, ``totals`` and ``gaps`` (None in v1) are
        :func:`ops.encode_batch`'s for the members' rows, in order;
        ``lengths`` is the rows' int32[rows, 256] code lengths where the
        device built them, None where each member carries its own.  The copy
        brings back the totals, those lengths, each row's gap array and its
        live words, sized by the member's ``opt_bits``.  A device-built
        code's depth is checked (K4 does not cap it), and every total must
        equal the member's ``opt_bits``."""
        rows = len(members)
        nsubs = [] if gaps is None else [-(-m.data.size // self.subblock) for m in members]
        nws = [min((m.opt_bits + 31) // 32, self.out_words) for m in members]
        with span("fetch"):
            parts = [totals] + ([] if lengths is None else [lengths])
            parts += [gaps[b, :k] for b, k in enumerate(nsubs)]
            flat = _fetch(parts + [words[b, :k] for b, k in enumerate(nws)])
        with span("unpack"):
            tbs, lens, *pieces = _split(
                flat, [2 * rows, 0 if lengths is None else 256 * rows] + nsubs + nws)
            tbs, lens = tbs.view(np.int64), lens.reshape(-1, 256)
            gap_pieces, word_pieces = pieces[: len(nsubs)], pieces[len(nsubs) :]
            out = []
            for b, m in enumerate(members):
                code_lengths = (m.lengths if lengths is None else lens[b]).astype(np.int32)
                if lengths is not None:
                    _check_depth(code_lengths)
                tb = int(tbs[b])
                self._check_total(tb, m.opt_bits)
                gap_bits = gap_pieces[b].view(np.uint32).copy() if nsubs else None
                out.append(EncodedChunk(words_to_bytes(word_pieces[b].view(np.uint32), tb),
                                        code_lengths, m.sha, gap_bits))
        return out

    def _check_total(self, tb: int, opt_bits: int) -> None:
        if tb != opt_bits:
            raise RuntimeError(f"device encode wrote {tb} bits; the codebook predicts {opt_bits}")
        if tb > self.out_words * 32:
            raise RuntimeError("encoded stream exceeded device word capacity")

    # -- decode -------------------------------------------------------------

    def decode_chunk(self, payload, meta, header, metrics: StageMetrics) -> np.ndarray:
        """A group of one."""
        return self.decode_chunk_batch([payload], [meta], header, metrics)[0]

    def decode_chunk_batch(self, payloads, metas, header, metrics: StageMetrics) -> list:
        """Decode a group of chunks (``TpuChunkCodec.decode_chunk_batch``),
        each member as :func:`decode_route` sends it: raw-stored members pass
        through, the host route's go to the host codec one after another, and
        the device members to one launch of K3 (after one of K5 in v1),
        whatever their depth.  The JAX service groups by its decoder's static
        parameters and decodes v1 on the host; K3 and K5 read each member's
        tables at run time."""
        results: list = [None] * len(metas)
        rows = []
        for j, (p, m) in enumerate(zip(payloads, metas)):
            route = decode_route(m, header)
            if route == "raw":
                with metrics.timed(Stage.DECODING, m.original_size):
                    results[j] = np.frombuffer(p, dtype=np.uint8)
            elif route == "host":
                host_decode_routes.add()
                results[j] = self._cpu.decode_chunk(p, m, header, metrics,
                                                    decode_span="host_decode")
            else:
                rows.append(j)
        if rows:
            outs = self._decode_rows([payloads[j] for j in rows], [metas[j] for j in rows],
                                     header, metrics)
            for j, out in zip(rows, outs):
                results[j] = out
        return results

    def _decode_rows(self, payloads, metas, header, metrics: StageMetrics) -> list:
        """Batched K3: the members' streams, gap arrays and tables go up in
        one copy, and their outputs come back in one.  A v1 group has no gap
        arrays to upload: K5 finds them on the device, and each member's end
        bit comes back with the outputs, held to its payload's length."""
        with metrics.timed(Stage.HUFFMAN_TREE_BUILD, span="decode_tables"):
            tables = [build_decode_tables(m.code_lengths) for m in metas]
        n_outs = [m.original_size for m in metas]
        total = sum(n_outs)
        with metrics.timed(Stage.DECODING, total):
            with span("upload"):
                words, word_offsets, gaps, offsets, *tables_t = decode_inputs(
                    payloads, metas, tables, self.device)
            with span("launch"):
                subblock, ends = header.subblock_symbols, None
                if header.version < ct.VERSION_V2:
                    subblock = FORMAT1_SUBBLOCK
                    gaps, ends = find_gaps(words, word_offsets, *tables_t, subblock, n_outs)
                    offsets = gap_offsets(n_outs, subblock)
                out = decode_batch(words, word_offsets, gaps, offsets, *tables_t, subblock,
                                   n_outs)
            with span("fetch"):
                if ends is not None:
                    out = torch.cat([out, ends.view(torch.uint8)])
                out = out.cpu().numpy()
            with span("unpack"):
                if ends is not None:
                    for m, p, end in zip(metas, payloads, out[total:].view(np.int64)):
                        if end > 8 * len(p):
                            raise CorruptChunkError(
                                f"chunk {m.index}: its {m.original_size} symbols end at bit "
                                f"{end}, past its {len(p)}-byte payload")
                return _split(out[:total], n_outs)


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
        with span("compress" if compressing else "decompress", request=True) as request:
            self._stage_metrics = StageMetrics()
            t0 = time.perf_counter()
            op(input_path, output_path, progress, self._stage_metrics)
            in_size = self._record(input_path, output_path, compressing,
                                   time.perf_counter() - t0)
            if request is not None:
                request.nbytes = in_size

    def compress(self, input_path, output_path, progress: ProgressCallback = None) -> None:
        self._run(self._pipeline.compress, input_path, output_path, progress, True)

    def decompress(self, input_path, output_path, progress: ProgressCallback = None) -> None:
        self._run(self._pipeline.decompress, input_path, output_path, progress, False)

    def resume_compression(self, input_path, output_path, last_completed_chunk, progress=None) -> None:
        with span("resume", request=True) as request:
            self._stage_metrics = StageMetrics()
            t0 = time.perf_counter()
            self._pipeline.resume_compression(
                input_path, output_path, last_completed_chunk, progress, self._stage_metrics
            )
            in_size = self._record(input_path, output_path, True, time.perf_counter() - t0)
            if request is not None:
                request.nbytes = in_size

    def verify_integrity(self, compressed_path, deep: bool = False) -> bool:
        return self._pipeline.verify_integrity(compressed_path, deep=deep)

    def get_service_name(self) -> str:
        return "GPU Compression"

    def is_available(self) -> bool:
        return self._codec.freq.is_available()

    def close(self) -> None:
        self._pipeline.close()
        self._codec.close()

    def _record(self, input_path, output_path, compressing, duration_s) -> int:
        """Adds the call to the MetricsService; returns its input bytes (0
        where the files cannot be read)."""
        try:
            in_size = os.path.getsize(input_path)
            out_size = os.path.getsize(output_path)
        except OSError:
            return 0
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
        return in_size
