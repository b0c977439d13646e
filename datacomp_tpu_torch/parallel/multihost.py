"""Compress and decompress one file across the ranks of a job and the
devices of a process (counterpart of ``datacomp_tpu/parallel/multihost.py``).

Every rank (one process; one GPU a rank under ``torchrun``, every visible
GPU in a lone process):

1. reads its round-robin stripe of the file's chunks (the input is visible
   to every rank: one host, or a shared filesystem);
2. encodes the stripe, spilling payloads to a file of its own: through its
   codec's ``encode_chunk_batch`` in groups of ``batch_chunks`` (the GPU
   codec: one launch of each batched kernel a group), or, with several
   local devices in device-codebook v2, in groups of one chunk a device
   through the codec's ``encode_group`` and the sharded compress step
   (:func:`_encode_rows_local`);
3. all-gathers every chunk's metadata (sizes, SHA-256, code lengths, gap
   arrays) over the gloo group, derives every chunk's offset identically
   (an exclusive scan in chunk order), and ``pwrite``s its payloads there;
   rank 0 appends the footer after a barrier.

Decompress needs no collective beyond two barriers: each rank decodes its
stripe through ``decode_chunk_batch`` (with several local devices, a v2
file's groups through the sharded decompress step,
:func:`_decode_group_local`) and writes the bytes at their recorded
offsets.  No collective across ranks runs inside the loop: stripes differ in
length and raw-stored chunks skip the device, so a collective a group would
leave ranks waiting on each other; the local paths run only in a job of one
rank.  The numpy helpers are this package's own copies of the JAX module's.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core import container as ct
from ..utils.checksum import sha256_digest
from .mesh import Mesh, local_devices, make_mesh, rank_device


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
) -> None:
    """Initialise ``torch.distributed`` from the arguments or ``torchrun``'s
    environment (``WORLD_SIZE``, ``RANK``; ``MASTER_ADDR`` and
    ``MASTER_PORT`` through the default ``env://``), the counterpart of
    ``multihost.py:35-53``.  A no-op at world size 1 or when a group exists.

    The rank's ``device`` (by default :func:`rank_device`'s) decides the
    backend, and nothing else does: ``"cpu:gloo,cuda:nccl"`` for a CUDA
    device, ``"gloo"`` for the CPU."""
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return
    if rank is None:
        rank = int(os.environ["RANK"])
    device = torch.device(device) if device is not None else rank_device()
    backend = "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


@dataclass(frozen=True)
class ChunkAssignment:
    """Which global chunk indices a host owns (round-robin striping keeps
    per-host loads balanced even when trailing chunks are small)."""

    host_id: int
    num_hosts: int
    num_chunks: int

    def local_chunks(self) -> List[int]:
        return list(range(self.host_id, self.num_chunks, self.num_hosts))

    @staticmethod
    def owner_of(chunk_index: int, num_hosts: int) -> int:
        return chunk_index % num_hosts


def global_offsets(sizes_by_chunk: Sequence[int]) -> np.ndarray:
    """Exclusive scan of compressed sizes in global chunk order — identical
    on every host given the all-gathered size vector."""
    sizes = np.asarray(sizes_by_chunk, dtype=np.int64)
    return np.cumsum(sizes) - sizes


def interleave_gathered(per_host_sizes: Sequence[Sequence[int]], num_chunks: int) -> np.ndarray:
    """Reassemble the global size vector from per-host stripes: host h's k-th
    local chunk is global chunk ``h + k*num_hosts``."""
    num_hosts = len(per_host_sizes)
    out = np.zeros(num_chunks, dtype=np.int64)
    for h, sizes in enumerate(per_host_sizes):
        idx = np.arange(h, num_chunks, num_hosts)
        out[idx] = np.asarray(sizes[: len(idx)], dtype=np.int64)
    return out


def write_host_payloads(
    output_path: str, payloads: Sequence[bytes], chunk_indices: Sequence[int],
    offsets: np.ndarray,
) -> None:
    """Positional writes of this host's chunk payloads at global offsets
    (every host writes disjoint ranges of the shared file)."""
    fd = os.open(output_path, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        for payload, ci in zip(payloads, chunk_indices):
            os.pwrite(fd, payload, int(offsets[ci]))
    finally:
        os.close(fd)


def spill_to_output(
    output_path: str, spill_path: str, chunk_indices: Sequence[int],
    local_sizes: Sequence[int], offsets: np.ndarray,
) -> None:
    """Copy this host's spilled payloads (written sequentially in local-chunk
    order during encode) to their global offsets in the shared output file,
    one bounded chunk-sized buffer at a time: global offsets exist only
    after the cross-process size all-gather, so payloads spill to a per-host
    file during encode instead of accumulating in memory."""
    fd = os.open(output_path, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        with open(spill_path, "rb") as sp:
            for k, ci in enumerate(chunk_indices):
                payload = sp.read(int(local_sizes[k]))
                if len(payload) != int(local_sizes[k]):
                    raise IOError(f"short read in payload spill for chunk {ci}")
                os.pwrite(fd, payload, int(offsets[ci]))
    finally:
        os.close(fd)


def write_footer_host0(
    output_path: str, header: ct.ContainerHeader, total_payload: int
) -> None:
    """Host 0 appends footer + pointer after all hosts' payload writes (a
    barrier between payload writes and this call is the caller's job)."""
    with open(output_path, "r+b") as f:
        f.seek(total_payload)
        f.write(ct.serialize_footer(header))
        f.write(struct.pack(">q", total_payload))
        f.truncate()


def assemble_header(
    input_name: str, file_size: int, mtime_ms: int, chunk_size: int,
    metas_by_index: Sequence[ct.ChunkMeta], version: int = ct.VERSION_V1,
    subblock: int = 0,
) -> ct.ContainerHeader:
    """Build the final header from per-chunk metadata in global order and
    derive the global checksum (sha256 over chunk digests in order)."""
    g = sha256_digest()
    for m in metas_by_index:
        g.update(m.sha256)
    h = ct.ContainerHeader(
        original_file_name=input_name,
        original_file_size=file_size,
        original_timestamp=mtime_ms,
        global_sha256=g.digest(),
        chunk_size_bytes=chunk_size,
        version=version,
        subblock_symbols=subblock,
    )
    h.chunks = list(metas_by_index)
    return h


def process_allgather(mesh: Mesh, a: np.ndarray) -> np.ndarray:
    """``a`` from every rank, stacked on a leading rank axis (the counterpart
    of ``multihost_utils.process_allgather``): its bytes go through the gloo
    group as a CPU tensor, so the array must have the same shape and dtype on
    every rank."""
    a = np.ascontiguousarray(a)
    if mesh.size == 1:
        return a[None, ...]
    mine = torch.from_numpy(a.reshape(-1).view(np.uint8).copy())
    parts = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(parts, mine, group=mesh.host_group)
    return np.stack([p.numpy().view(a.dtype).reshape(a.shape) for p in parts])


def _barrier(mesh: Mesh) -> None:
    if mesh.size > 1:
        dist.barrier(group=mesh.host_group)


def _codec(cfg, backend: str, mesh: Mesh):
    from ..services.cpu_service import CpuChunkCodec

    if backend == "gpu":
        from ..services.gpu_service import GpuChunkCodec

        return GpuChunkCodec(cfg, mesh.device)
    if backend != "cpu":
        raise ValueError(f"backend must be 'gpu' or 'cpu', got {backend!r}")
    return CpuChunkCodec(cfg)


def _default_mesh(cfg, backend: str) -> Mesh:
    return make_mesh(devices=("cpu",) if backend == "cpu" else local_devices(cfg))


def _encode_rows_local(step, codec, mesh: Mesh, members: list, metrics) -> list:
    """Encode up to one chunk a local device through the sharded compress
    step (``_encode_group_mesh``, ``multihost.py:163-227``): the
    ``encode_rows`` of :meth:`GpuChunkCodec.encode_group`, which has run
    the host prepass, so empty and raw-stored chunks skip the step and every
    byte equals the single-device service's.

    The members take one device each, in order, and a device without one
    gets a row of ``valid_len`` 0, which encodes to nothing.  Each device's
    row comes back through :meth:`GpuChunkCodec.unpack_rows` in one copy,
    its depth and total checked as the single-device path checks them.  The
    JAX step's device-side raw store (``multihost.py:211-216``) is not
    copied: the prepass has already stored raw every chunk whose optimal
    code needs 8 bits a byte, so that branch could only turn a wrong total
    into a different file."""
    from ..models import Stage
    from ..services.gpu_service import upload_rows

    devices = mesh.local_devices
    rows = [m.data for m in members] + [np.zeros(0, np.uint8)] * (len(devices) - len(members))
    with metrics.timed(Stage.ENCODING, sum(m.data.size for m in members)):
        shards = [upload_rows([row], codec.padded_size, dev) for row, dev in zip(rows, devices)]
        outs = step(shards, [row.size for row in rows], len(devices) * mesh.size)
        return [codec.unpack_rows([m], words, totals, gaps, lengths)[0]
                for m, (_, lengths, _, words, totals, gaps, _, _) in zip(members, outs)]


def _decode_group_local(step, codec, header, payloads, metas, metrics, mesh: Mesh) -> list:
    """Decode up to one chunk a local device through the sharded decompress
    step (``_decode_group_mesh``, ``multihost.py:402-483``).  Routing is the
    single-device codec's (``gpu_service.decode_route``): raw-stored chunks
    pass through, and the chunks it sends to the host (codes deeper than 16
    bits) take its counted host route (``GpuChunkCodec.decode_chunk``); the
    rest take one device each, in order, their stream, gap array and tables
    in one copy up and their bytes in one copy back.  A device without a
    chunk launches nothing."""
    from ..models import Stage
    from ..ops import build_decode_tables
    from ..services.gpu_service import decode_inputs, decode_route
    from .sharded import check_decompress_step_params

    live = [j for j, m in enumerate(metas) if decode_route(m, header) == "device"]
    results = [None if j in live else codec.decode_chunk(p, m, header, metrics)
               for j, (p, m) in enumerate(zip(payloads, metas))]
    if not live:
        return results
    s = header.subblock_symbols
    check_decompress_step_params([metas[j].code_lengths for j in live], s)
    with metrics.timed(Stage.HUFFMAN_TREE_BUILD):
        tables = [build_decode_tables(metas[j].code_lengths) for j in live]
    with metrics.timed(Stage.DECODING, sum(metas[j].original_size for j in live)):
        parts = [(*decode_inputs([payloads[j]], [metas[j]], [table], dev),
                  [metas[j].original_size])
                 for j, table, dev in zip(live, tables, mesh.local_devices)]
        outs = step(*zip(*parts))
        for j, out in zip(live, outs):
            results[j] = out.cpu().numpy()
    return results


def compress_multihost(
    input_path: str, output_path: str, config=None, backend: str = "gpu",
    mesh: Optional[Mesh] = None, progress=None, metrics=None,
) -> None:
    """Compress ``input_path`` into ``output_path`` across the mesh's ranks
    (``multihost.py:230``): every rank encodes its round-robin stripe through
    its codec's ``encode_chunk_batch`` in groups of ``batch_chunks``
    (``backend="gpu"``: :class:`GpuChunkCodec` on ``mesh.device``, whose
    groups run each batched kernel once and hash their chunks on the
    codec's helper thread; ``"cpu"``: the host codec), the
    chunks' metadata is all-gathered over the gloo group, every rank writes
    its payloads at their global offsets, and rank 0 appends the footer.
    With several local devices, the GPU backend and device-codebook v2 (the
    condition of ``multihost.py:294-300``), the stripe goes instead in
    groups of one chunk a device through the codec's ``encode_group``,
    whose hashes run on the same helper thread, and the sharded compress
    step (:func:`_encode_rows_local`).  The output equals the
    single-process, single-device pipeline's byte for byte.

    Every rank of the mesh calls this together.  Payloads spill to a file of
    the rank's own beside the output while the stripe encodes, so memory
    stays bounded by a group of chunks; the spill file is removed and the
    codec closed whatever happens.  ``progress`` (0..1 over this rank's
    stripe) and ``metrics`` (:class:`StageMetrics`) mirror the
    single-process service."""
    from ..config import load_config
    from ..models import Stage, StageMetrics

    cfg = config or load_config()
    mesh = mesh or _default_mesh(cfg, backend)
    metrics = metrics if metrics is not None else StageMetrics()
    rank, ranks = mesh.rank, mesh.size
    chunk_size = cfg.chunk_size_bytes
    version = cfg.compression.format_version
    subblock = cfg.compression.subblock_symbols if version >= ct.VERSION_V2 else 0
    file_size = os.path.getsize(input_path)
    num_chunks = (file_size + chunk_size - 1) // chunk_size
    G = (chunk_size + subblock - 1) // subblock if subblock else 0
    local = ChunkAssignment(rank, ranks, num_chunks).local_chunks()
    L = (num_chunks + ranks - 1) // ranks  # the padded stripe length
    codec = _codec(cfg, backend, mesh)
    on_mesh = len(mesh.local_devices) > 1 and backend == "gpu" and (
        cfg.compression.codebook_mode == "device" and version >= ct.VERSION_V2)
    if on_mesh:
        from .sharded import make_sharded_compress_step

        encode_rows = partial(_encode_rows_local,
                              make_sharded_compress_step(mesh, chunk_size, subblock), codec, mesh)
    group = len(mesh.local_devices) if on_mesh else max(1, codec.batch_chunks)

    spill_path = f"{output_path}.spill{rank}"
    sizes = np.zeros(L, np.int64)
    osz = np.zeros(L, np.int64)
    shas = np.zeros((L, 32), np.uint8)
    lens = np.zeros((L, 256), np.int32)
    ngaps = np.zeros(L, np.int32)
    gaps = np.zeros((L, max(G, 1)), np.uint32)
    try:
        with open(input_path, "rb") as f, open(spill_path, "wb") as spill:
            for g0 in range(0, len(local), group):
                gidx = local[g0 : g0 + group]
                datas = []
                for ci in gidx:
                    off = ci * chunk_size
                    n = min(chunk_size, file_size - off)
                    with metrics.timed(Stage.FILE_IO, n):
                        f.seek(off)
                        datas.append(np.frombuffer(f.read(n), dtype=np.uint8))
                if on_mesh:
                    encs = codec.encode_group(datas, metrics, encode_rows)
                else:
                    encs = codec.encode_chunk_batch(datas, metrics)
                for k, enc in zip(range(g0, g0 + len(gidx)), encs):
                    with metrics.timed(Stage.FILE_IO, len(enc.payload)):
                        spill.write(enc.payload)
                    sizes[k] = len(enc.payload)
                    osz[k] = datas[k - g0].size
                    shas[k] = np.frombuffer(enc.sha256, np.uint8)
                    lens[k] = enc.code_lengths
                    if enc.gap_bits is not None:
                        ngaps[k] = enc.gap_bits.size
                        gaps[k, : enc.gap_bits.size] = enc.gap_bits
                if progress is not None:
                    progress(min(g0 + len(gidx), len(local)) / max(len(local), 1))

        # every chunk's metadata on every rank (leading axis: rank)
        g_sizes, g_osz, g_shas, g_lens, g_ngaps, g_gaps = (
            process_allgather(mesh, a) for a in (sizes, osz, shas, lens, ngaps, gaps))
        sizes_global = interleave_gathered(list(g_sizes), num_chunks)
        offsets = global_offsets(sizes_global)
        total_payload = int(sizes_global.sum())
        with metrics.timed(Stage.FILE_IO, int(sizes[: len(local)].sum())):
            spill_to_output(output_path, spill_path, local, sizes[: len(local)], offsets)
    finally:
        codec.close()
        if os.path.exists(spill_path):
            os.remove(spill_path)
    _barrier(mesh)  # every payload is written
    if rank == 0:
        metas = []
        for ci in range(num_chunks):
            h, k = ChunkAssignment.owner_of(ci, ranks), ci // ranks
            gb = (
                np.asarray(g_gaps[h][k][: int(g_ngaps[h][k])], np.uint32)
                if subblock and int(g_ngaps[h][k]) else None
            )
            metas.append(
                ct.ChunkMeta(
                    ci, ci * chunk_size, int(g_osz[h][k]), int(offsets[ci]),
                    int(g_sizes[h][k]), bytes(np.asarray(g_shas[h][k], np.uint8)),
                    np.asarray(g_lens[h][k], np.int32), gb,
                )
            )
        header = assemble_header(
            os.path.basename(input_path), file_size,
            int(os.path.getmtime(input_path) * 1000), chunk_size, metas,
            version=version, subblock=subblock,
        )
        with metrics.timed(Stage.HEADER_WRITE):
            write_footer_host0(output_path, header, total_payload)
    _barrier(mesh)  # the footer is written


def decompress_multihost(
    input_path: str, output_path: str, config=None, backend: str = "gpu",
    mesh: Optional[Mesh] = None, progress=None, metrics=None,
) -> None:
    """Restore ``input_path`` into ``output_path`` across the mesh's ranks
    (``multihost.py:486``): rank 0 creates and sizes the output, then every
    rank decodes its round-robin stripe through its codec's
    ``decode_chunk_batch`` in groups of ``batch_chunks`` (the GPU codec:
    raw-stored chunks pass through, codes deeper than 16 bits take the
    counted host route, the rest one batched K3 launch a group, after one
    launch of the gap finder K5 in v1),
    checks each chunk's SHA-256 and ``pwrite``s it at its original offset.
    With several local devices and the GPU backend, a v2 file with
    sub-blocks (``multihost.py:532-539``) goes instead in groups of one
    chunk a device, its device members through the sharded decompress step
    (:func:`_decode_group_local`).  Every rank of the mesh calls this
    together."""
    from ..config import load_config
    from ..models import Stage, StageMetrics
    from ..utils.checksum import compute_sha256

    cfg = config or load_config()
    mesh = mesh or _default_mesh(cfg, backend)
    metrics = metrics if metrics is not None else StageMetrics()
    with metrics.timed(Stage.FILE_IO):
        header, data_start = ct.read_container(input_path)
    local = ChunkAssignment(mesh.rank, mesh.size, header.num_chunks).local_chunks()
    codec = _codec(cfg, backend, mesh)
    on_mesh = len(mesh.local_devices) > 1 and backend == "gpu" and (
        header.version >= ct.VERSION_V2 and header.subblock_symbols > 0)
    if on_mesh:
        from .sharded import make_sharded_decompress_step

        step = make_sharded_decompress_step(mesh, header.subblock_symbols)
    group = len(mesh.local_devices) if on_mesh else max(1, codec.batch_chunks)

    if mesh.rank == 0:
        with open(output_path, "wb") as f:
            f.truncate(header.original_file_size)
    _barrier(mesh)  # the output exists at its size

    in_fd = os.open(input_path, os.O_RDONLY)
    out_fd = os.open(output_path, os.O_WRONLY)
    try:
        for g0 in range(0, len(local), group):
            gmetas = [header.chunks[ci] for ci in local[g0 : g0 + group]]
            payloads = []
            for m in gmetas:
                with metrics.timed(Stage.FILE_IO, m.compressed_size):
                    p = os.pread(in_fd, m.compressed_size, data_start + m.compressed_offset)
                if len(p) != m.compressed_size:
                    raise IOError(f"short read on chunk {m.index}")
                payloads.append(p)
            if on_mesh:
                datas = _decode_group_local(step, codec, header, payloads, gmetas, metrics,
                                            mesh)
            else:
                datas = codec.decode_chunk_batch(payloads, gmetas, header, metrics)
            for m, data in zip(gmetas, datas):
                if data.size != m.original_size:
                    raise IOError(f"size mismatch in chunk {m.index}")
                with metrics.timed(Stage.CHECKSUM_VERIFY, data.size):
                    digest = compute_sha256(data)
                    if digest != m.sha256:
                        raise IOError(
                            f"Checksum mismatch in chunk {m.index}: expected "
                            f"{m.sha256.hex()}, got {digest.hex()}"
                        )
                with metrics.timed(Stage.FILE_IO, data.size):
                    os.pwrite(out_fd, data, m.original_offset)
            if progress is not None:
                progress(min(g0 + len(gmetas), len(local)) / max(len(local), 1))
    finally:
        codec.close()
        os.close(in_fd)
        os.close(out_fd)
    _barrier(mesh)  # every chunk is written
