"""The sharded compress and decompress steps: data parallelism over chunks
across ranks and a rank's local devices (counterpart of
``datacomp_tpu/parallel/sharded.py``).

Each rank's rows are split evenly over its local devices, contiguously and
in row order.  Each device runs the batched device pipeline on its own rows
on its own current stream, so that the cards run at once: histogram K1 →
codebook K4 → encode K2 (``ops.histogram_batch``, ``ops.codebook_batch``,
``ops.encode_batch``) with nothing fetched in between.  The devices'
compressed sizes are gathered onto the first device in row order (peer
copies), then, with several ranks, one ``all_gather_into_tensor`` on the
default group (NCCL for CUDA tensors) gathers every rank's, and an exclusive
cumsum on the device gives every row its global file offset: the JAX step's
``all_gather`` over the mesh axis.  Decompress is the batched gap-array
decoder K3 on each device's rows, with no collective.

The batched kernels take at most ``ops.MAX_ROWS`` rows a launch (per-row
lengths travel in the launch's parameters), so a device with more rows runs
each kernel in launches of at most that many rows; nothing is padded.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import ops
from .mesh import Mesh


def _spans(rows: int):
    """``[start, stop)`` of each launch of at most ``ops.MAX_ROWS`` rows."""
    return [(s, min(s + ops.MAX_ROWS, rows)) for s in range(0, rows, ops.MAX_ROWS)]


def _cat(parts: list) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _host_ints(values) -> list:
    if isinstance(values, torch.Tensor):
        values = values.tolist()
    return [int(v) for v in np.asarray(values).reshape(-1)]


def _compress_rows(x: torch.Tensor, valid: list, out_words: int, subblock: int) -> tuple:
    """Batched K1 → K4 → K2 on one device's rows, in launches of at most
    ``ops.MAX_ROWS`` rows: (hists, lengths, codes, words, total_bits, gaps)."""
    outs = []
    for s, e in _spans(len(valid)):
        rows, v = x[s:e], valid[s:e]
        hist = ops.histogram_batch(rows, v)
        lengths, codes = ops.codebook_batch(hist)
        outs.append((hist, lengths, codes,
                     *ops.encode_batch(rows, v, lengths, codes, out_words, subblock)))
    return tuple(_cat(list(p)) for p in zip(*outs))


def make_sharded_compress_step(mesh: Mesh, chunk_bytes: int, subblock: int = 4096):
    """The sharded compress step (``make_sharded_compress_step``,
    ``sharded.py:67``).

    Returns ``step(data, valid, global_rows)``.  ``data`` is this rank's
    rows: a uint8[B_local, chunk_bytes] tensor on ``mesh.device`` when the
    mesh has one local device, or a sequence of one uint8[B_local / L,
    chunk_bytes] tensor for each of the mesh's L local devices, on that
    device (device ``j`` holds rows ``j * B_local / L`` onwards).  ``valid``
    is the B_local valid lengths in row order (ints or an int tensor), and
    ``global_rows`` the batch's rows over all ranks, which every rank knows
    from the host.  For a tensor it returns ``(hists int32[B_local, 256],
    lengths int32[B_local, 256], codes uint32[B_local, 256], words
    uint32[B_local, out_words], total_bits int64[B_local], gaps
    uint32[B_local, ceil(chunk_bytes / subblock)], comp_bytes
    int64[B_local], offsets int64[B_local])``, where ``out_words = (9 *
    chunk_bytes + 31) // 32 + 2`` and ``offsets`` are the rows' global
    compressed file offsets, rank by rank and device by device in row
    order; for a sequence, one such tuple for each local device, of its
    rows, on that device.

    Every rank must call the step the same number of times, each with
    ``global_rows / mesh.size`` rows: the all-gather is a collective, and a
    rank that skips it stops every other.  The step raises before any
    launch, copy or collective when ``global_rows`` is not ``mesh.size``
    times this rank's rows (every rank sees the same ``global_rows``, so the
    ranks that fail this are all of them), when the rows do not divide
    evenly over the local devices, or when a valid length lies outside
    ``[0, chunk_bytes]``.
    """
    out_words = (9 * chunk_bytes + 31) // 32 + 2
    devices = mesh.local_devices

    def step(data, valid, global_rows: int):
        shards = [data] if isinstance(data, torch.Tensor) else list(data)
        valid = _host_ints(valid)
        rows = len(valid)
        if rows == 0 or int(global_rows) != rows * mesh.size:
            raise ValueError(
                f"{global_rows} rows over {mesh.size} ranks: every rank takes the same "
                f"number of rows, at least one (this rank has {rows})"
            )
        if len(shards) != len(devices) or rows % len(devices):
            raise ValueError(f"{rows} rows in {len(shards)} shards do not divide evenly over "
                             f"the {len(devices)} local devices")
        per = rows // len(devices)
        for x, dev in zip(shards, devices):
            if x.dim() != 2 or tuple(x.shape) != (per, chunk_bytes):
                raise ValueError(f"data must be uint8[{per}, {chunk_bytes}] a device, "
                                 f"got {tuple(x.shape)}")
            if x.device != dev:
                raise ValueError(f"data lies on {x.device}, its local device is {dev}")
        bad = [v for v in valid if not 0 <= v <= chunk_bytes]
        if bad:
            raise ValueError(f"valid lengths {bad} outside [0, {chunk_bytes}]")
        outs = [_compress_rows(x, valid[j * per : (j + 1) * per], out_words, subblock)
                for j, x in enumerate(shards)]  # each device's launches, queued at once
        comp = [(o[4] + 7) // 8 for o in outs]
        sizes = _cat([c.to(devices[0], non_blocking=True) for c in comp])  # row order
        if mesh.group is None:
            all_sizes = sizes
        else:
            all_sizes = torch.empty(rows * mesh.size, dtype=sizes.dtype, device=devices[0])
            dist.all_gather_into_tensor(all_sizes, sizes, group=mesh.group)
        offsets = torch.cumsum(all_sizes, 0) - all_sizes
        offsets = offsets[mesh.rank * rows : (mesh.rank + 1) * rows]
        res = [(*o, c, offsets[j * per : (j + 1) * per].to(dev, non_blocking=True))
               for j, (o, c, dev) in enumerate(zip(outs, comp, devices))]
        return res[0] if isinstance(data, torch.Tensor) else res

    return step


def _my_rows(mesh: Mesh, rows: int) -> list:
    """This rank's rows of a batch of ``rows``, which the ranks share
    evenly, then its local devices: one slice for each local device."""
    shares = mesh.size * len(mesh.local_devices)
    if rows % shares:
        raise ValueError(f"{rows} rows do not divide over {mesh.size} ranks of "
                         f"{len(mesh.local_devices)} local devices")
    per = rows // shares
    first = mesh.rank * rows // mesh.size
    return [slice(first + j * per, first + (j + 1) * per) for j in range(len(mesh.local_devices))]


def sharded_compress_arrays(mesh: Mesh, data_batch, valid_batch, subblock: int = 4096):
    """The sharded compress step on host arrays (``sharded.py:113``): rank
    ``r`` of ``n`` takes rows ``[r * B / n, (r + 1) * B / n)`` of the
    uint8[B, chunk_bytes] batch, shares them evenly over its local devices
    and returns the step's outputs for them, in row order on
    ``mesh.device``."""
    data_batch = np.asarray(data_batch, dtype=np.uint8)
    valid_batch = np.asarray(valid_batch)
    rows = data_batch.shape[0]
    mine = _my_rows(mesh, rows)
    step = make_sharded_compress_step(mesh, data_batch.shape[1], subblock)
    shards = [torch.from_numpy(np.ascontiguousarray(data_batch[s])).to(dev)
              for s, dev in zip(mine, mesh.local_devices)]
    outs = step(shards, np.concatenate([valid_batch[s] for s in mine]), rows)
    return tuple(_cat([o[k].to(mesh.device) for o in outs]) for k in range(8))


def check_decompress_step_params(code_lengths_batch, subblock: int) -> None:
    """Raise ``ValueError`` unless every codebook of the batch decodes on
    the device (``sharded.py:129``): codes of at most 16 bits (K3's tables)
    and a positive sub-block.  K3 reads each row's tables at run time, so
    the JAX step's static ``syms_per_step``, ``cmp_len`` and
    ``refill_words`` have no counterpart here."""
    ml = max((ops.max_code_len(np.asarray(lens)) for lens in code_lengths_batch), default=0)
    if ml > ops.TABLE_BITS:
        raise ValueError(
            f"batch contains a {ml}-bit codebook; device decode supports <= {ops.TABLE_BITS} "
            "bits (route deep-codebook chunks to the host decoder)"
        )
    if subblock <= 0:
        raise ValueError(f"subblock {subblock} must be positive")


def _decompress_rows(words, word_offsets, gaps, gap_offsets, limits, adj, sym, subblock: int,
                     n_outs: list) -> torch.Tensor:
    """Batched K3 on one device's rows, in launches of at most
    ``ops.MAX_ROWS`` rows: their ``n_outs`` bytes, concatenated."""
    wo, go = _host_ints(word_offsets), _host_ints(gap_offsets)
    outs = []
    for s, e in _spans(len(n_outs)):
        outs.append(ops.decode_batch(
            words[wo[s] : wo[e]], [o - wo[s] for o in wo[s : e + 1]],
            gaps[go[s] : go[e]], [o - go[s] for o in go[s : e + 1]],
            limits[s:e], adj[s:e], sym[s:e], subblock, n_outs[s:e]))
    return _cat(outs)


def make_sharded_decompress_step(mesh: Mesh, subblock: int):
    """The sharded decompress step (``sharded.py:165``): batched K3 on each
    local device's rows, in launches of at most ``ops.MAX_ROWS`` rows, with
    no collective.  Returns ``step(words, word_offsets, gaps, gap_offsets,
    limits, adj, sym, n_outs)`` with :func:`ops.decode_batch`'s arguments
    (tensors on ``mesh.device``; offsets and ``n_outs`` ints on the host) and
    its result: the rows' ``n_outs`` bytes, concatenated.  With several
    local devices each argument is instead a sequence with one entry for
    each of the first local devices, in order (those past its end get no
    rows), each entry that device's rows on that device, and the result is
    a list of each device's output.  Check the rows' codebooks with
    :func:`check_decompress_step_params` first."""
    devices = mesh.local_devices

    def step(words, word_offsets, gaps, gap_offsets, limits, adj, sym, n_outs):
        single = isinstance(words, torch.Tensor)
        parts = [(words, word_offsets, gaps, gap_offsets, limits, adj, sym, n_outs)] if single \
            else list(zip(words, word_offsets, gaps, gap_offsets, limits, adj, sym, n_outs))
        if len(parts) > len(devices):
            raise ValueError(f"rows for {len(parts)} devices, the mesh has {len(devices)}")
        for part, dev in zip(parts, devices):
            if part[0].device != dev:
                raise ValueError(f"words lie on {part[0].device}, their local device is {dev}")
        outs = [_decompress_rows(*part[:7], subblock, _host_ints(part[7])) for part in parts]
        return outs[0] if single else outs

    return step


def sharded_decompress_arrays(mesh: Mesh, words_batch, gaps_batch, code_lengths_batch,
                              subblock: int, sizes) -> list:
    """The sharded decompress step on host arrays (``sharded.py:214``):
    rank ``r`` of ``n`` takes rows ``[r * B / n, (r + 1) * B / n)`` and
    shares them evenly over its local devices.  Row ``b`` is the stream
    ``words_batch[b]`` (its ``payload_to_words``, zero words after it
    allowed), its gap array ``gaps_batch[b]`` (entries past ``ceil(sizes[b]
    / subblock)`` ignored) and its code lengths.  The tables are built and
    every depth checked before any launch.  Returns this rank's rows, each
    uint8 at its original size ``sizes[b]`` on the device that decoded it;
    the JAX function returns padded rows that its caller cuts."""
    rows = len(code_lengths_batch)
    mine = _my_rows(mesh, rows)
    lengths = [np.asarray(lens) for lens in code_lengths_batch]
    check_decompress_step_params([lens for s in mine for lens in lengths[s]], subblock)
    sizes, words_batch, gaps_batch = _host_ints(sizes), list(words_batch), list(gaps_batch)
    parts = []
    for s, dev in zip(mine, mesh.local_devices):
        n_outs = sizes[s]
        words = [np.asarray(w, dtype=np.uint32).reshape(-1) for w in words_batch[s]]
        gaps = [np.asarray(g, dtype=np.uint32).reshape(-1)[: -(-n // subblock)]
                for g, n in zip(gaps_batch[s], n_outs)]
        tables = [ops.build_decode_tables(lens) for lens in lengths[s]]
        parts.append((torch.from_numpy(np.concatenate(words)).to(dev),
                      np.cumsum([0] + [w.size for w in words]),
                      torch.from_numpy(np.concatenate(gaps)).to(dev),
                      np.cumsum([0] + [g.size for g in gaps]),
                      *ops.decode_tables_to_torch(
                          *(np.stack([t[k] for t in tables]) for k in range(3)), dev),
                      n_outs))
    outs = make_sharded_decompress_step(mesh, subblock)(*zip(*parts))
    return [row for out, part in zip(outs, parts) for row in torch.split(out, part[7])]
