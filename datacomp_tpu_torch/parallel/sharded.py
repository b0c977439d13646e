"""The sharded compress and decompress steps: data parallelism over chunks
across ranks (counterpart of ``datacomp_tpu/parallel/sharded.py``).

Each rank runs the batched device pipeline on its own rows: histogram K1 →
codebook K4 → encode K2 (``ops.histogram_batch``, ``ops.codebook_batch``,
``ops.encode_batch``) with nothing fetched in between.  Then one
``all_gather_into_tensor`` of the compressed sizes on the default group
(NCCL for CUDA tensors) and an exclusive cumsum on the device give every
rank the global file offsets of its rows: the JAX step's ``all_gather`` over
the mesh axis.  Decompress is the batched gap-array decoder K3 on each
rank's rows, with no collective.

The batched kernels take at most ``ops.MAX_ROWS`` rows a launch (per-row
lengths travel in the launch's parameters), so a rank with more rows runs
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


def make_sharded_compress_step(mesh: Mesh, chunk_bytes: int, subblock: int = 4096):
    """The sharded compress step (``make_sharded_compress_step``,
    ``sharded.py:67``).

    Returns ``step(data, valid, global_rows)``: ``data`` is this rank's
    uint8[B_local, chunk_bytes] on ``mesh.device``, ``valid`` its B_local
    valid lengths (ints or an int tensor), ``global_rows`` the batch's rows
    over all ranks, which every rank knows from the host.  It returns, for
    this rank's rows, ``(hists int32[B_local, 256], lengths int32[B_local,
    256], codes uint32[B_local, 256], words uint32[B_local, out_words],
    total_bits int64[B_local], gaps uint32[B_local, ceil(chunk_bytes /
    subblock)], comp_bytes int64[B_local], offsets int64[B_local])``, where
    ``out_words = (9 * chunk_bytes + 31) // 32 + 2`` and ``offsets`` are the
    rows' global compressed file offsets, rank by rank in row order.

    Every rank must call the step the same number of times, each with
    ``global_rows / mesh.size`` rows: the all-gather is a collective, and a
    rank that skips it stops every other.  The step raises before the
    collective when ``global_rows`` is not ``mesh.size`` times this rank's
    rows (every rank sees the same ``global_rows``, so the ranks that fail
    this are all of them) or a valid length lies outside ``[0,
    chunk_bytes]``.
    """
    out_words = (9 * chunk_bytes + 31) // 32 + 2

    def step(data: torch.Tensor, valid, global_rows: int):
        valid = _host_ints(valid)
        rows = len(valid)
        if rows == 0 or int(global_rows) != rows * mesh.size:
            raise ValueError(
                f"{global_rows} rows over {mesh.size} ranks: every rank takes the same "
                f"number of rows, at least one (this rank has {rows})"
            )
        if data.dim() != 2 or tuple(data.shape) != (rows, chunk_bytes):
            raise ValueError(f"data must be uint8[{rows}, {chunk_bytes}], got {tuple(data.shape)}")
        if data.device != mesh.device:
            raise ValueError(f"data lies on {data.device}, this rank's device is {mesh.device}")
        outs = []  # the kernels' wrappers check the valid lengths before they launch
        for s, e in _spans(rows):
            x, v = data[s:e], valid[s:e]
            hist = ops.histogram_batch(x, v)
            lengths, codes = ops.codebook_batch(hist)
            outs.append((hist, lengths, codes,
                         *ops.encode_batch(x, v, lengths, codes, out_words, subblock)))
        hists, lengths, codes, words, total_bits, gaps = (_cat(list(p)) for p in zip(*outs))
        comp_bytes = (total_bits + 7) // 8
        if mesh.group is None:
            all_sizes = comp_bytes
        else:
            all_sizes = torch.empty(rows * mesh.size, dtype=comp_bytes.dtype, device=data.device)
            dist.all_gather_into_tensor(all_sizes, comp_bytes, group=mesh.group)
        all_offsets = torch.cumsum(all_sizes, 0) - all_sizes
        offsets = all_offsets[mesh.rank * rows : (mesh.rank + 1) * rows]
        return hists, lengths, codes, words, total_bits, gaps, comp_bytes, offsets

    return step


def _my_rows(mesh: Mesh, rows: int) -> slice:
    """This rank's rows of a batch of ``rows``, which the ranks share evenly."""
    if rows % mesh.size:
        raise ValueError(f"{rows} rows do not divide over {mesh.size} ranks")
    per = rows // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def sharded_compress_arrays(mesh: Mesh, data_batch, valid_batch, subblock: int = 4096):
    """The sharded compress step on host arrays (``sharded.py:113``): rank
    ``r`` of ``n`` takes rows ``[r * B / n, (r + 1) * B / n)`` of the
    uint8[B, chunk_bytes] batch and returns the step's outputs for them."""
    data_batch = np.asarray(data_batch, dtype=np.uint8)
    rows = data_batch.shape[0]
    mine = _my_rows(mesh, rows)
    step = make_sharded_compress_step(mesh, data_batch.shape[1], subblock)
    x = torch.from_numpy(np.ascontiguousarray(data_batch[mine])).to(mesh.device)
    return step(x, np.asarray(valid_batch)[mine], rows)


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


def make_sharded_decompress_step(mesh: Mesh, subblock: int):
    """The sharded decompress step (``sharded.py:165``): batched K3 on this
    rank's rows, in launches of at most ``ops.MAX_ROWS`` rows, with no
    collective.  Returns ``step(words, word_offsets, gaps, gap_offsets,
    limits, adj, sym, n_outs)`` with :func:`ops.decode_batch`'s arguments
    (tensors on ``mesh.device``; offsets and ``n_outs`` ints on the host) and
    its result: the rows' ``n_outs`` bytes, concatenated.  Check the rows'
    codebooks with :func:`check_decompress_step_params` first."""

    def step(words, word_offsets, gaps, gap_offsets, limits, adj, sym, n_outs):
        wo, go, n_outs = _host_ints(word_offsets), _host_ints(gap_offsets), _host_ints(n_outs)
        if words.device != mesh.device:
            raise ValueError(f"words lie on {words.device}, this rank's device is {mesh.device}")
        outs = []
        for s, e in _spans(len(n_outs)):
            outs.append(ops.decode_batch(
                words[wo[s] : wo[e]], [o - wo[s] for o in wo[s : e + 1]],
                gaps[go[s] : go[e]], [o - go[s] for o in go[s : e + 1]],
                limits[s:e], adj[s:e], sym[s:e], subblock, n_outs[s:e]))
        return _cat(outs)

    return step


def sharded_decompress_arrays(mesh: Mesh, words_batch, gaps_batch, code_lengths_batch,
                              subblock: int, sizes) -> list:
    """The sharded decompress step on host arrays (``sharded.py:214``):
    rank ``r`` of ``n`` takes rows ``[r * B / n, (r + 1) * B / n)``.  Row
    ``b`` is the stream ``words_batch[b]`` (its ``payload_to_words``, zero
    words after it allowed), its gap array ``gaps_batch[b]`` (entries past
    ``ceil(sizes[b] / subblock)`` ignored) and its code lengths.  The tables
    are built and every depth checked before the launch.  Returns this
    rank's rows, each uint8 at its original size ``sizes[b]``; the JAX
    function returns padded rows that its caller cuts."""
    rows = len(code_lengths_batch)
    mine = _my_rows(mesh, rows)
    lengths = [np.asarray(lens) for lens in code_lengths_batch][mine]
    check_decompress_step_params(lengths, subblock)
    n_outs = _host_ints(sizes)[mine]
    words = [np.asarray(w, dtype=np.uint32).reshape(-1) for w in list(words_batch)[mine]]
    gaps = [np.asarray(g, dtype=np.uint32).reshape(-1)[: -(-n // subblock)]
            for g, n in zip(list(gaps_batch)[mine], n_outs)]
    tables = [ops.build_decode_tables(lens) for lens in lengths]
    limits, adj, sym = ops.decode_tables_to_torch(
        *(np.stack([t[k] for t in tables]) for k in range(3)), mesh.device)
    out = make_sharded_decompress_step(mesh, subblock)(
        torch.from_numpy(np.concatenate(words)).to(mesh.device),
        np.cumsum([0] + [w.size for w in words]),
        torch.from_numpy(np.concatenate(gaps)).to(mesh.device),
        np.cumsum([0] + [g.size for g in gaps]),
        limits, adj, sym, n_outs)
    return list(torch.split(out, n_outs))
