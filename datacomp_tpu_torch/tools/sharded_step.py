"""The sharded compress step across ranks, one GPU a rank: each rank's rows
through ``parallel.make_sharded_compress_step`` (batched K1 → K4 → K2, one
NCCL all-gather of the compressed sizes, a cumsum), checked and timed by
:func:`check_step`, which ``chip_smoke.py``'s phase 11a also calls.

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m datacomp_tpu_torch.tools.sharded_step [rows_per_rank] [chunk_mb]

Rank r takes rows ``r * R`` to ``(r + 1) * R - 1`` of a batch of ``N * R``
rows (4 a rank and 16 MiB by default), each made on its rank from its row
index (the kinds of ``KINDS`` in turn, valid lengths n, n - 12345, 17 and 0
in turn), so no data crosses ranks.  Rank 0 prints one JSON line with every
rank's device, checks, launches and times, and the job exits 1 when a
check fails.  With ``DATACOMP_DEVICE_PLATFORM=cpu`` it runs on the plain
versions over gloo and takes no times.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from .. import ops
from ..parallel import (
    initialize_distributed, make_mesh, make_sharded_compress_step, process_allgather,
    rank_device,
)
from ..utils.testdata import generate_bytes
from . import copies, cuda_ms

KINDS = ("text", "skewed", "compressible", "random")
SUBBLOCK = 4032  # the default v2 sub-block
REPS = 24


def rows_of(first: int, rows: int, n: int):
    """Rows ``first`` to ``first + rows - 1`` of the batch, with their valid
    lengths."""
    edges = (n, n - 12_345, 17, 0)
    data = np.stack([np.frombuffer(generate_bytes(KINDS[i % len(KINDS)], n, seed=i), np.uint8)
                     for i in range(first, first + rows)])
    return data, [edges[i % len(edges)] for i in range(first, first + rows)]


def check_step(mesh, x: torch.Tensor, valid: list, subblock: int = SUBBLOCK,
               reps: int = REPS) -> tuple:
    """The step once on this rank's rows ``x`` (``valid`` lengths), every
    rank together: its outputs held to the batched kernels on the same rows,
    its sizes to ``(total_bits + 7) // 8`` and its offsets to the exclusive
    cumsum of every rank's sizes (gathered to the host over gloo), the
    kernels its call launched and the plain versions it ran counted.  On a
    CUDA device it then times, by CUDA events, the step, the batched
    kernels alone and the step's all-gather alone (a mesh without a process
    group gathers nothing).  Returns (the step's outputs, the record)."""
    rows, n = x.shape
    out_words = (9 * n + 31) // 32 + 2
    step = make_sharded_compress_step(mesh, n, subblock)

    def batched(t):
        hist = ops.histogram_batch(t, valid)
        lens, codes = ops.codebook_batch(hist)
        return (hist, lens, codes, *ops.encode_batch(t, valid, lens, codes, out_words, subblock))

    ops.reset_counters()
    got = step(x, valid, rows * mesh.size)
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    launches = {name: k.value for name, (k, _) in ops.COUNTERS.items() if k.value}
    plain = {name: r.value for name, (_, r) in ops.COUNTERS.items() if r.value}
    sizes = got[6].cpu().numpy()
    every = process_allgather(mesh, sizes).reshape(-1)
    want = (np.cumsum(every) - every)[mesh.rank * rows : (mesh.rank + 1) * rows]
    record = {"rank": mesh.rank, "device": str(x.device),
              "name": torch.cuda.get_device_name(x.device) if x.device.type == "cuda" else "CPU",
              "outputs_equal_batched_kernels": all(
                  torch.equal(a.cpu(), b.cpu()) for a, b in zip(got[:6], batched(x))),
              "sizes_equal_bits": sizes.tolist() == ((got[4].cpu().numpy() + 7) // 8).tolist(),
              "offsets_equal_global_cumsum": got[7].cpu().tolist() == want.tolist(),
              "launches": launches, "plain_calls": plain}
    # on the card a wrapper launches its kernel or raises: a plain call is a fault
    record["ok"] = (record["outputs_equal_batched_kernels"] and record["sizes_equal_bits"]
                    and record["offsets_equal_global_cumsum"]
                    and not (plain and x.device.type == "cuda"))
    if x.device.type == "cuda":
        xs = copies(x)
        gathered = torch.empty(rows * mesh.size, dtype=torch.int64, device=x.device)
        record.update(
            step_ms=cuda_ms(lambda t: step(t, valid, rows * mesh.size), xs, reps),
            batched_kernels_ms=cuda_ms(batched, xs, reps),
            all_gather_ms=cuda_ms(lambda s: dist.all_gather_into_tensor(
                gathered, s, group=mesh.group), [(got[6],)], reps) if mesh.group else None)
    return got, record


def run(rows: int = 4, chunk_mb: int = 16) -> int:
    n = chunk_mb << 20
    device = rank_device()
    initialize_distributed(device=device)
    try:
        mesh = make_mesh(device=device)
        data, valid = rows_of(mesh.rank * rows, rows, n)
        _, record = check_step(mesh, torch.from_numpy(data).to(device), valid)
        records = [record]
        if mesh.size > 1:
            records = [None] * mesh.size
            dist.all_gather_object(records, record, group=mesh.host_group)
        ok = all(r["ok"] for r in records)
        if mesh.rank == 0:
            print(json.dumps({"ranks": mesh.size, "rows_per_rank": rows, "chunk_bytes": n,
                              "ok": ok, "records": records}), flush=True)
        return 0 if ok else 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(run(*(int(a) for a in sys.argv[1:3])))
