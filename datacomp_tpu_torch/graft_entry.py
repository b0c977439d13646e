"""The port's dry-run entry points (counterpart of the root
``__graft_entry__.py``): the single-chunk device pipeline with example
inputs, and one pass over every level of a local mesh of ``n`` devices.

    python -m datacomp_tpu_torch.graft_entry [n]

Both run on the card unless the caller names the CPU (``device="cpu"``:
the kernels' plain versions), and raise when the process sees too few CUDA
devices.  Nothing falls back to the CPU.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from . import ops


def _devices(n: int, device=None) -> list:
    """``n`` local devices: ``n`` entries of ``device`` when it is given,
    else ``cuda:0`` to ``cuda:{n - 1}``, which must exist."""
    if device is not None:
        return [torch.device(device)] * n
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < n:
        raise RuntimeError(f"needs {n} CUDA devices, this process sees {count}; "
                           "pass device='cpu' for the plain versions")
    return [torch.device("cuda", i) for i in range(n)]


def entry(device=None):
    """``(fn, example_args)``: the single-chunk compress pipeline, histogram
    K1 → codebook K4 → encode K2, on the 64 KiB chunk of seeded data that
    ``__graft_entry__.entry`` makes (valid length ``n - 100``, sub-blocks of
    4096).  ``fn(data, valid_len)`` returns ``(words uint32[out_words],
    total_bits, lengths int32[256])``."""
    dev = _devices(1, device)[0]
    chunk_bytes = 1 << 16
    out_words = (9 * chunk_bytes + 31) // 32 + 2

    def step(data: torch.Tensor, valid_len: int):
        lengths, codes = ops.codebook(ops.histogram(data, valid_len))
        words, total_bits, _gaps = ops.encode(data, valid_len, lengths, codes, out_words, 4096)
        return words, total_bits, lengths

    rng = np.random.default_rng(42)
    data = torch.from_numpy(rng.integers(0, 64, chunk_bytes, dtype=np.uint8)).to(dev)
    return step, (data, chunk_bytes - 100)


def _deep_chunk() -> np.ndarray:
    """Fibonacci counts of 18 symbols: a host codebook deeper than 16 bits."""
    fib = [1, 1]
    while len(fib) < 18:
        fib.append(fib[-1] + fib[-2])
    return np.concatenate([np.full(c, s, np.uint8) for s, c in enumerate(fib)])


def dryrun_multichip(n: int, device=None) -> None:
    """One pass over a local mesh of ``n`` devices, as
    ``__graft_entry__.dryrun_multichip`` does over ``n`` chips: the sharded
    compress step on 2n ragged rows of 4 KiB (the offsets checked against
    the cumsum of the sizes), the sharded decompress step's round trip, a
    codebook deeper than 16 bits refused by
    :func:`check_decompress_step_params` and decoded on the host, and
    ``compress_multihost`` / ``decompress_multihost`` of a text, random,
    skewed and tail file through the mesh in device-codebook v2, verified
    deep and restored by the host codec and by the mesh.  Raises on any
    mismatch, and when the process sees fewer than ``n`` CUDA devices
    (``device`` names one device for all ``n`` entries instead, e.g.
    ``"cpu"``)."""
    from .config import load_config
    from .core import build_codebook
    from .core.bitio import decode_bitstream_py, encode_bitstream
    from .parallel import (
        check_decompress_step_params, compress_multihost, decompress_multihost, make_mesh,
        make_sharded_compress_step, sharded_decompress_arrays,
    )
    from .services.cpu_service import CpuCompressionService
    from .utils.testdata import generate_bytes

    mesh = make_mesh(devices=_devices(n, device))
    chunk_bytes, subblock, rows = 4096, 512, 2 * n  # two rows a device
    batch = np.random.default_rng(0).integers(0, 32, (rows, chunk_bytes), dtype=np.uint8)
    valid = np.full(rows, chunk_bytes, np.int32)
    valid[-1] = 100  # a ragged tail inside sub-block 0
    valid[-2] = 3 * subblock + 17  # one that ends mid-sub-block after full ones

    step = make_sharded_compress_step(mesh, chunk_bytes, subblock)
    outs = step([torch.from_numpy(batch[2 * j : 2 * j + 2]).to(dev)
                 for j, dev in enumerate(mesh.local_devices)], valid, rows)
    hists, lengths, _codes, words, total_bits, gaps, comp, offs = (
        np.concatenate([o[k].cpu().numpy() for o in outs]) for k in range(8))
    if comp.shape != (rows,) or not np.array_equal(offs, np.cumsum(comp) - comp):
        raise RuntimeError(f"offsets {offs.tolist()} are not the cumsum of sizes {comp.tolist()}")
    if hists.sum(1).tolist() != valid.tolist():
        raise RuntimeError(f"the histograms count {hists.sum(1).tolist()} bytes, the rows "
                           f"hold {valid.tolist()}")

    streams = [ops.payload_to_words(ops.words_to_bytes(words[b], int(total_bits[b])))
               for b in range(rows)]
    decoded = sharded_decompress_arrays(mesh, streams, gaps, list(lengths), subblock, valid)
    for b, row in enumerate(decoded):
        if not np.array_equal(row.cpu().numpy(), batch[b, : valid[b]]):
            raise RuntimeError(f"the sharded round trip changed row {b}")

    deep = _deep_chunk()
    deep_lengths, deep_codes = build_codebook(np.bincount(deep, minlength=256), mode="java")
    if int(deep_lengths.max()) <= ops.TABLE_BITS:
        raise RuntimeError("the deep fixture no longer makes codes deeper than 16 bits")
    try:
        check_decompress_step_params([deep_lengths], subblock)
    except ValueError:
        pass
    else:
        raise RuntimeError("the device step's check took a codebook deeper than 16 bits")
    payload = encode_bitstream(deep, deep_lengths, deep_codes)
    if not np.array_equal(decode_bitstream_py(payload, deep.size, deep_lengths), deep):
        raise RuntimeError("the host decode of the deep chunk failed")

    cfg = load_config(compression={"chunk_size_mb": 1, "format_version": 2,
                                   "codebook_mode": "device"})
    blob = (generate_bytes("text", 1 << 20) + generate_bytes("random", 1 << 20)
            + generate_bytes("skewed", 1 << 20) + generate_bytes("compressible", 54321))
    with tempfile.TemporaryDirectory() as d:
        src, dcz, restored, mine = (os.path.join(d, f) for f in (
            "in.bin", "out.dcz", "restored.bin", "mesh-restored.bin"))
        with open(src, "wb") as f:
            f.write(blob)
        compress_multihost(src, dcz, cfg, backend="gpu", mesh=mesh)
        with CpuCompressionService(cfg) as svc:
            if not svc.verify_integrity(dcz, deep=True):
                raise RuntimeError("the mesh's .dcz failed deep verify")
            svc.decompress(dcz, restored)
        decompress_multihost(dcz, mine, cfg, backend="gpu", mesh=mesh)
        for path in (restored, mine):
            with open(path, "rb") as f:
                if f.read() != blob:
                    raise RuntimeError(f"{os.path.basename(path)} differs from the input")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count())
    print("dryrun_multichip ok")
