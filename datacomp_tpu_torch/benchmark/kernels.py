"""Kernel and batch benches of the port on one CUDA device: the counterpart of
``datacomp_tpu/benchmark/kernels.py``, redesigned for the card.

The JAX bench slope-times chains of each kernel with a perturbation XLA
cannot fold, because XLA hoists loop-invariant work and a TPU behind a relay
confirms only the enqueue.  A CUDA device has neither problem, so none of
that comes across.  Every time here is one of two readings of the same calls,
on copies of the inputs that together exceed the L2 cache (each call reads
cold):

* device time (``ms_per_chunk``): the calls captured into a CUDA graph and
  replayed between CUDA events (:func:`..tools.graph_ms`), the wrappers'
  fills included, their host work not;
* call time (``call_ms``): CUDA events around back-to-back calls
  (:func:`..tools.cuda_ms`), so a call whose wrapper's host work outlasts its
  device work is timed by the host work.

Bounds use the published peaks of one H100 SXM (NVIDIA's data sheet, at its
full 700 W): each kernel's bytes (each input read once, each output written
once) over 3.35 TB/s of HBM, or its operations over 67 T/s, the float32 rate
outside the tensor cores, taken as the ceiling of the integer and compare
instructions these kernels are made of, whichever is longer.  K4 moves too
little for either, so its floor is the launch floor measured here (``zero_()``
of 256 elements).  :func:`bound` and the work counts
(:func:`histogram_work`, ...) also serve ``chip_smoke.py``.

* :func:`run_kernel_bench`: K1 (``histogram``; ``histogram-library`` is
  ``torch.bincount``), K4 (``codebook``), K2 (``encode``) and K3
  (``decode``) on one chunk, with the ``-cap8`` rows when the data's optimal
  code is deeper than 8 bits; each row is checked before it is timed;
* :func:`calibrate_primitives`: the card's copy, gather, atomic-add and
  launch-floor readings, reported beside the bounds;
* :func:`run_pipeline_batch_bench` and :func:`run_decode_batch_bench`: the
  batched K1 → K4 → K2 and the batched K3 at B chunks a launch.

Every entry point needs a CUDA device and raises ``RuntimeError`` without
one: a time taken on the CPU is no device metric.
"""

from __future__ import annotations

import json
import math
import subprocess
from typing import Dict, Optional

import numpy as np
import torch

#: H100 SXM device memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: the H100's float32 rate outside the tensor cores, the ceiling taken for
#: the integer and compare instructions of these kernels
OPS_PER_S = 67e12
#: K4's sort and search: 15 network stages and 48 search steps a symbol
CODEBOOK_OPS_PER_SYMBOL = 15 + 48
SUBBLOCK = 4032  # the default v2 sub-block (symbols)
REPS = 48  # timed calls a reading
#: the primitives' shapes: a copy far larger than the 50 MB L2, and 2^22
#: random indices into 2^22 words for the gather and the atomic adds
COPY_BYTES = 1 << 29
PRIMITIVE_COUNT = 1 << 22


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the scalar rate, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def histogram_work(valid_lens) -> tuple:
    """(bytes, operations) of K1 on rows of ``valid_lens`` bytes: each row's
    bytes read and its int32[256] written; an operation a byte."""
    n = sum(valid_lens)
    return n + len(valid_lens) * 256 * 4, n


def codebook_work(rows: int) -> tuple:
    """K4 on ``rows`` histograms: 1 KB in and 2 KB (lengths, codes) out a
    row; the sort's compares."""
    return rows * 256 * 4 * 3, rows * 256 * CODEBOOK_OPS_PER_SYMBOL


def encode_work(valid_lens, live_words: int, gap_words: int) -> tuple:
    """K2: the rows and their codebooks (2 KB a row) in; the live words and
    the gap arrays out; an operation a byte."""
    n = sum(valid_lens)
    return n + len(valid_lens) * 256 * 8 + 4 * live_words + 4 * gap_words, n


def decode_work(stream_words: int, gap_words: int, table_bytes: int, n_out: int) -> tuple:
    """K3: the streams, gap arrays and tables in; the decoded bytes out; an
    operation a byte."""
    return 4 * stream_words + 4 * gap_words + table_bytes + n_out, n_out


def gap_finder_work(stream_words: int, gap_words: int, table_bytes: int, rows: int,
                    n_out: int) -> tuple:
    """K5: the streams and tables in; the gap arrays and an int64 end a row
    out; an operation a symbol."""
    return 4 * stream_words + table_bytes + 4 * gap_words + 8 * rows, n_out


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def pci_address(props) -> str:
    """A card's PCI address as nvidia-smi writes it (``00000000:1B:00.0``),
    from ``torch.cuda.get_device_properties``."""
    return f"{props.pci_domain_id:08X}:{props.pci_bus_id:02X}:{props.pci_device_id:02X}.0"


def device_info() -> dict:
    """The name and power limit that every time here stands beside, both of
    the current card.  nvidia-smi lists every card in PCI order whatever
    ``CUDA_VISIBLE_DEVICES`` says, so the card is named to it by its PCI
    address, not by torch's index."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    limit = subprocess.run(
        ["nvidia-smi", "-i", pci_address(props), "--query-gpu=power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip()
    return {"name": props.name, "power_limit": limit}


def cuda_device(what: str) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs a CUDA device (torch.cuda.is_available() is "
                           "False): a time taken on the CPU is no device metric")
    return torch.device("cuda", torch.cuda.current_device())


def kernel_row(device_ms: float, call_ms: float, nbytes: int, work: tuple,
               floor_ms: Optional[float] = None) -> dict:
    """One row of :func:`run_kernel_bench`: ``nbytes`` of input a call (0
    for K4, which has no MB/s), its ``work`` (bytes, operations) bounded by
    the published peaks or, when it is longer, the launch floor
    ``floor_ms``; ``efficiency`` is bound over device time."""
    b = bound(*work)
    bound_ms, kind = b["bound_ms"], "bytes" if b["bound_by"] == "bytes" else "ops"
    if floor_ms is not None and floor_ms > bound_ms:
        bound_ms, kind = floor_ms, "launch floor"
    return {"ms_per_chunk": device_ms, "call_ms": call_ms,
            "mbps": nbytes / 1e6 / (device_ms / 1e3) if nbytes else None,
            "bound_ms": bound_ms, "bound_kind": kind, "efficiency": bound_ms / device_ms,
            "exact": True}


def _exact(name: str, ok: bool, where: str) -> None:
    if not ok:
        raise RuntimeError(f"{name} is not exact on {where}")


def run_kernel_bench(size_mb: int = 16, kind: str = "text") -> Dict[str, dict]:
    """Time K1, K4, K2 and K3 on a ``size_mb`` MiB chunk of ``kind`` data.

    Each row is checked first and raises when it is not exact: K1 (and
    ``torch.bincount``) against ``np.bincount``, K4 and K2 against their
    plain versions, K3 by returning the input (its plain version is several
    thousand times slower than the kernel, PERF.md §6).  K2 and K3 run the
    data's optimal codebook (``encode``, ``decode``) and, when that is
    deeper than 8 bits, the optimal one capped at 8 (``encode-cap8``,
    ``decode-cap8``); a codebook deeper than K3's 16 bits has no decode row
    (the codec decodes such chunks on the host), and ``_skipped`` says so.  Also returns
    ``_primitives`` (:func:`calibrate_primitives`) and ``_device``.
    """
    dev = cuda_device("run_kernel_bench")
    from .. import ops
    from ..core.huffman import build_codebook
    from ..tools import SHORT_PER_INPUT, copies, cuda_ms, graph_ms
    from ..utils.testdata import generate_bytes

    n = size_mb << 20
    where = f"{size_mb} MiB of {kind}"
    host = np.frombuffer(generate_bytes(kind, n), np.uint8)
    want = np.bincount(host, minlength=256)
    x = torch.from_numpy(host.copy()).to(dev)
    xs = copies(x)
    results: Dict[str, dict] = {}

    def short_ms(fn, inputs):
        return graph_ms(fn, inputs, REPS * SHORT_PER_INPUT, SHORT_PER_INPUT)

    hist = ops.histogram(x, n)
    _exact("histogram", np.array_equal(hist.cpu().numpy(), want), where)
    results["histogram"] = kernel_row(
        graph_ms(lambda t: ops.histogram(t, n), xs, REPS),
        cuda_ms(lambda t: ops.histogram(t, n), xs, REPS), n, histogram_work([n]))

    def library(t):
        return torch.bincount(t, minlength=256)

    _exact("histogram-library", np.array_equal(library(x).cpu().numpy(), want), where)
    library_ms = cuda_ms(library, xs, REPS)
    results["histogram-library"] = {
        **kernel_row(library_ms, library_ms, n, histogram_work([n])),
        "timed_by": "events alone: torch.bincount reads its maximum back to the host, "
                    "so no graph captures it"}

    floor_ms = short_ms(lambda t: t.zero_(),
                        copies(torch.zeros(256, dtype=torch.int32, device=dev)))
    kl, kc = ops.codebook(hist)
    rl, rc = ops.codebook_reference(hist)
    _exact("codebook", torch.equal(kl.cpu(), rl.cpu()) and torch.equal(kc.cpu(), rc.cpu()),
           f"the histogram of {where}")
    hs = copies(hist)
    results["codebook"] = kernel_row(short_ms(ops.codebook, hs),
                                     cuda_ms(ops.codebook, hs, REPS * SHORT_PER_INPUT), 0,
                                     codebook_work(1), floor_ms=floor_ms)

    counts = want.astype(np.int64)
    lengths, codes = build_codebook(counts)
    books = [("", lengths, codes)]
    if ops.max_code_len(lengths) > 8:
        books.append(("-cap8", *build_codebook(counts, mode="fast", max_len=8)))
    out_words = (9 * n + 31) // 32 + 2
    nsub = -(-n // SUBBLOCK)
    skipped = {}
    for suffix, lengths, codes in books:
        depth = ops.max_code_len(lengths)
        lt, ct = ops.codebook_to_torch(lengths, codes, dev)
        kw, ktb, kg = ops.encode(x, n, lt, ct, out_words, SUBBLOCK)
        rw, rtb, rg = ops.encode_reference(x, n, lt, ct, out_words, SUBBLOCK)
        tb = int(ktb)
        live = (tb + 31) // 32
        _exact(f"encode{suffix}", tb == int(rtb) == int(counts @ lengths.astype(np.int64))
               and torch.equal(kw[:live].cpu(), rw[:live].cpu())
               and torch.equal(kg.cpu(), rg.cpu()), where)
        del rw, rg

        def enc(t, lt=lt, ct=ct):
            return ops.encode(t, n, lt, ct, out_words, SUBBLOCK)

        results[f"encode{suffix}"] = {
            **kernel_row(graph_ms(enc, xs, REPS), cuda_ms(enc, xs, REPS), n,
                         encode_work([n], live, nsub)), "depth": depth}
        if depth > ops.TABLE_BITS:
            skipped[f"decode{suffix}"] = (f"depth {depth} > {ops.TABLE_BITS}: the codec "
                                          "decodes such chunks on the host")
            continue
        words = torch.from_numpy(
            ops.payload_to_words(ops.words_to_bytes(kw[:live].cpu().numpy(), tb))).to(dev)
        tables = ops.decode_tables_to_torch(*ops.build_decode_tables(lengths), dev)
        _exact(f"decode{suffix}", np.array_equal(
            ops.decode(words, kg, *tables, SUBBLOCK, n).cpu().numpy(), host), where)

        def dec(w, g, tables=tables):
            return ops.decode(w, g, *tables, SUBBLOCK, n)

        ws = copies(words, kg)
        table_bytes = sum(t.numel() * t.element_size() for t in tables)
        results[f"decode{suffix}"] = {
            **kernel_row(graph_ms(dec, ws, REPS), cuda_ms(dec, ws, REPS), n,
                         decode_work(words.numel(), nsub, table_bytes, n)), "depth": depth}
        del ws
    if skipped:
        results["_skipped"] = skipped
    results["_primitives"] = calibrate_primitives()
    results["_device"] = device_info()
    return results


def primitive_readings(copy_ms: float, gather_ms: float, atomic_ms: float,
                       launch_floor_ms: float, copy_bytes: int = COPY_BYTES,
                       count: int = PRIMITIVE_COUNT) -> dict:
    """The primitives from their device times: the copy's bytes (read and
    written) a second and its share of the 3.35 TB/s peak; nanoseconds an
    element of the gather and of the atomic adds; the launch floor.  A time
    that is not finite or not above zero gives ``None`` and a ``suspect``
    entry, never a clamped value."""
    suspect = []

    def good(name: str, ms) -> bool:
        if isinstance(ms, (int, float)) and math.isfinite(ms) and ms > 0:
            return True
        suspect.append(f"{name}: timed {ms!r} ms, not a finite time above zero")
        return False

    rate = 2 * copy_bytes / (copy_ms / 1e3) if good("hbm_copy", copy_ms) else None
    out = {
        "hbm_copy_bytes_per_s": rate,
        "hbm_copy_peak_frac": rate / HBM_BYTES_PER_S if rate is not None else None,
        "gather_ns": gather_ms * 1e6 / count if good("gather", gather_ms) else None,
        "atomic_add_ns": atomic_ms * 1e6 / count if good("atomic_add", atomic_ms) else None,
        "launch_floor_ms": launch_floor_ms if good("launch_floor", launch_floor_ms) else None,
    }
    if suspect:
        out["suspect"] = suspect
    return out


def calibrate_primitives() -> dict:
    """Measure on the card what the JAX version measures on the TPU, each by
    :func:`..tools.graph_ms`: the HBM copy rate (``copy_`` of
    ``COPY_BYTES``), the gather (``torch.take`` of ``PRIMITIVE_COUNT``
    random indices into as many int32 words: 16 MiB, which L2 holds), the
    global atomic adds (``index_add_`` at random indices of the same shape)
    and the launch floor (``zero_()`` of 256 elements).  They stand beside
    the bounds, which use the published peaks (:func:`primitive_readings`)."""
    dev = cuda_device("calibrate_primitives")
    from ..tools import SHORT_PER_INPUT, copies, graph_ms

    gen = torch.Generator(device=dev).manual_seed(0)
    src = torch.randint(0, 256, (COPY_BYTES,), dtype=torch.uint8, device=dev, generator=gen)
    dst = torch.empty_like(src)
    copy_ms = graph_ms(lambda: dst.copy_(src), [()], 12)
    del src, dst
    n = PRIMITIVE_COUNT
    table = torch.randint(0, 1 << 30, (n,), dtype=torch.int32, device=dev, generator=gen)
    idx = torch.randint(0, n, (n,), dtype=torch.int64, device=dev, generator=gen)
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    sums = torch.zeros(n, dtype=torch.int32, device=dev)
    gather_ms = graph_ms(lambda: torch.take(table, idx), [()], REPS)
    atomic_ms = graph_ms(lambda: sums.index_add_(0, idx, ones), [()], REPS)
    floor_ms = graph_ms(lambda t: t.zero_(),
                        copies(torch.zeros(256, dtype=torch.int32, device=dev)),
                        REPS * SHORT_PER_INPUT, SHORT_PER_INPUT)
    return primitive_readings(copy_ms, gather_ms, atomic_ms, floor_ms)


def batch_row(batch: int, nbytes: int, device_ms: float, call_ms: float) -> dict:
    """One B of the batch benches: a launch's device time and call time,
    per chunk of ``nbytes`` and per program (a call of the batched entry
    points), under the JAX bench's names."""
    return {
        "batch": batch,
        "compute_ms_per_chunk": device_ms / batch,
        "mbps_per_chunk": nbytes / 1e6 / (device_ms / batch / 1e3),
        "overhead_ms_per_program": call_ms - device_ms,
        "overhead_ms_per_chunk": (call_ms - device_ms) / batch,
        "device_ms": device_ms,
        "call_ms": call_ms,
    }


def batch_chunks(size_mb: int = 16, kind: str = "text", rows: int = 8) -> np.ndarray:
    """``rows`` distinct chunks of ``size_mb`` MiB: consecutive parts of one
    stream of ``kind`` data, made on the host (several seconds for 8 chunks
    of ``text``), so the two batch benches take the same ones."""
    from ..utils.testdata import generate_bytes

    n = size_mb << 20
    return np.frombuffer(generate_bytes(kind, n * rows), np.uint8).reshape(rows, n)


def _blob(what: str, blob: Optional[np.ndarray], size_mb: int, kind: str,
          batch_sizes: tuple) -> np.ndarray:
    if blob is None:
        return batch_chunks(size_mb, kind, max(batch_sizes))
    if blob.shape != (blob.shape[0], size_mb << 20) or blob.shape[0] < max(batch_sizes):
        raise ValueError(f"{what}: chunks of shape {blob.shape}, need at least "
                         f"{max(batch_sizes)} rows of {size_mb} MiB")
    return blob


def run_pipeline_batch_bench(size_mb: int = 16, kind: str = "text",
                             batch_sizes: tuple = (1, 4, 8),
                             blob: Optional[np.ndarray] = None) -> Dict[str, dict]:
    """The batched device-codebook pipeline, K1 → K4 → K2, on B distinct
    ``size_mb`` MiB chunks a call for each B: the three batched entry points
    that ``GpuChunkCodec.encode_chunk_batch`` calls (``histogram_batch``,
    ``codebook_batch``, ``encode_batch``), with nothing fetched in between.
    The chunks are ``blob``'s rows (:func:`batch_chunks`, made here when it
    is ``None``).  Each B is first checked row by row against
    ``np.bincount`` and the unbatched kernels.  Rows ``pipeline-b<B>``
    (:func:`batch_row`)."""
    dev = cuda_device("run_pipeline_batch_bench")
    from .. import ops
    from ..tools import copies, cuda_ms, graph_ms

    n = size_mb << 20
    out_words = (9 * n + 31) // 32 + 2
    blob = _blob("run_pipeline_batch_bench", blob, size_mb, kind, batch_sizes)
    results: Dict[str, dict] = {}
    for B in batch_sizes:
        x = torch.from_numpy(blob[:B].copy()).to(dev)
        valid = [n] * B

        def step(t, valid=valid):
            lens, codes = ops.codebook_batch(ops.histogram_batch(t, valid))
            return ops.encode_batch(t, valid, lens, codes, out_words, SUBBLOCK)

        hist = ops.histogram_batch(x, valid)
        lens, codes = ops.codebook_batch(hist)
        words, totals, gaps = ops.encode_batch(x, valid, lens, codes, out_words, SUBBLOCK)
        for b in range(B):
            kl, kc = ops.codebook(hist[b])
            kw, ktb, kg = ops.encode(x[b], n, kl, kc, out_words, SUBBLOCK)
            live = (int(ktb) + 31) // 32
            _exact(f"pipeline-b{B} row {b}",
                   np.array_equal(hist[b].cpu().numpy(), np.bincount(blob[b], minlength=256))
                   and torch.equal(lens[b].cpu(), kl.cpu())
                   and torch.equal(codes[b].cpu(), kc.cpu()) and int(totals[b]) == int(ktb)
                   and torch.equal(words[b, :live].cpu(), kw[:live].cpu())
                   and torch.equal(gaps[b].cpu(), kg.cpu()), f"{size_mb} MiB of {kind}")
        del hist, lens, codes, words, totals, gaps
        xs = copies(x)
        results[f"pipeline-b{B}"] = batch_row(B, n, graph_ms(step, xs, 24),
                                              cuda_ms(step, xs, 24))
        del x, xs
    return results


def run_decode_batch_bench(size_mb: int = 16, kind: str = "text",
                           batch_sizes: tuple = (1, 4, 8),
                           blob: Optional[np.ndarray] = None) -> Dict[str, dict]:
    """The batched decoder, K3, on B distinct encoded ``size_mb`` MiB chunks
    a call for each B, through ``decode_batch``, the entry point that
    ``GpuChunkCodec.decode_chunk_batch`` calls.  The chunks are ``blob``'s
    rows, as in :func:`run_pipeline_batch_bench`.  Each chunk has its own
    v2 codebook (``fast``, the auto cap, as the fast path writes it),
    encoded by K2; each B is first checked to return its chunks.  Rows
    ``decode-b<B>`` (:func:`batch_row`)."""
    dev = cuda_device("run_decode_batch_bench")
    from .. import ops
    from ..core.huffman import build_codebook
    from ..tools import copies, cuda_ms, graph_ms

    n = size_mb << 20
    out_words = (9 * n + 31) // 32 + 2
    blob = _blob("run_decode_batch_bench", blob, size_mb, kind, batch_sizes)
    streams, gap_rows, tables = [], [], []
    for row in blob[:max(batch_sizes)]:
        lengths, codes = build_codebook(np.bincount(row, minlength=256), mode="fast",
                                        max_len=-1)
        lt, ct = ops.codebook_to_torch(lengths, codes, dev)
        kw, ktb, kg = ops.encode(torch.from_numpy(row.copy()).to(dev), n, lt, ct, out_words,
                                 SUBBLOCK)
        tb = int(ktb)
        streams.append(ops.payload_to_words(ops.words_to_bytes(
            kw[: (tb + 31) // 32].cpu().numpy(), tb)))
        gap_rows.append(kg.cpu().numpy())
        tables.append(ops.build_decode_tables(lengths))
    results: Dict[str, dict] = {}
    for B in batch_sizes:
        word_off = np.cumsum([0] + [s.size for s in streams[:B]]).tolist()
        gap_off = np.cumsum([0] + [g.size for g in gap_rows[:B]]).tolist()
        w = torch.from_numpy(np.concatenate(streams[:B])).to(dev)
        g = torch.from_numpy(np.concatenate(gap_rows[:B])).to(dev)
        lim, adj, sym = (torch.from_numpy(np.stack([t[k] for t in tables[:B]])).to(dev)
                         for k in range(3))
        valid = [n] * B

        def step(w_, g_, word_off=word_off, gap_off=gap_off, lim=lim, adj=adj, sym=sym,
                 valid=valid):
            return ops.decode_batch(w_, word_off, g_, gap_off, lim, adj, sym, SUBBLOCK, valid)

        _exact(f"decode-b{B}", np.array_equal(step(w, g).cpu().numpy(), blob[:B].ravel()),
               f"{size_mb} MiB of {kind}")
        ws = copies(w, g)
        results[f"decode-b{B}"] = batch_row(B, n, graph_ms(step, ws, 24), cuda_ms(step, ws, 24))
        del w, g, ws
    return results


def format_pipeline_batch_results(results: Dict[str, dict], size_mb: int) -> str:
    lines = [
        "",
        f"Batched device calls ({size_mb} MiB chunks; device time by CUDA-graph replay, "
        "overhead = call time by events minus device time; pipeline-b* = "
        "hist→codebook→encode, decode-b* = gap-array decode)",
        "=" * 78,
    ]
    for name, r in results.items():
        lines.append(
            f"  {name:<14} compute {r['compute_ms_per_chunk']:9.4f} ms/chunk "
            f"({r['mbps_per_chunk']:9.1f} MB/s)  "
            f"overhead {r['overhead_ms_per_program']:8.4f} ms/program = "
            f"{r['overhead_ms_per_chunk']:8.4f} ms/chunk"
        )
    lines.append("=" * 78)
    return "\n".join(lines)


def format_kernel_results(results: Dict[str, dict], size_mb: int, fmt: str = "console") -> str:
    device = results.get("_device")
    if fmt == "json":
        return json.dumps({"chunk_mb": size_mb, "device": device,
                           "kernels": {k: v for k, v in results.items() if k != "_device"}},
                          indent=2)
    lines = ["", f"Device kernel benchmarks ({size_mb} MiB chunk; device time by CUDA-graph "
             "replay, call time by events)", "=" * 78]
    for name, r in results.items():
        if name.startswith("_"):
            continue
        tp = f"{r['mbps']:10.1f} MB/s" if r["mbps"] else " " * 15
        lines.append(f"  {name:<18} {r['ms_per_chunk']:9.4f} ms (call {r['call_ms']:8.4f}) {tp}"
                     f"  bound {r['bound_ms']:8.4f} ms [{r['bound_kind']}] "
                     f"eff {r['efficiency']:.0%}")
    for name, why in results.get("_skipped", {}).items():
        lines.append(f"  {name:<18} not run: {why}")
    prim = results.get("_primitives")
    if prim:
        def show(key, fmt_):
            return "not measured (suspect)" if prim[key] is None else fmt_.format(prim[key])

        lines.append(
            f"  primitives: HBM copy {show('hbm_copy_bytes_per_s', '{:.4g} B/s')} "
            f"({show('hbm_copy_peak_frac', '{:.1%}')} of 3.35 TB/s), gather "
            f"{show('gather_ns', '{:.4f}')} ns/elem, atomic add "
            f"{show('atomic_add_ns', '{:.4f}')} ns/idx, launch floor "
            f"{show('launch_floor_ms', '{:.5f}')} ms")
        for s in prim.get("suspect", []):
            lines.append(f"  suspect: {s}")
    if device:
        lines.append(f"  device: {device['name']}, power limit {device['power_limit']}")
    lines.append("=" * 78)
    return "\n".join(lines)
