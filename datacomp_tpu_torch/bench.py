"""The port's headline benchmark: end-to-end compression throughput, best
backend, with the GPU service on the card.

    python -m datacomp_tpu_torch.bench

The counterpart of root ``bench.py``.  It times the full service path (file
I/O, SHA-256, histogram, codebook, encode, container write) of each backend
on the same mixed corpus, checks a byte-exact decompress round trip, and
reports the faster backend's compress MB/s as the headline, against the
reference's 12.6 MB/s.  Stdout gets exactly one JSON line; everything else
goes to stderr.

Environment (root ``bench.py``'s): ``BENCH_SIZE_MB`` (128),
``BENCH_CHUNK_MB`` (16), ``BENCH_ITERS`` (2) and ``BENCH_BACKENDS``
(``cpu,gpu``).  The legs:

* ``cpu``: the host codec (``CpuCompressionService``) in format v2;
* ``gpu``: ``GpuCompressionService`` in format v2 with host codebooks
  (``codebook_mode="fast"``), ``device.batch_chunks`` as shipped.  Its
  availability probe (kernel K1, which builds the kernels on first use) and
  a warm-up compress and decompress come before anything is timed.  The
  config's ``DATACOMP_DEVICE_PLATFORM=cpu`` runs it on the kernels' plain
  versions, with no link to probe.

Around the ``gpu`` leg on a card, the host-device link is probed
(:func:`probe_link`, pageable copies as the service makes them), and the
line carries the leg's half-duplex transfer ceiling
(:func:`link_ceiling_mbps`) and its share of it.

There is no fallback that hides the device: when a leg that was asked for
fails (no CUDA device, a failed probe, an exception, a round-trip
mismatch), the line is ``{"error": ...}`` and the exit code 1; a ``cpu``
result is never reported in place of a failed ``gpu`` leg.
"""

from __future__ import annotations

import filecmp
import json
import os
import sys
import tempfile
import time
import traceback

import torch

from .config import load_config
from .core import read_container
from .services import CpuCompressionService, GpuCompressionService
from .services.gpu_service import resolve_batch_chunks
from .utils.testdata import generate_bytes

BASELINE_MBPS = 12.6  # the reference's GPU-mode end-to-end compression (root bench.py)
BACKENDS = ("cpu", "gpu")
CORPUS_KINDS = ("text", "compressible", "skewed", "random")  # a quarter each, random the rest
LINK_SIZES_MB = (16, 64)  # the probe's two copy sizes, MiB: their slope cancels per-call costs
LINK_REPEATS = 3
LINK_MAX_MBPS = 1e5  # a probed rate outside (0, this) is an error
LINK_KEYS = tuple(
    [f"gpu_link_{k}" for k in ("h2d_mbps", "d2h_mbps", "latency_ms")]
    + [f"gpu_link_{k}_{tag}" for tag in ("start", "end")
       for k in ("h2d_mbps", "d2h_mbps", "latency_ms")]
    + ["gpu_link_drift", "gpu_link_ceiling_mbps", "gpu_vs_link_ceiling"]
)


class BenchError(RuntimeError):
    """A leg that was asked for gave no number."""


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def write_corpus(path: str, size_mb: int) -> None:
    """Root ``bench.py``'s corpus: ``size_mb // 4`` MiB (at least 1) each of
    ``text``, ``compressible`` and ``skewed``, then ``random`` for the rest
    (at least 1 MiB)."""
    mb = 1 << 20
    per = max(size_mb // 4, 1)
    with open(path, "wb") as f:
        for kind in CORPUS_KINDS[:3]:
            f.write(generate_bytes(kind, per * mb))
        f.write(generate_bytes(CORPUS_KINDS[3], max(size_mb - 3 * per, 1) * mb))


def time_service(svc, src: str, dcz: str, out: str, iters: int) -> dict:
    """Root ``bench.py``'s ``_time_service``: a warm-up compress, then the
    best of ``iters``; a warm-up decompress, then the best of ``iters``; the
    restored file byte for byte against ``src`` (raises on a mismatch)."""
    svc.compress(src, dcz)  # warm-up
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        svc.compress(src, dcz)
        times.append(time.perf_counter() - t0)
    svc.decompress(dcz, out)  # warm-up
    dec_times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        svc.decompress(dcz, out)
        dec_times.append(time.perf_counter() - t0)
    if not filecmp.cmp(src, out, shallow=False):
        raise BenchError(f"round trip mismatch: {out} differs from {src}")
    size = os.path.getsize(src)
    log(f"{svc.get_service_name()}: compress s {times}, decompress s {dec_times}")
    return {
        "compress_mbps": round(size / 1e6 / min(times), 2),
        "decompress_mbps": round(size / 1e6 / min(dec_times), 2),
        "ratio": round(os.path.getsize(dcz) / size, 4),
    }


def link_rates(times: dict) -> dict:
    """H2D and D2H MB/s from ``{size_mib: (h2d_s, d2h_s)}`` at two sizes:
    the slope between them, so per-call constants cancel, and the H2D
    latency those constants leave at the smaller size.  A rate outside
    (0, ``LINK_MAX_MBPS``) raises."""
    lo, hi = min(times), max(times)
    span = (hi - lo) * (1 << 20) / 1e6  # MB (1e6 bytes) between the two sizes
    rates = {}
    for i, key in enumerate(("h2d_mbps", "d2h_mbps")):
        dt = times[hi][i] - times[lo][i]
        rate = span / dt if dt > 0 else float("inf")
        if not 0 < rate < LINK_MAX_MBPS:
            raise BenchError(f"link probe: {key} {rate} outside (0, {LINK_MAX_MBPS}) "
                             f"from copy times {times}")
        rates[key] = rate
    latency = max(times[lo][0] - lo * (1 << 20) / 1e6 / rates["h2d_mbps"], 0.0) * 1e3
    return {"h2d_mbps": round(rates["h2d_mbps"], 1), "d2h_mbps": round(rates["d2h_mbps"], 1),
            "latency_ms": round(latency, 3)}


def probe_link(device) -> dict:
    """The card's counterpart of root ``bench.py``'s ``probe_relay``: the
    best of ``LINK_REPEATS`` timed copies of each of ``LINK_SIZES_MB``, host
    to device and back, pageable on both sides as the service copies (a new
    host tensor for each copy back), with the device synchronised around
    each copy."""
    device = torch.device(device)
    if device.type != "cuda":
        raise BenchError(f"the link probe needs a CUDA device, not {device}")
    times = {}
    for mb in LINK_SIZES_MB:
        host = torch.ones(mb << 20, dtype=torch.uint8)
        h2d = d2h = float("inf")
        for i in range(LINK_REPEATS + 1):  # the first round warms both directions
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            x = host.to(device)
            torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            x.cpu()
            torch.cuda.synchronize(device)
            t2 = time.perf_counter()
            if i:
                h2d, d2h = min(h2d, t1 - t0), min(d2h, t2 - t1)
        times[mb] = (h2d, d2h)
    return link_rates(times)


def link_ceiling_mbps(overall_ratio: float, raw_frac: float, h2d: float, d2h: float) -> float:
    """Root ``bench.py``'s ``relay_ceiling_mbps`` with the rates required:
    the compress MB/s that the link alone allows when every coded byte goes
    up once and its words come back over the same serialised link (the
    service's copies share one stream).  ``raw_frac`` is the share of input
    bytes that the host prepass stores raw, which never ride the link."""
    live = 1.0 - raw_frac
    live_ratio = max(min((overall_ratio - raw_frac) / max(live, 1e-9), 1.0), 0.0)
    s_per_mb = live / h2d + live * live_ratio / d2h
    return 1.0 / s_per_mb if s_per_mb > 0 else float("inf")


def raw_fraction(dcz: str, size: int) -> float:
    """The share of ``size`` input bytes that ``dcz`` stores raw (v2 chunks
    with no codebook)."""
    header, _ = read_container(dcz)
    raw = sum(m.original_size for m in header.chunks if not m.code_lengths.any())
    return raw / size


def link_fields(start: dict, end: dict, result: dict, raw_frac: float) -> dict:
    """The line's ``gpu_link_*`` fields: the mean of the probes at the start
    and the end of the leg, each probe, their largest relative spread, and
    the ceiling at the mean rates with the leg's share of it."""
    mean = {k: (start[k] + end[k]) / 2 for k in start}
    fields = {"gpu_link_h2d_mbps": round(mean["h2d_mbps"], 1),
              "gpu_link_d2h_mbps": round(mean["d2h_mbps"], 1),
              "gpu_link_latency_ms": round(mean["latency_ms"], 3)}
    for tag, probe in (("start", start), ("end", end)):
        fields.update({f"gpu_link_{k}_{tag}": v for k, v in probe.items()})
    fields["gpu_link_drift"] = round(max(
        abs(start[k] - end[k]) / max(mean[k], 1e-9) for k in ("h2d_mbps", "d2h_mbps")), 3)
    ceiling = link_ceiling_mbps(result["ratio"], raw_frac, mean["h2d_mbps"], mean["d2h_mbps"])
    fields["gpu_link_ceiling_mbps"] = round(ceiling, 1)
    fields["gpu_vs_link_ceiling"] = round(result["compress_mbps"] / ceiling, 3)
    return fields


def cpu_config(chunk_mb: int):
    """The ``cpu`` leg's config: format v2 (root ``bench.py:173-175``)."""
    return load_config(compression={"chunk_size_mb": chunk_mb, "format_version": 2})


def gpu_config(chunk_mb: int):
    """The ``gpu`` leg's config: format v2 with host codebooks, the JAX
    device leg's (root ``bench.py:200-205``)."""
    return load_config(compression={"chunk_size_mb": chunk_mb, "format_version": 2,
                                    "codebook_mode": "fast"})


def cpu_leg(src: str, workdir: str, chunk_mb: int, iters: int) -> dict:
    with CpuCompressionService(cpu_config(chunk_mb)) as svc:
        return time_service(svc, src, os.path.join(workdir, "c.dcz"),
                            os.path.join(workdir, "c.out"), iters)


def gpu_leg(src: str, workdir: str, chunk_mb: int, iters: int) -> tuple:
    """``(result, link fields, device)``: the GPU service's rates, its link
    fields (None on the plain versions, which have no link) and the device
    it ran on."""
    cfg = gpu_config(chunk_mb)
    dcz = os.path.join(workdir, "g.dcz")
    with GpuCompressionService(cfg) as svc:
        t0 = time.perf_counter()
        if not svc.is_available():
            raise BenchError(f"GPU service on {svc.device}: the availability probe failed")
        batch = resolve_batch_chunks(cfg.device.batch_chunks, svc.device)
        log(f"gpu: {svc.device}, batch_chunks {batch}; availability "
            f"probe (K1, the kernels' first build or load) {time.perf_counter() - t0} s")
        on_card = svc.device.type == "cuda"
        start = probe_link(svc.device) if on_card else None
        result = time_service(svc, src, dcz, os.path.join(workdir, "g.out"), iters)
        end = probe_link(svc.device) if on_card else None
    if not on_card:
        return result, dict.fromkeys(LINK_KEYS), svc.device
    raw_frac = raw_fraction(dcz, os.path.getsize(src))
    log(f"gpu: link at start {start}, at end {end}; raw-stored share {raw_frac}")
    return result, link_fields(start, end, result, raw_frac), svc.device


def device_fields(device) -> dict:
    """The card's name and power limit (``benchmark.kernels.device_info``),
    or the CPU's name when no leg ran on a card."""
    if device is None or torch.device(device).type != "cuda":
        return {"name": "cpu", "power_limit": None}
    from .benchmark.kernels import device_info

    with torch.cuda.device(device):
        return device_info()


def check_backends(backends) -> None:
    if not backends or not set(backends) <= set(BACKENDS):
        raise BenchError(f"backends {list(backends)}: each must be one of {list(BACKENDS)}")


def run(src: str, workdir: str, chunk_mb: int, iters: int, backends) -> dict:
    """Every leg in ``backends`` on the corpus at ``src``: the headline line
    as a dict.  Raises when a leg fails or a backend is unknown."""
    check_backends(backends)
    results, link, device = {}, {}, None
    for backend in BACKENDS:
        if backend not in backends:
            continue
        try:
            if backend == "cpu":
                results["cpu"] = cpu_leg(src, workdir, chunk_mb, iters)
            else:
                results["gpu"], link, device = gpu_leg(src, workdir, chunk_mb, iters)
        except Exception as e:
            raise BenchError(f"{backend} leg: {type(e).__name__}: {e}") from e
        log(f"{backend}: {results[backend]}")
    best = max(results, key=lambda k: results[k]["compress_mbps"])
    mbps = results[best]["compress_mbps"]
    return {
        "metric": "end_to_end_compress_throughput",
        "value": mbps,
        "unit": "MB/s",
        "vs_baseline": round(mbps / BASELINE_MBPS, 2),
        "best_backend": best,
        "file_mb": os.path.getsize(src) >> 20,  # the corpus is whole MiB
        "iters": iters,
        **{f"{k}_{m}": v for k, r in results.items() for m, v in r.items()},
        **link,
        "device": device_fields(device),
    }


def main() -> int:
    size_mb = int(os.environ.get("BENCH_SIZE_MB", "128"))
    chunk_mb = int(os.environ.get("BENCH_CHUNK_MB", "16"))
    iters = int(os.environ.get("BENCH_ITERS", "2"))
    backends = [b.strip() for b in os.environ.get("BENCH_BACKENDS", "cpu,gpu").split(",")
                if b.strip()]
    try:
        check_backends(backends)
        with tempfile.TemporaryDirectory() as d:
            src = os.path.join(d, "bench.bin")
            write_corpus(src, size_mb)
            line = run(src, d, chunk_mb, iters, backends)
    except Exception as e:  # noqa: BLE001 — the one line reports what failed
        traceback.print_exc(file=sys.stderr)
        print(json.dumps({"error": str(e)[:500]}), flush=True)
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
