"""CPU-vs-GPU benchmark suite: the port of ``datacomp_tpu/benchmark/suite.py``.

Config-driven warm-up and measurement iterations of ``compress`` and
``decompress`` for each service, per-stage durations, and the comparison as a
speedup of the GPU service over the host codec, in the JAX package's console,
JSON and CSV formats.  Two departures from the JAX suite, whose service list
drops a device that fails to start and whose profiler is best-effort:

* the services follow the factory's rule: ``device.force_cpu`` gives the
  host codec (``"CPU"``) alone; otherwise the host codec and the GPU service,
  which raises without a CUDA device.  Under ``device.platform=cpu`` the GPU
  service runs the kernels' plain versions, and its row's name says so;
* ``benchmark.detailed_profiling`` wraps the measured compresses in
  ``torch.profiler`` and writes ``<workdir>/torch-trace-<service>.json``
  (:func:`device_time_split` reads it); an error propagates.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from ..config import AppConfig, load_config

#: trace events the device ran (CUPTI's categories in a chrome trace)
DEVICE_EVENTS = {"kernel": "kernel_ms", "gpu_memcpy": "memcpy_ms", "gpu_memset": "memset_ms"}


@dataclass
class BenchmarkResult:
    service_name: str
    operation: str  # "compress" | "decompress"
    file_size: int
    iterations: int
    durations_s: List[float] = field(default_factory=list)
    compressed_size: int = 0
    stage_ms: Dict[str, float] = field(default_factory=dict)

    @property
    def mean_s(self) -> float:
        return statistics.mean(self.durations_s) if self.durations_s else 0.0

    @property
    def best_s(self) -> float:
        return min(self.durations_s) if self.durations_s else 0.0

    @property
    def throughput_mbps(self) -> float:
        return self.file_size / 1e6 / self.mean_s if self.mean_s else 0.0

    @property
    def best_throughput_mbps(self) -> float:
        return self.file_size / 1e6 / self.best_s if self.best_s else 0.0

    @property
    def compression_ratio(self) -> float:
        return self.compressed_size / self.file_size if self.file_size else 0.0

    def as_dict(self) -> dict:
        return {
            "service": self.service_name,
            "operation": self.operation,
            "file_size": self.file_size,
            "iterations": self.iterations,
            "mean_s": self.mean_s,
            "best_s": self.best_s,
            "throughput_mbps": self.throughput_mbps,
            "best_throughput_mbps": self.best_throughput_mbps,
            "compression_ratio": self.compression_ratio,
            "stage_ms": self.stage_ms,
        }


def gpu_row_name(svc) -> str:
    """The GPU service's row: ``GPU (<card>)``, or ``GPU (plain PyTorch on
    the CPU)`` when it runs on the CPU, so that no CPU time stands under a
    card's name."""
    if svc.device.type == "cuda":
        return f"GPU ({torch.cuda.get_device_name(svc.device)})"
    return "GPU (plain PyTorch on the CPU)"


def device_time_split(trace_path: str) -> Optional[dict]:
    """The device's share of a ``torch.profiler`` chrome trace: milliseconds
    of kernels, copies and fills, the time the device was busy with any of
    them (overlaps counted once), the profiled window, and the idle share of
    that window.  None when the trace holds no device event."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_EVENTS]
    if not device:
        return None
    whole = [e for e in events if e.get("cat") == "Trace"] or events
    start = min(e["ts"] for e in whole)
    window_us = max(e["ts"] + e["dur"] for e in whole) - start
    out = {name: 0.0 for name in DEVICE_EVENTS.values()}
    for e in device:
        out[DEVICE_EVENTS[e["cat"]]] += e["dur"] / 1e3
    busy_us, end = 0.0, None
    for e in sorted(device, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if end is None or lo > end:
            busy_us += hi - lo
            end = hi
        elif hi > end:
            busy_us += hi - end
            end = hi
    out.update(busy_ms=busy_us / 1e3, window_ms=window_us / 1e3,
               idle_share=1.0 - busy_us / window_us, events=len(device))
    return out


class BenchmarkSuite:
    def __init__(self, config: Optional[AppConfig] = None):
        self.config = config or load_config()

    def _services(self) -> list:
        """[(row name, service)]: the host codec, then the GPU service unless
        ``device.force_cpu`` (the factory's rule; it raises without a card)."""
        from ..services import CpuCompressionService, create_compression_service

        gpu = [] if self.config.device.force_cpu else [
            create_compression_service(self.config, force_cpu=False)]
        return [("CPU", CpuCompressionService(self.config))] + [
            (gpu_row_name(svc), svc) for svc in gpu]

    def _profiler(self):
        """``torch.profiler`` of the host and, where there is one, the CUDA
        device, under ``benchmark.detailed_profiling``; else no profiler."""
        if not self.config.benchmark.detailed_profiling:
            return contextlib.nullcontext()
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    def benchmark_service(
        self, svc, name: str, input_path: str, workdir: str
    ) -> List[BenchmarkResult]:
        """One service's warm-up and measurement cycle.  With
        ``benchmark.detailed_profiling`` a ``torch.profiler`` trace of the
        measured compresses is written to
        ``<workdir>/torch-trace-<first word of name>.json``."""
        warmup = self.config.benchmark.warmup_iterations
        measure = self.config.benchmark.measurement_iterations
        file_size = os.path.getsize(input_path)
        slug = name.split()[0]
        dcz = os.path.join(workdir, f"bench_{slug}.dcz")
        out = os.path.join(workdir, f"bench_{slug}.out")

        comp = BenchmarkResult(name, "compress", file_size, measure)
        for _ in range(warmup):
            svc.compress(input_path, dcz)
        with self._profiler() as prof:
            for _ in range(measure):
                t0 = time.perf_counter()
                svc.compress(input_path, dcz)
                comp.durations_s.append(time.perf_counter() - t0)
        if prof is not None:
            prof.export_chrome_trace(os.path.join(workdir, f"torch-trace-{slug}.json"))
        comp.compressed_size = os.path.getsize(dcz)
        comp.stage_ms = {
            k: v["ms"] for k, v in svc.get_last_stage_metrics().as_dict().items()
        }

        decomp = BenchmarkResult(name, "decompress", file_size, measure)
        for _ in range(warmup):
            svc.decompress(dcz, out)
        for _ in range(measure):
            t0 = time.perf_counter()
            svc.decompress(dcz, out)
            decomp.durations_s.append(time.perf_counter() - t0)
        decomp.compressed_size = comp.compressed_size
        decomp.stage_ms = {
            k: v["ms"] for k, v in svc.get_last_stage_metrics().as_dict().items()
        }
        for p in (dcz, out):
            if os.path.exists(p):
                os.remove(p)
        return [comp, decomp]

    def run_full_suite(
        self, input_path: Optional[str] = None, size_mb: int = 16
    ) -> List[BenchmarkResult]:
        results: List[BenchmarkResult] = []
        with tempfile.TemporaryDirectory() as workdir:
            if input_path is None:
                from ..utils.testdata import generate_compressible_file

                input_path = os.path.join(workdir, "bench_input.bin")
                generate_compressible_file(size_mb, input_path)
            services = self._services()
            try:
                for name, svc in services:
                    results.extend(
                        self.benchmark_service(svc, name, input_path, workdir)
                    )
            finally:
                for _, svc in services:
                    svc.close()
        return results

    @staticmethod
    def speedup(results: List[BenchmarkResult], operation: str = "compress") -> Optional[float]:
        """GPU-over-CPU speedup of ``operation``'s mean time (the JAX suite's
        TPU-over-CPU)."""
        by = {r.service_name.split()[0]: r for r in results if r.operation == operation}
        if "CPU" in by and "GPU" in by and by["GPU"].mean_s > 0:
            return by["CPU"].mean_s / by["GPU"].mean_s
        return None

    def format_results(self, results: List[BenchmarkResult], fmt: str = "console") -> str:
        if fmt == "json":
            return json.dumps(
                {
                    "results": [r.as_dict() for r in results],
                    "speedup_compress": self.speedup(results, "compress"),
                    "speedup_decompress": self.speedup(results, "decompress"),
                },
                indent=2,
            )
        if fmt == "csv":
            lines = ["service,operation,file_size,mean_s,best_s,throughput_mbps,ratio"]
            for r in results:
                lines.append(
                    f"{r.service_name},{r.operation},{r.file_size},"
                    f"{r.mean_s:.6f},{r.best_s:.6f},{r.throughput_mbps:.2f},"
                    f"{r.compression_ratio:.4f}"
                )
            return "\n".join(lines)
        lines = ["", "Benchmark Results", "=" * 68]
        for r in results:
            lines.append(
                f"  {r.service_name:<4} {r.operation:<10} "
                f"{r.file_size / 1e6:8.1f} MB  mean {r.mean_s * 1e3:9.1f} ms  "
                f"{r.throughput_mbps:9.1f} MB/s  ratio {r.compression_ratio * 100:6.2f}%"
            )
        gpu = next((r.service_name for r in results if r.service_name.startswith("GPU")), None)
        for op in ("compress", "decompress"):
            s = self.speedup(results, op)
            if s is not None:
                lines.append(f"  GPU speedup ({op}): {s:.2f}x  [{gpu}]")
        lines.append("=" * 68)
        return "\n".join(lines)
