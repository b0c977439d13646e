"""Benchmark suite of the port (counterpart of ``datacomp_tpu/benchmark``):
the CPU-vs-GPU service suite (:mod:`.suite`), the corpus benchmark
(:mod:`.corpus`) and the kernel and batch benches on a CUDA device
(:mod:`.kernels`)."""

from .suite import BenchmarkResult, BenchmarkSuite

__all__ = ["BenchmarkResult", "BenchmarkSuite"]
