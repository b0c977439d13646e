"""Benchmark of datacomp_tpu_torch on one CUDA card: python -m dczbench --help."""
