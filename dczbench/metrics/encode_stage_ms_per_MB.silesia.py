"""Batching and transfers of compress calls, ms a MB of input: StageMetrics
ENCODING (upload, kernels, copy back, byte swap), summed over worker threads."""

from dczbench.readers import stage_ms_per_mb


def read(run):
    return stage_ms_per_mb(run, "compress", ("ENCODING",))
