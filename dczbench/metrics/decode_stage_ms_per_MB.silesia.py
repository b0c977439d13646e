"""Batching and transfers of restore calls, ms a MB restored: StageMetrics
DECODING (upload, K3, copy back; host decode of deep codes), summed over
worker threads."""

from dczbench.readers import stage_ms_per_mb


def read(run):
    return stage_ms_per_mb(run, "restore", ("DECODING",))
