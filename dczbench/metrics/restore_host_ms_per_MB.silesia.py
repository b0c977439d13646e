"""Pipeline and container I/O of restore calls, ms a MB restored: StageMetrics
CHECKSUM_VERIFY + FILE_IO, summed over worker threads."""

from dczbench.readers import stage_ms_per_mb


def read(run):
    return stage_ms_per_mb(run, "restore", ("CHECKSUM_VERIFY", "FILE_IO"))
