"""Device time of memcpy events inside restore calls (profiler trace), ms a
MB restored."""

from dczbench.readers import copy_ms_per_mb


def read(run):
    return copy_ms_per_mb(run, "restore")
