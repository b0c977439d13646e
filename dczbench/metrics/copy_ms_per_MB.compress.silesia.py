"""Device time of memcpy events inside compress calls (profiler trace), ms a
MB of input."""

from dczbench.readers import copy_ms_per_mb


def read(run):
    return copy_ms_per_mb(run, "compress")
