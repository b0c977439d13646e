"""The card's idle time in restore calls put down to file I/O (spans
``open``, ``pread``, ``pwrite``), ms a MB restored."""

from dczbench.spans import idle_ms_per_mb


def read(run):
    return idle_ms_per_mb(run, "restore", "io")
