"""The card's idle time in compress calls put down to the host prepass
(spans ``sha256``, ``histogram``, ``codebook``), ms a MB of input."""

from dczbench.spans import idle_ms_per_mb


def read(run):
    return idle_ms_per_mb(run, "compress", "prepass")
