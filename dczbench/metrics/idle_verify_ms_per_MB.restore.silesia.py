"""The card's idle time in restore calls put down to SHA-256 verify (span
``verify``), ms a MB restored."""

from dczbench.spans import idle_ms_per_mb


def read(run):
    return idle_ms_per_mb(run, "restore", "verify")
