"""The card's idle time in restore calls put down to batching and transfers
(spans ``decode``, ``decode_tables``, ``upload``, ``launch``, ``fetch``,
``unpack``), ms a MB restored."""

from dczbench.spans import idle_ms_per_mb


def read(run):
    return idle_ms_per_mb(run, "restore", "transfer")
