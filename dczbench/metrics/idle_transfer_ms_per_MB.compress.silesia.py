"""The card's idle time in compress calls put down to batching and transfers
(spans ``encode``, ``upload``, ``launch``, ``fetch``, ``unpack``), ms a MB of
input."""

from dczbench.spans import idle_ms_per_mb


def read(run):
    return idle_ms_per_mb(run, "compress", "transfer")
