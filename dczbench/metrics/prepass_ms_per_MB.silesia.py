"""Host prepass of compress calls, ms a MB of input: StageMetrics
CHECKSUM_COMPUTE + FREQUENCY_ANALYSIS + HUFFMAN_TREE_BUILD (summed over the
pipeline's worker threads, so it can exceed the calls' wall time)."""

from dczbench.readers import stage_ms_per_mb


def read(run):
    return stage_ms_per_mb(run, "compress",
                           ("CHECKSUM_COMPUTE", "FREQUENCY_ANALYSIS", "HUFFMAN_TREE_BUILD"))
