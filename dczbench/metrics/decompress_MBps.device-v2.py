"""The window's restore rate, restored bytes (1e6 a MB) over the sum of the
restore calls' seconds: the end-to-end ``decompress_MBps``, read per layer in
the cells where its runs spread too widely for a bound."""

from dczbench.readers import rate_mb_per_s


def read(run):
    return rate_mb_per_s(run, "restore")
