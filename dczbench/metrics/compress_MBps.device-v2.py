"""The window's compress rate, input bytes (1e6 a MB) over the sum of the
compress calls' seconds, each from its start to its return: the end-to-end
``compress_MBps``, read per layer in the cells where its runs spread too
widely for a bound."""

from dczbench.readers import rate_mb_per_s


def read(run):
    return rate_mb_per_s(run, "compress")
