"""Leaf-span seconds of all threads (``wait`` left out) over the compress
calls' seconds: how many host threads worked at once."""

from dczbench.spans import host_overlap


def read(run):
    return host_overlap(run, "compress")
