"""K1 (``csrc/histogram.cu``, device codebook only): each coded chunk read
once and its 1 KiB of counts written, at 3.35 TB/s, over K1's traced device
time in compress calls, in %.  No K1 launch in the window (a host codebook):
nothing to read."""

from dczbench import work
from dczbench.readers import roofline_pct

#: base names of the kernels (no namespace or template) that make up K1: the partial histograms and their sum
KERNELS = ("histogram_kernel", "histogram_sum_kernel")


def read(run):
    return roofline_pct(run, "compress", KERNELS, work.k1_bytes(run.chunks))
