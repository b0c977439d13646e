"""K2 (``csrc/encode.cu``): the bytes encoding needs (each coded chunk read
once, its payload words written once) at 3.35 TB/s, over K2's traced device
time in compress calls, in %."""

from dczbench import work
from dczbench.readers import roofline_pct

#: base names of the kernels (no namespace or template) that make up K2
KERNELS = ("encode_kernel",)


def read(run):
    return roofline_pct(run, "compress", KERNELS, work.k2_bytes(run.chunks))
