"""K3 (``csrc/decode.cu``): compressed bytes read and decoded bytes written,
for the chunks the device decodes, at 3.35 TB/s, over K3's traced device
time in restore calls, in %."""

from dczbench import work
from dczbench.readers import roofline_pct

#: base names of the kernels (no namespace or template) that make up K3
KERNELS = ("decode_kernel",)


def read(run):
    return roofline_pct(run, "restore", KERNELS, work.k3_bytes(run.chunks))
