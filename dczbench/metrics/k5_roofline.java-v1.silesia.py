"""K5, the gap finder (``csrc/gap_finder.cu``): each format-1 chunk's payload
read once and 4 bytes written a gap it finds, for the chunks whose codes the
device decoder takes, at 3.35 TB/s, over K5's traced device time in restore
calls, in %.  None where no K5 kernel ran (a program that decodes format 1
on the host)."""

from dczbench import work
from dczbench.readers import roofline_pct

#: base names of the kernels (no namespace or template) that make up K5
KERNELS = ("gap_finder_kernel",)
#: symbols a gap of a format-1 chunk decoded on the device (the program's
#: ``gpu_service.FORMAT1_SUBBLOCK``, format 2's default sub-block)
SUBBLOCK = 4032


def k5_bytes(chunks: list) -> int:
    return sum(c["size"] + 4 * -(-c["n"] // SUBBLOCK) for c in work.coded(chunks)
               if c["depth"] <= work.DEVICE_DECODE_MAX_BITS)


def read(run):
    return roofline_pct(run, "restore", KERNELS, k5_bytes(run.chunks))
