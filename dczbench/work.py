"""The bytes each kernel needs for the inputs a window served, counted from
the plain reference's expected chunks (each input byte read once, each output
byte written once), whatever kernel does the work.  A roofline share is these
bytes over 3.35 TB/s (the H100 SXM's published HBM rate, at 700 W) divided by
the kernel time traced on the served path."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
#: deepest code the device decoder takes; deeper chunks decode on the host
DEVICE_DECODE_MAX_BITS = 16


def coded(chunks: list) -> list:
    """The chunks that reach the device: every chunk not stored raw."""
    return [c for c in chunks if not c["raw"]]


def k1_bytes(chunks: list) -> int:
    """Histogram: the chunk read, 256 int32 counts written."""
    return sum(c["n"] + 1024 for c in coded(chunks))


def k2_bytes(chunks: list) -> int:
    """Encode: the chunk read, its payload written as whole 32-bit words."""
    return sum(c["n"] + 4 * -(-c["size"] // 4) for c in coded(chunks))


def k3_bytes(chunks: list) -> int:
    """Decode: the payload read, the chunk written, for the chunks whose codes
    the device decoder takes."""
    return sum(c["size"] + c["n"] for c in coded(chunks)
               if c["depth"] <= DEVICE_DECODE_MAX_BITS)
