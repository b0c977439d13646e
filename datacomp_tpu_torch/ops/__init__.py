"""Device ops of the port: each a hand-written CUDA kernel with its plain
PyTorch version beside it (K1 histogram, K2 encode, K3 decode, K4 codebook,
and K1's A/B variants K1s and K1p)."""

from .codebook import codebook, codebook_reference
from .codebook import kernel_launches as _codebook_launches
from .codebook import reference_calls as _codebook_references

from .decode import (
    TABLE_BITS,
    kernel_launches as _decode_launches,
    reference_calls as _decode_references,
    build_decode_tables,
    decode,
    decode_reference,
    decode_tables_to_torch,
    max_code_len,
    payload_to_words,
)
from .encode import (
    MAX_CODE_LEN,
    kernel_launches as _encode_launches,
    reference_calls as _encode_references,
    codebook_to_torch,
    encode,
    encode_reference,
    words_to_bytes,
)
from .histogram import histogram, histogram_reference
from .histogram import kernel_launches as _histogram_launches
from .histogram import reference_calls as _histogram_references
from .histogram_variants import (
    PARTIAL_K,
    STACKED,
    histogram_partial,
    histogram_stacked,
    partial_launches as _partial_launches,
    partial_reference_calls as _partial_references,
    stacked_launches as _stacked_launches,
    stacked_reference_calls as _stacked_references,
)

#: op -> (calls that launched its kernel, calls of its plain version)
COUNTERS = {
    "histogram": (_histogram_launches, _histogram_references),
    "encode": (_encode_launches, _encode_references),
    "decode": (_decode_launches, _decode_references),
    "codebook": (_codebook_launches, _codebook_references),
    "histogram_stacked": (_stacked_launches, _stacked_references),
    "histogram_partial": (_partial_launches, _partial_references),
}


def reset_counters() -> None:
    for counters in COUNTERS.values():
        for c in counters:
            c.reset()


__all__ = [
    "COUNTERS",
    "reset_counters",
    "TABLE_BITS",
    "build_decode_tables",
    "decode",
    "decode_reference",
    "decode_tables_to_torch",
    "max_code_len",
    "payload_to_words",
    "MAX_CODE_LEN",
    "codebook_to_torch",
    "encode",
    "encode_reference",
    "words_to_bytes",
    "histogram",
    "histogram_reference",
    "codebook",
    "codebook_reference",
    "PARTIAL_K",
    "STACKED",
    "histogram_partial",
    "histogram_stacked",
]
