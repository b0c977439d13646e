"""Device ops of the port: each a hand-written CUDA kernel with its plain
PyTorch version beside it (K1 histogram, K2 encode, K3 decode, K4 codebook,
K5 gap finder, and K1's A/B variants K1s and K1p).  K1-K4 also take a batch
of chunks in one launch (``*_batch``), each batched entry point with its own
counts; K5 takes a batch always."""

from . import codebook as _codebook_mod
from . import decode as _decode_mod
from . import encode as _encode_mod
from . import gap_finder as _gap_finder_mod
from . import histogram as _histogram_mod
from ._build import MAX_ROWS
from .codebook import codebook, codebook_batch, codebook_batch_reference, codebook_reference
from .codebook import kernel_launches as _codebook_launches
from .codebook import reference_calls as _codebook_references

from .decode import (
    TABLE_BITS,
    kernel_launches as _decode_launches,
    reference_calls as _decode_references,
    build_decode_tables,
    decode,
    decode_batch,
    decode_batch_reference,
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
    encode_batch,
    encode_batch_reference,
    encode_reference,
    words_to_bytes,
)
from .gap_finder import find_gaps, find_gaps_reference, gap_offsets
from .gap_finder import fits as gap_finder_fits
from .histogram import (
    histogram,
    histogram_batch,
    histogram_batch_reference,
    histogram_reference,
)
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
    "histogram_batch": (_histogram_mod.batch_launches, _histogram_mod.batch_reference_calls),
    "codebook_batch": (_codebook_mod.batch_launches, _codebook_mod.batch_reference_calls),
    "encode_batch": (_encode_mod.batch_launches, _encode_mod.batch_reference_calls),
    "decode_batch": (_decode_mod.batch_launches, _decode_mod.batch_reference_calls),
    "find_gaps": (_gap_finder_mod.kernel_launches, _gap_finder_mod.reference_calls),
}


def reset_counters() -> None:
    for counters in COUNTERS.values():
        for c in counters:
            c.reset()


__all__ = [
    "COUNTERS",
    "MAX_ROWS",
    "reset_counters",
    "TABLE_BITS",
    "build_decode_tables",
    "decode",
    "decode_batch",
    "decode_batch_reference",
    "decode_reference",
    "decode_tables_to_torch",
    "max_code_len",
    "payload_to_words",
    "MAX_CODE_LEN",
    "codebook_to_torch",
    "encode",
    "encode_batch",
    "encode_batch_reference",
    "encode_reference",
    "words_to_bytes",
    "find_gaps",
    "find_gaps_reference",
    "gap_finder_fits",
    "gap_offsets",
    "histogram",
    "histogram_batch",
    "histogram_batch_reference",
    "histogram_reference",
    "codebook",
    "codebook_batch",
    "codebook_batch_reference",
    "codebook_reference",
    "PARTIAL_K",
    "STACKED",
    "histogram_partial",
    "histogram_stacked",
]
