"""The plain reference that decides ``correct``.

NumPy, ``hashlib`` and ``struct`` only: it imports nothing of the program
under test (``datacomp_tpu_torch``) nor of the JAX package, and works every
answer out again from the bytes the harness generated.
"""

from .codec import (
    CODEBOOK_RULES,
    canonical_codes,
    code_lengths,
    encode_payload,
    expected_file,
    parse_container,
)

__all__ = [
    "CODEBOOK_RULES",
    "canonical_codes",
    "code_lengths",
    "encode_payload",
    "expected_file",
    "parse_container",
]
