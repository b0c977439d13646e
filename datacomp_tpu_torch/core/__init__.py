"""Core codec: canonical Huffman codebooks, bitstreams, and the `.dcz` container
(the port's copy of ``datacomp_tpu/core``, held to the same bytes by
``tests/test_torch_host.py``)."""

from .huffman import (
    ALPHABET_SIZE,
    AUTO_CAP,
    MAX_CODE_LEN,
    CorruptChunkError,
    build_code_lengths,
    build_codebook,
    canonical_codes_from_lengths,
    resolve_auto_cap,
    validate_lengths,
)
from .bitio import (
    CanonicalDecodeTables,
    decode_bitstream_py,
    encode_bitstream,
    encoded_size_bits,
)
from .container import (
    CHUNK_META_LEN_V1,
    MAGIC,
    VERSION_V1,
    VERSION_V2,
    ChunkMeta,
    ContainerError,
    ContainerHeader,
    TruncatedFooter,
    parse_footer,
    read_container,
    read_container_fp,
    scan_for_footer,
    serialize_footer,
    write_container,
)

__all__ = [
    "ALPHABET_SIZE",
    "AUTO_CAP",
    "MAX_CODE_LEN",
    "build_code_lengths",
    "build_codebook",
    "canonical_codes_from_lengths",
    "resolve_auto_cap",
    "validate_lengths",
    "CanonicalDecodeTables",
    "decode_bitstream_py",
    "encode_bitstream",
    "encoded_size_bits",
    "CHUNK_META_LEN_V1",
    "MAGIC",
    "VERSION_V1",
    "VERSION_V2",
    "ChunkMeta",
    "ContainerError",
    "ContainerHeader",
    "TruncatedFooter",
    "parse_footer",
    "read_container",
    "read_container_fp",
    "scan_for_footer",
    "serialize_footer",
    "write_container",
]
