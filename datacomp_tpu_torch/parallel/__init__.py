"""Several GPUs and hosts: the ranks of a ``torch.distributed`` job (one
process a GPU) or the GPUs of one process, the sharded compress and
decompress steps over them, and file compress and decompress across them
(counterpart of ``datacomp_tpu/parallel``)."""

from .mesh import Mesh, local_devices, make_mesh, rank_device
from .sharded import (
    check_decompress_step_params,
    make_sharded_compress_step,
    make_sharded_decompress_step,
    sharded_compress_arrays,
    sharded_decompress_arrays,
)
from .multihost import (
    ChunkAssignment,
    assemble_header,
    compress_multihost,
    decompress_multihost,
    global_offsets,
    initialize_distributed,
    interleave_gathered,
    process_allgather,
    spill_to_output,
    write_footer_host0,
    write_host_payloads,
)

__all__ = [
    "Mesh",
    "local_devices",
    "make_mesh",
    "rank_device",
    "check_decompress_step_params",
    "make_sharded_compress_step",
    "make_sharded_decompress_step",
    "sharded_compress_arrays",
    "sharded_decompress_arrays",
    "ChunkAssignment",
    "assemble_header",
    "compress_multihost",
    "decompress_multihost",
    "global_offsets",
    "initialize_distributed",
    "interleave_gathered",
    "process_allgather",
    "spill_to_output",
    "write_footer_host0",
    "write_host_payloads",
]
