"""Service layer of the port: the GPU service, the host codec (selected by
``force_cpu``; it never redoes a failed GPU operation), the shared pipeline
and the factories."""

from .base import CompressionService, FrequencyService
from .cpu_service import CpuCompressionService, CpuFrequencyService
from .factory import create_compression_service, create_frequency_service
from .gpu_service import (
    GpuChunkCodec,
    GpuCompressionService,
    GpuFrequencyService,
    get_available_devices,
    pick_device,
)
from .pipeline import ChunkCodec, ChunkedPipeline, EncodedChunk

__all__ = [
    "CompressionService",
    "FrequencyService",
    "CpuCompressionService",
    "CpuFrequencyService",
    "create_compression_service",
    "create_frequency_service",
    "GpuChunkCodec",
    "GpuCompressionService",
    "GpuFrequencyService",
    "get_available_devices",
    "pick_device",
    "ChunkCodec",
    "ChunkedPipeline",
    "EncodedChunk",
]
