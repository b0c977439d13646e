"""Backend selection for the port (counterpart of
``datacomp_tpu/services/factory.py``): ``force_cpu`` (which the JAX
package's ``auto_detect = false`` sets, ``config.py``) selects the host codec
by choice; otherwise the GPU service, which raises when there is no CUDA
device or its histogram probe fails.  Nothing falls back silently: the JAX
factory's catch-to-CPU on a failed probe is not copied."""

from __future__ import annotations

from typing import Optional

from ..config import AppConfig, load_config
from .base import CompressionService, FrequencyService
from .cpu_service import CpuCompressionService, CpuFrequencyService
from .gpu_service import GpuCompressionService, GpuFrequencyService


def _forced(config: AppConfig, force_cpu: Optional[bool]) -> bool:
    return force_cpu if force_cpu is not None else config.device.force_cpu


def create_compression_service(
    config: Optional[AppConfig] = None, force_cpu: Optional[bool] = None,
) -> CompressionService:
    config = config or load_config()
    if _forced(config, force_cpu):
        return CpuCompressionService(config)
    svc = GpuCompressionService(config)
    if not svc.is_available():
        svc.close()
        raise RuntimeError(f"the histogram probe on {svc.device} gave a wrong result")
    return svc


def create_frequency_service(
    config: Optional[AppConfig] = None, force_cpu: Optional[bool] = None,
) -> FrequencyService:
    """``force_cpu`` → the host histogram; otherwise the device histogram
    (K1), which raises when there is no CUDA device or its probe fails."""
    config = config or load_config()
    if _forced(config, force_cpu):
        return CpuFrequencyService()
    svc = GpuFrequencyService(config)
    if not svc.is_available():
        raise RuntimeError(f"the histogram probe on {svc.device} gave a wrong result")
    return svc
