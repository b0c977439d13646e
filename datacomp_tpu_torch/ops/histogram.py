"""K1: the 256-bin byte histogram, as a CUDA kernel and as plain PyTorch.

Counterpart of ``datacomp_tpu/ops/histogram_pallas.py::histogram_pallas``
and ``datacomp_tpu/ops/histogram.py::histogram_device``: the int32[256]
histogram of ``data[:valid_len]``.  The kernel is ``csrc/histogram.cu``.
"""

from __future__ import annotations

import torch

from . import _build

#: calls that launched the kernel, and calls of the plain version
kernel_launches = _build.LaunchCounter()
reference_calls = _build.LaunchCounter()


def bincount(data: torch.Tensor, valid_len: int) -> torch.Tensor:
    """int32[256] ``torch.bincount`` of the bytes below ``valid_len`` (the
    plain version of K1 and of its A/B variants, uncounted)."""
    return torch.bincount(data[:valid_len].long(), minlength=256).to(torch.int32)


def histogram_reference(data: torch.Tensor, valid_len: int) -> torch.Tensor:
    """Plain PyTorch: ``torch.bincount`` of the bytes below ``valid_len``."""
    reference_calls.add()
    return bincount(data, valid_len)


def check_args(data: torch.Tensor, valid_len: int) -> bool:
    """Raise unless ``data`` is a uint8 chunk with ``valid_len`` inside it that
    the kernels take; return True when it lies on the CPU."""
    _build.check_tensor(data, "data", torch.uint8)
    n = data.numel()
    if not 0 <= valid_len <= n:
        raise ValueError(f"valid_len {valid_len} outside [0, {n}]")
    if n >= 1 << 31:
        raise ValueError(f"histogram counts are int32: {n} bytes is too many")
    if _build.on_cpu(data):
        return True
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned for the kernel's vector loads")
    return False


def histogram(data: torch.Tensor, valid_len: int) -> torch.Tensor:
    """int32[256] histogram of ``data[:valid_len]`` (``data``: uint8[n]).

    A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
    The kernel's scratch is a partial histogram for each of its blocks, one a
    multiprocessor: 132 KiB on an H100.
    """
    valid_len = int(valid_len)
    if check_args(data, valid_len):
        return histogram_reference(data, valid_len)
    blocks = torch.cuda.get_device_properties(data.device).multi_processor_count
    hist = torch.empty(256, dtype=torch.int32, device=data.device)
    partial = torch.empty(blocks * 256, dtype=torch.int32, device=data.device)
    lib = _build.library()
    with torch.cuda.device(data.device):
        rc = lib.dcz_histogram(data.data_ptr(), valid_len, hist.data_ptr(),
                               partial.data_ptr(), blocks, _build.stream(data))
    _build.check(rc, "histogram")
    kernel_launches.add()
    return hist
