"""K1: the 256-bin byte histogram, as a CUDA kernel and as plain PyTorch.

Counterpart of ``datacomp_tpu/ops/histogram_pallas.py::histogram_pallas``
and ``datacomp_tpu/ops/histogram.py::histogram_device``: the int32[256]
histogram of ``data[:valid_len]``; :func:`histogram_batch` takes a batch of
chunks in one launch, as the JAX service's batched pipeline vmaps the Pallas
kernel.  The kernel is ``csrc/histogram.cu``.
"""

from __future__ import annotations

import torch

from . import _build

#: calls that launched the kernel, and calls of the plain version
kernel_launches = _build.LaunchCounter()
reference_calls = _build.LaunchCounter()
#: the same for the batched entry point
batch_launches = _build.LaunchCounter()
batch_reference_calls = _build.LaunchCounter()


def bincount(data: torch.Tensor, valid_len: int) -> torch.Tensor:
    """int32[256] ``torch.bincount`` of the bytes below ``valid_len`` (the
    plain version of K1 and of its A/B variants, uncounted)."""
    return torch.bincount(data[:valid_len].long(), minlength=256).to(torch.int32)


def histogram_reference(data: torch.Tensor, valid_len: int) -> torch.Tensor:
    """Plain PyTorch: ``torch.bincount`` of the bytes below ``valid_len``."""
    reference_calls.add()
    return bincount(data, valid_len)


def histogram_batch_reference(data: torch.Tensor, valid_lens) -> torch.Tensor:
    """Plain PyTorch: :func:`bincount` of each row."""
    batch_reference_calls.add()
    return torch.stack([bincount(row, int(v)) for row, v in zip(data, valid_lens)])


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


def _launch(data: torch.Tensor, valid_lens: list, counter) -> torch.Tensor:
    """One launch over the rows of ``data`` (uint8[rows, n], or uint8[n] for
    one chunk, which gets an int32[256] result): about one block of the
    counting kernel an SM, shared out among the rows by their lengths (at
    least one a row), and a partial histogram for each block in the
    scratch."""
    rows = len(valid_lens)
    sms = torch.cuda.get_device_properties(data.device).multi_processor_count
    shape = 256 if data.dim() == 1 else (rows, 256)  # an int: the quicker call
    hist = torch.empty(shape, dtype=torch.int32, device=data.device)
    partial = torch.empty((sms + rows) * 256, dtype=torch.int32, device=data.device)
    lib = _build.library()
    with torch.cuda.device(data.device):
        rc = lib.dcz_histogram(data.data_ptr(), data.shape[-1], _build.row_values(valid_lens),
                               rows, hist.data_ptr(), partial.data_ptr(), sms,
                               _build.stream(data))
    _build.check(rc, "histogram")
    counter.add()
    return hist


def histogram(data: torch.Tensor, valid_len: int) -> torch.Tensor:
    """int32[256] histogram of ``data[:valid_len]`` (``data``: uint8[n]).

    A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
    The kernel's scratch is a partial histogram for each of its blocks, one a
    multiprocessor: 132 KiB on an H100.
    """
    valid_len = int(valid_len)
    if check_args(data, valid_len):
        return histogram_reference(data, valid_len)
    return _launch(data, [valid_len], kernel_launches)


def histogram_batch(data: torch.Tensor, valid_lens) -> torch.Tensor:
    """int32[rows, 256]: row ``b`` is the histogram of ``data[b, :valid_lens[b]]``
    (``data``: uint8[rows, n], 1 to ``MAX_ROWS`` rows; ``valid_lens``: ints
    on the host).  A CUDA tensor launches the kernel once for all rows
    (``n`` a multiple of 16, so that every row stays 16-byte aligned); a CPU
    tensor takes the plain version.
    """
    _build.check_matrix(data, "data", torch.uint8)
    n = data.shape[1]
    valid_lens = _build.check_valid_lens(valid_lens, data.shape[0], n)
    if n >= 1 << 31:
        raise ValueError(f"histogram counts are int32: {n} bytes is too many")
    if _build.on_cpu(data):
        return histogram_batch_reference(data, valid_lens)
    if data.data_ptr() % 16 or n % 16:
        raise ValueError("data's rows must be 16-byte aligned for the kernel's vector loads")
    return _launch(data, valid_lens, batch_launches)
