"""A/B variants of K1, the 256-bin byte histogram, as CUDA kernels.

* K1s :func:`histogram_stacked`, counterpart of the kernel that
  ``tools/ab_hist_pallas_r3.py::make_stacked`` builds: private narrow
  counters a thread, folded into the block's bins every ``groups`` x 16 bytes
  a thread.  r3's ``stacked``, ``stacked8`` and ``stacked-i16`` are
  ``(groups, counter_bits)`` = (16, 8), (8, 8) and (16, 16): :data:`STACKED`.
* K1p :func:`histogram_partial`, counterpart of
  ``tools/ab_hist_pallas_r4.py::hist_partial`` (``kernel_2d``): ``k`` stripes
  of blocks, each with its own row of partial sums, added afterwards.

Both return what :func:`~.histogram.histogram` returns, and
:func:`~.histogram.histogram_reference` (``torch.bincount``) is their plain
version.  They are timed against K1 by ``datacomp_tpu_torch.tools.ab_histogram``;
the codec never calls them.  The kernels are ``csrc/histogram_variants.cu``.
"""

from __future__ import annotations

import torch

from . import _build
from .histogram import bincount, check_args

#: r3 variant -> (groups, counter_bits)
STACKED = {"stacked": (16, 8), "stacked8": (8, 8), "stacked-i16": (16, 16)}
#: r4's stripe counts, and 1: K1's own shape
PARTIAL_K = (1, 2, 4, 8)

stacked_launches = _build.LaunchCounter()
stacked_reference_calls = _build.LaunchCounter()
partial_launches = _build.LaunchCounter()
partial_reference_calls = _build.LaunchCounter()


def histogram_stacked(data: torch.Tensor, valid_len: int, groups: int = 16,
                      counter_bits: int = 8) -> torch.Tensor:
    """int32[256] histogram of ``data[:valid_len]`` through per-thread
    ``counter_bits``-bit counters folded every ``groups`` x 16 bytes a thread
    (``groups`` in 1..16, ``counter_bits`` 8 or 16).

    A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
    """
    valid_len, groups, counter_bits = int(valid_len), int(groups), int(counter_bits)
    if not 1 <= groups <= 16 or counter_bits not in (8, 16):
        raise ValueError(f"groups {groups} must be in 1..16 and counter_bits "
                         f"{counter_bits} 8 or 16")
    if check_args(data, valid_len):
        stacked_reference_calls.add()
        return bincount(data, valid_len)
    hist = torch.zeros(256, dtype=torch.int32, device=data.device)
    lib = _build.library()
    with torch.cuda.device(data.device):
        rc = lib.dcz_histogram_stacked(data.data_ptr(), valid_len, groups, counter_bits,
                                       hist.data_ptr(), _build.stream(data))
    _build.check(rc, "histogram_stacked")
    stacked_launches.add()
    return hist


def histogram_partial(data: torch.Tensor, valid_len: int, k: int = 4) -> torch.Tensor:
    """int32[256] histogram of ``data[:valid_len]`` summed from ``k`` stripes'
    partial histograms (``k`` in 1..64).

    A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
    """
    valid_len, k = int(valid_len), int(k)
    if not 1 <= k <= 64:
        raise ValueError(f"k {k} must be in 1..64")
    if check_args(data, valid_len):
        partial_reference_calls.add()
        return bincount(data, valid_len)
    partial = torch.zeros((k, 256), dtype=torch.int32, device=data.device)
    lib = _build.library()
    with torch.cuda.device(data.device):
        rc = lib.dcz_histogram_partial(data.data_ptr(), valid_len, k, partial.data_ptr(),
                                       _build.stream(data))
        _build.check(rc, "histogram_partial")
        hist = partial.sum(0, dtype=torch.int32)  # the second pass: k rows into one
    partial_launches.add()
    return hist
