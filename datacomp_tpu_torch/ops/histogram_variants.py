"""A/B variants of K1, the 256-bin byte histogram, as CUDA kernels.

* K1s :func:`histogram_stacked`, counterpart of the kernel that
  ``tools/ab_hist_pallas_r3.py::make_stacked`` builds: private narrow
  counters a thread, folded by its warp every ``groups`` x 16 bytes a thread.
  r3's ``stacked``, ``stacked8`` and ``stacked-i16`` are
  ``(groups, counter_bits)`` = (16, 8), (8, 8) and (16, 16): :data:`STACKED`.
* K1p :func:`histogram_partial`, counterpart of
  ``tools/ab_hist_pallas_r4.py::hist_partial`` (``kernel_2d``): ``k`` stripes
  of blocks, each over its own 1/k of the chunk, counting with K1's
  lane-banked core.

On the H100 K1p is bound, as K1 is, by one read of the chunk and the SMs'
rate of shared atomics, one a byte; K1s by its instructions a byte (the
field arithmetic and a private shared load-add-store) and the fold's reads.
Both write a
row a block into a scratch from ``torch.empty`` and a programmatically
dependent launch sums the rows: nothing is zero-filled, no global atomics,
no ``torch`` reduction.  The kernels are ``csrc/histogram_variants.cu`` on
``csrc/histogram_core.cuh``.

Both return what :func:`~.histogram.histogram` returns, and
:func:`~.histogram.bincount` is their plain version.  They are timed against
K1 by ``datacomp_tpu_torch.tools.ab_histogram`` and ``tools.ab_codec``; the
codec never calls them.
"""

from __future__ import annotations

import ctypes

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
    lib = _build.library()
    with torch.cuda.device(data.device):
        # the scratch: a row for each block resident at once on the device
        rows = ctypes.c_int(0)
        _build.check(lib.dcz_histogram_stacked_rows(counter_bits, ctypes.byref(rows)),
                     "histogram_stacked")
        hist = torch.empty(256, dtype=torch.int32, device=data.device)
        partial = torch.empty(rows.value * 256, dtype=torch.int32, device=data.device)
        rc = lib.dcz_histogram_stacked(data.data_ptr(), valid_len, groups, counter_bits,
                                       hist.data_ptr(), partial.data_ptr(), rows.value,
                                       _build.stream(data))
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
    sms = torch.cuda.get_device_properties(data.device).multi_processor_count
    per_stripe = max(1, sms // k)
    hist = torch.empty(256, dtype=torch.int32, device=data.device)
    partial = torch.empty(k * per_stripe * 256, dtype=torch.int32, device=data.device)
    lib = _build.library()
    with torch.cuda.device(data.device):
        rc = lib.dcz_histogram_partial(data.data_ptr(), valid_len, k, hist.data_ptr(),
                                       partial.data_ptr(), per_stripe, _build.stream(data))
    _build.check(rc, "histogram_partial")
    partial_launches.add()
    return hist
