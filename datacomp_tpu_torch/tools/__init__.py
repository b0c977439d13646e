"""Measurement tools of the port: the A/B harness of K1's variants
(:mod:`.ab_histogram`) and the CUDA-event timer that it and ``chip_smoke.py``
share."""

from __future__ import annotations

import torch

#: copies of a timed op's inputs, cycled so that each call reads its input
#: cold: 6 x 16 MiB is more than the H100's 50 MB L2
COLD_COPIES = 6


def copies(*tensors: torch.Tensor) -> list:
    """``COLD_COPIES`` argument tuples, each with its own copy of ``tensors``."""
    return [tuple(t.clone() for t in tensors) for _ in range(COLD_COPIES)]


def cuda_ms(fn, inputs: list, reps: int) -> float:
    """Mean device time of ``fn(*inputs[i % len(inputs)])`` over ``reps``
    calls, after one warm-up, from CUDA events.  ``inputs`` holds copies of
    the same arguments (:func:`copies`), together larger than L2, so that
    each call finds its input cold."""
    fn(*inputs[-1])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
