"""Measurement tools of the port: the A/B harnesses of K1's variants
(:mod:`.ab_histogram`) and of K2/K3 against another checkout
(:mod:`.ab_codec`), and the timers that they and ``chip_smoke.py`` share:
:func:`cuda_ms` (CUDA events around back-to-back calls, so a call whose host
work outlasts its device work is timed by its host work) and
:func:`graph_ms` (the same calls replayed from CUDA graphs: the device time
alone).  This module imports nothing of the package, so that ``ab_codec``
can time another checkout's ops with it."""

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


def graph_ms(fn, inputs: list, reps: int) -> float:
    """Mean device time of ``fn(*inputs[i % len(inputs)])``: each input copy's
    call is captured once into a CUDA graph (all its kernels and fills), and
    the graphs are replayed in turns ``reps`` times between CUDA events, so
    the wrapper's host work is not in the time.  ``fn`` must be capturable:
    no synchronisation and no copy to the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graphs = []
    with torch.cuda.stream(side):
        for args in inputs:  # warm-up: builds and first-use work stay out of the graphs
            fn(*args)
        side.synchronize()
        for args in inputs:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=side):
                fn(*args)
            graphs.append(g)
    torch.cuda.current_stream().wait_stream(side)
    graphs[-1].replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        graphs[i % len(graphs)].replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
