"""Measurement tools of the port: the A/B harnesses of K1's variants
(:mod:`.ab_histogram`) and of K1-K4 against another checkout
(:mod:`.ab_codec`), the sharded step across ranks (:mod:`.sharded_step`),
and the timers that they and ``chip_smoke.py`` share:
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
#: :func:`graph_ms`'s calls a graph on each input copy for a kernel of a few
#: microseconds (K4, and its yardstick the launch floor)
SHORT_PER_INPUT = 40


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


def graph_ms(fn, inputs: list, reps: int, per_input: int = 1) -> float:
    """Mean device time of ``fn(*inputs[i % len(inputs)])``: the calls on
    every input copy in turn, ``per_input`` times over, are captured into one
    CUDA graph (all their kernels and fills), and the graph is replayed
    between CUDA events until at least ``reps`` calls have run, so the
    wrapper's host work is not in the time.  A kernel of a few microseconds
    takes ``per_input`` > 1, so that the host's replays keep ahead of the
    device.  ``fn`` must be capturable: no synchronisation and no copy to
    the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in inputs:  # warm-up: builds and first-use work stay out of the graph
            fn(*args)
        side.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(per_input):
                for args in inputs:
                    fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    calls = per_input * len(inputs)
    replays = -(-reps // calls)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)
