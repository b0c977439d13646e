"""Per-layer metrics: one reader a metric, ``dczbench/metrics/<name>.py``,
found by the metric's name in BENCHMARK.json.  Each file defines
``read(run)`` and returns a number, or None when the run has nothing to
read (the metric is then left out of the result line).  The helpers below
take what a reader needs from a :class:`Window`."""

from __future__ import annotations

import importlib.util
import os
from dataclasses import dataclass, field

from . import work

METRICS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "metrics")


@dataclass
class Window:
    """What a run's window served and what its trace says.

    ``stage_ms[phase][STAGE]``: the program's StageMetrics summed over the
    window's calls of ``phase`` ("compress", "restore"); ``phase_bytes``:
    input bytes compressed and bytes restored; ``phase_s``: the seconds of
    those calls, each from its start to its return; ``chunks``: the reference's
    expected chunks of every request served; ``trace``: a
    :class:`dczbench.trace.Trace`, or None in an untraced run."""

    stage_ms: dict = field(default_factory=lambda: {"compress": {}, "restore": {}})
    phase_bytes: dict = field(default_factory=lambda: {"compress": 0, "restore": 0})
    phase_s: dict = field(default_factory=lambda: {"compress": 0.0, "restore": 0.0})
    chunks: list = field(default_factory=list)
    trace: object = None


def load(name: str):
    """The reader of metric ``name``."""
    path = os.path.join(METRICS_DIR, name + ".py")
    spec = importlib.util.spec_from_file_location("dczbench_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def stage_ms_per_mb(run: Window, phase: str, stages: tuple):
    mb = run.phase_bytes[phase] / 1e6
    if not mb or not any(s in run.stage_ms[phase] for s in stages):
        return None
    return sum(run.stage_ms[phase].get(s, 0.0) for s in stages) / mb


def rate_mb_per_s(run: Window, phase: str):
    """``phase``'s bytes (1e6 a MB) over the seconds of its calls."""
    s = run.phase_s[phase]
    return run.phase_bytes[phase] / 1e6 / s if s > 0 and run.phase_bytes[phase] else None


def copy_ms_per_mb(run: Window, phase: str):
    mb = run.phase_bytes[phase] / 1e6
    if run.trace is None or not run.trace.device or not mb:
        return None
    return run.trace.device_s(phase, category="gpu_memcpy") * 1e3 / mb


def roofline_pct(run: Window, phase: str, kernels: tuple, nbytes: int):
    """Share (%) of the HBM roofline: ``nbytes`` at 3.35 TB/s over the traced
    time of the kernels of those base names inside ``phase``'s calls."""
    if run.trace is None or not nbytes:
        return None
    t = run.trace.device_s(phase, kernels=kernels, category="kernel")
    if t <= 0:
        return None
    return 100.0 * nbytes / work.HBM_BYTES_PER_S / t


def idle_pct(run: Window, phase: str):
    """Share (%) of ``phase``'s call time in which the device ran nothing."""
    if run.trace is None or not run.trace.device:
        return None
    span = run.trace.phase_s(phase)
    if span <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s(phase) / span)
