"""What the ``torch.profiler`` trace of a window says: the device's busy
time in each phase (compress and restore calls, marked by the harness's
``record_function`` ranges), kernel and copy time by name, and the largest
device operations and idle gaps for the result's ``breakdown``.

The busy-time arithmetic (device events of the categories below, overlaps
counted once) is that of ``datacomp_tpu_torch/benchmark/suite.py``'s
``device_time_split``, copied here so that the yardstick stays put.
"""

from __future__ import annotations

import bisect
import json

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cuda_runtime", "cuda_driver")
PHASES = ("compress", "restore")
WINDOW = "window"


def kernel_name(name: str) -> str:
    """A kernel's name as the profiler gives it, without its namespaces,
    return type and parameters: ``encode_kernel<true>``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0].strip()


def kernel_base(name: str) -> str:
    """:func:`kernel_name` without template arguments or outer names:
    ``encode_kernel``."""
    return kernel_name(name).split("<", 1)[0].rsplit("::", 1)[-1]


def _union(intervals: list) -> list:
    """Sorted, merged [lo, hi) intervals."""
    out: list = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1][1] = hi
        else:
            out.append([lo, hi])
    return out


def _overlap(a: list, b: list) -> float:
    """Length of the intersection of two sorted, merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _complement(busy: list, lo: float, hi: float) -> list:
    gaps, at = [], lo
    for b_lo, b_hi in busy:
        if b_hi <= lo or b_lo >= hi:
            continue
        if b_lo > at:
            gaps.append([at, b_lo])
        at = max(at, b_hi)
    if at < hi:
        gaps.append([at, hi])
    return gaps


class Trace:
    """A chrome trace read once; times in seconds."""

    def __init__(self, path: str):
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and "dur" in e]
        self.device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
        self.host = sorted((e for e in events if e.get("cat") in HOST_CATEGORIES),
                           key=lambda e: e["ts"])
        marks = [e for e in events if e.get("cat") == "user_annotation"]
        self.phases = {p: _union([[e["ts"], e["ts"] + e["dur"]] for e in marks
                                  if e.get("name") == p]) for p in PHASES}
        window = [e for e in marks if e.get("name") == WINDOW]
        if window:
            self.lo, self.hi = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
        else:
            self.lo = min((e["ts"] for e in events), default=0.0)
            self.hi = max((e["ts"] + e["dur"] for e in events), default=0.0)
        self.busy = _union([[e["ts"], e["ts"] + e["dur"]] for e in self.device])

    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def busy_s(self, phase: str | None = None) -> float:
        """Device busy seconds in the window, or inside ``phase``'s calls."""
        span = [[self.lo, self.hi]] if phase is None else self.phases[phase]
        return _overlap(self.busy, span) / 1e6

    def phase_s(self, phase: str) -> float:
        return sum(hi - lo for lo, hi in self.phases[phase]) / 1e6

    def device_s(self, phase: str | None = None, kernels=(), category: str | None = None) -> float:
        """Seconds of device events of ``category`` (any when None) inside
        ``phase``'s calls (the whole window when None); with ``kernels``,
        only the kernels of those base names (:func:`kernel_base`)."""
        span = [[self.lo, self.hi]] if phase is None else self.phases[phase]
        picked = [[e["ts"], e["ts"] + e["dur"]] for e in self.device
                  if (category is None or e.get("cat") == category)
                  and (not kernels or (e.get("cat") == "kernel"
                                       and kernel_base(e.get("name", "")) in kernels))]
        return sum(_overlap([iv], span) for iv in picked) / 1e6

    def top_device_ops(self, k: int = 10) -> list:
        by: dict = {}
        for e in self.device:
            if self.lo <= e["ts"] < self.hi:
                name = kernel_name(e["name"]) if e.get("cat") == "kernel" else e["name"]
                by[name] = by.get(name, 0.0) + e["dur"] / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The device's idle time in the window by what the host was doing:
        inside a CUDA runtime call (by its name), else in a compress or
        restore call outside any (Python, NumPy, SHA-256, file I/O), else
        between requests (the judge's read-back of the outputs, and their
        removal)."""
        gaps = _complement(self.busy, self.lo, self.hi)
        starts = [e["ts"] for e in self.host]
        by: dict = {}
        for g_lo, g_hi in gaps:
            left = [[g_lo, g_hi]]
            i = max(0, bisect.bisect_left(starts, g_lo) - 64)
            while i < len(self.host) and self.host[i]["ts"] < g_hi:
                e = self.host[i]
                i += 1
                got = _overlap(left, [[e["ts"], e["ts"] + e["dur"]]])
                if got > 0:
                    by[e["name"]] = by.get(e["name"], 0.0) + got / 1e6
                    left = _subtract(left, e["ts"], e["ts"] + e["dur"])
            for phase in PHASES:
                got = _overlap(left, self.phases[phase])
                if got > 0:
                    label = f"{phase}: no CUDA call (Python, NumPy, SHA-256, file I/O)"
                    by[label] = by.get(label, 0.0) + got / 1e6
                    for lo, hi in self.phases[phase]:
                        left = _subtract(left, lo, hi)
            rest = sum(hi - lo for lo, hi in left)
            if rest > 0:
                label = "between requests: outputs read back for the judge, removed"
                by[label] = by.get(label, 0.0) + rest / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:k]


def _subtract(intervals: list, lo: float, hi: float) -> list:
    out = []
    for a, b in intervals:
        if hi <= a or lo >= b:
            out.append([a, b])
            continue
        if a < lo:
            out.append([a, lo])
        if hi < b:
            out.append([hi, b])
    return out
