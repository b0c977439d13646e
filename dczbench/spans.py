"""The card's idle time inside the calls, put down to the program's spans.

While the run's profiler records, the program keeps a span for each request,
pipeline job and stage in memory (``datacomp_tpu_torch.models.stage_metrics``:
``spans()``), stamped with ``time.time_ns()``.  The chrome trace's clock is
unix time up to a constant, so the spans are moved onto it by the median of
each request's offset: the start of the k-th ``compress`` (``restore``) range
of the trace less the start of the k-th ``compress`` (``decompress``) span.
None comes back where the counts differ or an offset lies more than
:data:`MAX_SKEW_US` from the median, and where the program keeps no spans.

Each idle instant of the card inside the phase's calls (the complement of the
trace's busy time) is shared equally among the open leaf spans of all
threads, a thread's leaf being its innermost open span.  ``wait`` spans are
left out.  A leaf of the program's glue (:data:`GLUE`: the request and job
spans), or no open leaf at all, makes the share unspanned.
"""

from __future__ import annotations

import statistics
from collections import Counter, defaultdict
from dataclasses import dataclass, field

from .trace import _complement

#: a phase's request span in the program
REQUEST = {"compress": "compress", "restore": "decompress"}
#: spans that name no layer: the program's glue
GLUE = frozenset({"compress", "decompress", "resume", "job"})
#: the main thread blocked on a job: left out of every share
WAIT = "wait"
#: most a request's clock offset may lie from the median (us)
MAX_SKEW_US = 200.0

#: the spans of each group, by phase
GROUPS = {
    "compress": {
        "prepass": ("sha256", "histogram", "codebook"),
        "transfer": ("encode", "upload", "launch", "fetch", "unpack"),
        "io": ("open", "read", "write", "sidecar", "footer"),
    },
    "restore": {
        "verify": ("verify",),
        "transfer": ("decode", "decode_tables", "upload", "launch", "fetch", "unpack"),
        "io": ("open", "pread", "pwrite"),
    },
}


@dataclass
class Split:
    """A phase's idle time by leaf span name (us on the trace clock), what of
    it was unspanned, and the leaf spans' time over the calls."""

    idle_by_name: dict = field(default_factory=dict)
    unspanned_us: float = 0.0
    idle_us: float = 0.0
    leaf_us: float = 0.0
    phase_us: float = 0.0


def recorded():
    """The program's spans of this process, or None where the program keeps
    none (a version without spans)."""
    try:
        from datacomp_tpu_torch.models.stage_metrics import spans
    except ImportError:
        return None
    return spans()


def align(trace, phase: str, spans: list):
    """``spans`` as (lo, hi, span) in the trace's us, and each request's
    offset less their median; None where the requests do not line up."""
    marks = trace.phases[phase]
    requests = sorted((s for s in spans if s.name == REQUEST[phase]), key=lambda s: s.start_ns)
    if not requests or len(requests) != len(marks):
        return None
    ref = requests[0].start_ns  # integer ns kept apart: us of unix time lose digits in a float
    offsets = [lo - (s.start_ns - ref) / 1e3 for (lo, _), s in zip(marks, requests)]
    mid = statistics.median(offsets)
    if any(abs(o - mid) > MAX_SKEW_US for o in offsets):
        return None
    return [((s.start_ns - ref) / 1e3 + mid, (s.end_ns - ref) / 1e3 + mid, s)
            for s in spans], [o - mid for o in offsets]


def leaves(placed: list) -> list:
    """(lo, hi, name) of each thread's innermost open span, ``wait`` left
    out; a span that overruns its enclosing one on the thread is cut to it."""
    by_thread = defaultdict(list)
    for lo, hi, s in placed:
        by_thread[s.thread].append((lo, hi, s.name))
    out = []

    def emit(lo, hi, name):
        if hi > lo and name != WAIT:
            out.append((lo, hi, name))

    for items in by_thread.values():
        stack: list = []
        at = None
        for lo, hi, name in sorted(items, key=lambda t: (t[0], -t[1])):
            while stack and stack[-1][0] <= lo:
                end, top = stack.pop()
                emit(at, end, top)
                at = end
            if stack:
                emit(at, lo, stack[-1][1])
                hi = min(hi, stack[-1][0])
            at = lo
            stack.append((hi, name))
        while stack:
            end, top = stack.pop()
            emit(at, end, top)
            at = end
    return out


def attribute(segments: list, idle: list, calls: list) -> Split:
    """Share each idle instant (``idle``: sorted, merged [lo, hi) inside
    ``calls``) equally among the leaves open then (``segments``)."""
    deltas = defaultdict(list)
    for lo, hi, name in segments:
        deltas[lo].append((name, 1))
        deltas[hi].append((name, -1))
    for kind, intervals in (("idle", idle), ("calls", calls)):
        for lo, hi in intervals:
            deltas[lo].append((kind, 1))
            deltas[hi].append((kind, -1))
    split = Split()
    by_name: dict = defaultdict(float)
    open_names: Counter = Counter()
    n_open = in_idle = in_calls = 0
    times = sorted(deltas)
    for a, b in zip(times, times[1:] + times[-1:]):
        for name, d in deltas[a]:
            if name == "idle":
                in_idle += d
            elif name == "calls":
                in_calls += d
            else:
                open_names[name] += d
                n_open += d
        dt = b - a
        if dt <= 0 or not in_calls:
            continue
        split.phase_us += dt
        split.leaf_us += dt * n_open
        if not in_idle:
            continue
        split.idle_us += dt
        layered = 0.0
        for name, k in open_names.items():
            if k and name not in GLUE:
                by_name[name] += dt * k / n_open
                layered += dt * k / n_open
        split.unspanned_us += dt - layered
    split.idle_by_name = dict(by_name)
    return split


def split(run, phase: str):
    """The :class:`Split` of ``phase`` ("compress", "restore") in ``run``
    (a ``dczbench.readers.Window``), or None where there is nothing to
    read."""
    trace = run.trace
    if trace is None or not trace.device:
        return None
    spans = recorded()
    if not spans:
        return None
    got = align(trace, phase, spans)
    if got is None:
        return None
    calls = trace.phases[phase]
    idle = [g for lo, hi in calls for g in _complement(trace.busy, lo, hi)]
    return attribute(leaves(got[0]), idle, calls)


def idle_ms_per_mb(run, phase: str, group: str):
    """Idle time of the card put down to the spans of ``group``, ms a MB of
    the phase's bytes."""
    mb = run.phase_bytes[phase] / 1e6
    s = split(run, phase)
    if s is None or not mb:
        return None
    names = GROUPS[phase][group]
    return sum(s.idle_by_name.get(n, 0.0) for n in names) / 1e3 / mb


def unspanned_pct(run, phase: str):
    """Share (%) of the card's idle time in the phase's calls with no layer
    span open."""
    s = split(run, phase)
    if s is None or s.idle_us <= 0:
        return None
    return 100.0 * s.unspanned_us / s.idle_us


def host_overlap(run, phase: str):
    """Leaf-span time of all threads (``wait`` left out) over the phase's
    calls' time: how many threads worked at once, on average."""
    s = split(run, phase)
    if s is None or s.phase_us <= 0:
        return None
    return s.leaf_us / s.phase_us
