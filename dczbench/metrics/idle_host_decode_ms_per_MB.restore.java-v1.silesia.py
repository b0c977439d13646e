"""The card's idle time in restore calls put down to the host decode route
(span ``host_decode``), ms a MB restored.  None where no such span was open
while the card was idle.

``dczbench.spans.split`` gives up on the whole phase where one request's
clock offset lies more than ``MAX_SKEW_US`` from the median: one stalled
request start among 48 then silences the metric.  Where it does, the spans
are placed here by that same median offset, without the check, and the idle
time is shared among them as ``split`` shares it."""

import statistics

from dczbench import spans as program_spans
from dczbench.trace import _complement


def placed_by_median(run, phase: str):
    """The :class:`dczbench.spans.Split` of ``phase`` with every span moved
    onto the trace's clock by the median request offset, however far single
    requests lie from it; None where there is nothing to read or the
    program's requests and the trace's calls differ in number."""
    trace = run.trace
    if trace is None or not trace.device:
        return None
    spans = program_spans.recorded()
    if not spans:
        return None
    calls = trace.phases[phase]
    requests = sorted((s for s in spans if s.name == program_spans.REQUEST[phase]),
                      key=lambda s: s.start_ns)
    if not requests or len(requests) != len(calls):
        return None
    ref = requests[0].start_ns
    mid = statistics.median(lo - (s.start_ns - ref) / 1e3 for (lo, _), s in zip(calls, requests))
    placed = [((s.start_ns - ref) / 1e3 + mid, (s.end_ns - ref) / 1e3 + mid, s) for s in spans]
    idle = [g for lo, hi in calls for g in _complement(trace.busy, lo, hi)]
    return program_spans.attribute(program_spans.leaves(placed), idle, calls)


def read(run):
    mb = run.phase_bytes["restore"] / 1e6
    s = program_spans.split(run, "restore") or placed_by_median(run, "restore")
    if s is None or not mb or "host_decode" not in s.idle_by_name:
        return None
    return s.idle_by_name["host_decode"] / 1e3 / mb
