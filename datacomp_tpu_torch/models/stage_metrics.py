"""Per-stage pipeline timing accumulator, and the spans behind it.

Parity with the reference's hand-rolled profiler
(``model/StageMetrics.java:11-128``): the same 8 stages, per-stage
time/count/bytes accumulation, and a formatted text breakdown.  The port's
copy of ``datacomp_tpu/models/stage_metrics.py``.

Spans: while a ``torch.profiler`` records anywhere in the process, every
:meth:`StageMetrics.timed` block and every :func:`span` block is also kept
as a :class:`Span` (name, stage, ids, thread, bytes, start and end in
``time.time_ns()`` nanoseconds), in one list for the process that
:func:`spans` returns.  A span's parent is the innermost span open on its
thread, or the context a pool job was handed (:func:`current_span` on the
submitting thread); a child inherits its parent's request and job ids.  On
a thread that the profiler itself records, a span also opens
``record_function("dcz.<name>")``, so it shows in the chrome trace.  With
no profiler recording, a span costs one read of the profiler's state.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler


class Stage(Enum):
    FREQUENCY_ANALYSIS = "Frequency Analysis"
    HUFFMAN_TREE_BUILD = "Huffman Tree Build"
    ENCODING = "Encoding"
    CHECKSUM_COMPUTE = "Checksum Compute"
    FILE_IO = "File I/O"
    HEADER_WRITE = "Header Write"
    DECODING = "Decoding"
    CHECKSUM_VERIFY = "Checksum Verify"


#: a stage's span name where the caller gives none
STAGE_SPANS = {
    Stage.FREQUENCY_ANALYSIS: "histogram",
    Stage.HUFFMAN_TREE_BUILD: "codebook",
    Stage.ENCODING: "encode",
    Stage.CHECKSUM_COMPUTE: "sha256",
    Stage.FILE_IO: "io",
    Stage.HEADER_WRITE: "footer",
    Stage.DECODING: "decode",
    Stage.CHECKSUM_VERIFY: "verify",
}

#: spans kept for the process; past it, spans are counted as dropped
MAX_SPANS = 100_000


class Span(NamedTuple):
    """One finished span.  ``stage`` is a :class:`Stage` name, or None for a
    span that no stage sums; ``thread`` is the OS thread id."""

    name: str
    stage: Optional[str]
    span_id: int
    parent: Optional[int]
    request: Optional[int]
    job: Optional[int]
    thread: int
    nbytes: int
    start_ns: int
    end_ns: int
    chunks: Tuple[int, ...] = ()


_spans: list = []
_dropped = 0
_spans_lock = threading.Lock()
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_job_ids = itertools.count(1)
_local = threading.local()
_OFF = contextlib.nullcontext()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        # read once a thread: the OS thread id can cost a system call
        _local.thread = threading.get_native_id()
    return stack


class _Recording:
    """A span being recorded; with ``metrics``, also a stage's timing."""

    __slots__ = ("name", "stage", "nbytes", "metrics", "span_id", "parent", "request", "job",
                 "chunks", "start_ns", "_rf")

    def __init__(self, name, stage, nbytes, metrics, parent, request, job, chunks):
        self.name = name
        self.stage = stage
        self.nbytes = nbytes
        self.metrics = metrics
        self.chunks = tuple(chunks)
        stack = _stack()
        if parent is None and stack:
            parent = stack[-1]
        self.span_id = next(_span_ids)
        self.parent = parent.span_id if parent is not None else None
        self.request = next(_request_ids) if request else (
            parent.request if parent is not None else None)
        self.job = next(_job_ids) if job else (parent.job if parent is not None else None)
        self._rf = None

    def __enter__(self):
        _stack().append(self)
        # the clock before record_function, whose entry takes tens of us: a
        # request's start then lies a steady step after the harness's range,
        # and the profiler's cost falls inside the span that caused it
        self.start_ns = time.time_ns()
        if torch._C._autograd._profiler_enabled():  # this thread is one the profiler records
            self._rf = _profiler.record_function("dcz." + self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        end_ns = time.time_ns()
        if self.metrics is not None:
            self.metrics.record_stage(self.stage, end_ns - self.start_ns, self.nbytes)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _keep(Span(self.name, self.stage.name if self.stage is not None else None,
                   self.span_id, self.parent, self.request, self.job, _local.thread,
                   int(self.nbytes), self.start_ns, end_ns, self.chunks))
        return False


def _keep(s: Span) -> None:
    global _dropped
    with _spans_lock:
        if len(_spans) < MAX_SPANS:
            _spans.append(s)
        else:
            _dropped += 1


def span(name: str, nbytes: int = 0, *, parent=None, request: bool = False,
         job: bool = False, chunks=()):
    """A span of no stage, recorded while a profiler records, else nothing.

    ``request`` gives it a new request id, ``job`` a new job id; ``parent``
    (from :func:`current_span` on the thread that submitted a pool job)
    stands in for the innermost span open on this thread.  Entered, it gives
    the recording (whose ``nbytes`` may be set inside), or None."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, None, nbytes, None, parent, request, job, chunks)


def current_span():
    """The innermost span recording on this thread, or None: what a pool job
    is handed as its ``parent``."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def spans() -> list:
    """The spans kept so far, in the order they ended."""
    with _spans_lock:
        return list(_spans)


def dropped_spans() -> int:
    """Spans not kept because :data:`MAX_SPANS` were."""
    return _dropped


def clear_spans() -> None:
    global _dropped
    with _spans_lock:
        _spans.clear()
        _dropped = 0


@dataclass
class _StageAccum:
    total_ns: int = 0
    count: int = 0
    bytes_processed: int = 0


class _Timed:
    __slots__ = ("metrics", "stage", "nbytes", "start_ns")

    def __init__(self, metrics, stage, nbytes):
        self.metrics = metrics
        self.stage = stage
        self.nbytes = nbytes

    def __enter__(self):
        self.start_ns = time.time_ns()
        return None

    def __exit__(self, *exc):
        self.metrics.record_stage(self.stage, time.time_ns() - self.start_ns, self.nbytes)
        return False


@dataclass
class StageMetrics:
    _stages: Dict[Stage, _StageAccum] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record_stage(self, stage: Stage, duration_ns: int, bytes_processed: int = 0) -> None:
        with self._lock:
            acc = self._stages.setdefault(stage, _StageAccum())
            acc.total_ns += int(duration_ns)
            acc.count += 1
            acc.bytes_processed += int(bytes_processed)

    def timed(self, stage: Stage, nbytes: int = 0, span: Optional[str] = None, parent=None):
        """Time a block into ``stage``; while a profiler records, also a span
        named ``span`` (by default the stage's, :data:`STAGE_SPANS`) whose
        duration is the one summed.  ``parent`` is as :func:`span` takes it."""
        if not _profiler._is_profiler_enabled:
            return _Timed(self, stage, nbytes)
        return _Recording(span or STAGE_SPANS[stage], stage, nbytes, self, parent, False, False,
                          ())

    def as_dict(self) -> dict:
        with self._lock:
            return {
                s.name: {
                    "ms": acc.total_ns / 1e6,
                    "count": acc.count,
                    "bytes": acc.bytes_processed,
                    "mbps": self._mbps(acc),
                }
                for s, acc in self._stages.items()
            }

    @staticmethod
    def _mbps(acc: _StageAccum) -> float:
        if acc.total_ns == 0:
            return 0.0
        return (acc.bytes_processed / 1e6) / (acc.total_ns / 1e9)

    def summary(self) -> str:
        """Formatted per-stage breakdown (parity: ``StageMetrics.getSummary``)."""
        with self._lock:
            if not self._stages:
                return "No stage metrics recorded"
            total = sum(a.total_ns for a in self._stages.values())
            lines = ["Stage Performance Breakdown:", "=" * 64]
            for stage in Stage:
                acc = self._stages.get(stage)
                if acc is None:
                    continue
                pct = 100.0 * acc.total_ns / total if total else 0.0
                lines.append(
                    f"  {stage.value:<22} {acc.total_ns / 1e6:>10.2f} ms "
                    f"({pct:5.1f}%)  x{acc.count:<5} {self._mbps(acc):>9.1f} MB/s"
                )
            lines.append("=" * 64)
            lines.append(f"  {'Total':<22} {total / 1e6:>10.2f} ms")
            return "\n".join(lines)
