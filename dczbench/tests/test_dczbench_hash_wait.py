"""The reader of ``hash_wait_ms_per_MB.compress.silesia`` on spans laid by
hand: the ``wait`` spans whose parent is a compress call's ``job``, in ms a
MB of compress input; None where the program records none, as a version
whose workers hash their chunks themselves records none."""

import pytest

from dczbench import readers
from dczbench import spans as dspans
from datacomp_tpu_torch.models.stage_metrics import Span

NAME = "hash_wait_ms_per_MB.compress.silesia"
MAIN, WORKER, HELPER = 101, 102, 103


class Laid:
    def __init__(self):
        self.spans = []

    def add(self, name, thread, lo_us, hi_us, parent=None, request=1):
        sid = len(self.spans) + 1
        self.spans.append(Span(name, None, sid, parent, request, None, thread, 0,
                               int(lo_us * 1e3), int(hi_us * 1e3)))
        return sid


def read(laid, monkeypatch, mb=2.0):
    monkeypatch.setattr(dspans, "recorded", lambda: list(laid.spans))
    run = readers.Window(phase_bytes={"compress": int(mb * 1e6), "restore": int(mb * 1e6)})
    return readers.load(NAME)(run)


def request(laid, name, request, joins):
    """A request whose main thread waits on one job; the job's worker joins
    its hashes in ``joins`` waits of the given us."""
    req = laid.add(name, MAIN, 0, 10_000, request=request)
    laid.add("wait", MAIN, 100, 9_000, req, request=request)
    job = laid.add("job", WORKER, 100, 8_900, req, request=request)
    laid.add("sha256", HELPER, 150, 5_000, job, request=request)
    at = 6_000
    for us in joins:
        laid.add("wait", WORKER, at, at + us, job, request=request)
        at += us
    return req


def test_none_without_spans(monkeypatch):
    assert read(Laid(), monkeypatch) is None


def test_none_where_only_the_main_thread_waits(monkeypatch):
    laid = Laid()
    request(laid, "compress", 1, joins=())
    assert read(laid, monkeypatch) is None


@pytest.mark.parametrize("joins,expected", [((1_000.0,), 0.5), ((1_000.0, 3_000.0), 2.0)])
def test_job_waits_in_ms_per_mb(monkeypatch, joins, expected):
    laid = Laid()
    request(laid, "compress", 1, joins)
    request(laid, "decompress", 2, joins=(5_000.0,))  # a restore's waits are not counted
    assert read(laid, monkeypatch, mb=2.0) == pytest.approx(expected)


def test_none_without_compressed_bytes(monkeypatch):
    laid = Laid()
    request(laid, "compress", 1, joins=(1_000.0,))
    assert read(laid, monkeypatch, mb=0.0) is None
