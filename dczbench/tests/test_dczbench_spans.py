"""The span readers on a window laid by hand: a chrome trace with the
harness's ranges and the card's busy time, and the program's spans on their
own clock (``time.time_ns()``, a constant away from the trace's).  Each
idle instant goes to the open leaf spans, shared equally between threads,
``wait`` left out, the glue to the unspanned share; None where the requests
do not line up."""

import json

import pytest

from dczbench import readers
from dczbench import spans as dspans
from dczbench.trace import Trace
from datacomp_tpu_torch.models.stage_metrics import Span

#: the spans' clock less the trace's, in ns (unix time against the trace's base)
SHIFT_NS = 1_790_000_000_000_000_000
MAIN, WORKER, OTHER = 101, 102, 103


class Laid:
    """Spans laid by hand, times in us on the trace's clock."""

    def __init__(self):
        self.spans = []

    def add(self, name, thread, lo, hi, parent=None, stage=None, skew_us=0.0):
        sid = len(self.spans) + 1
        self.spans.append(Span(name, stage, sid, parent, 1, None, thread, 0,
                               SHIFT_NS + int((lo + skew_us) * 1e3),
                               SHIFT_NS + int((hi + skew_us) * 1e3)))
        return sid


def window(tmp_path, laid, monkeypatch, phases, busy, mb=0.001):
    """A Window whose trace has ``phases`` ({phase: [(lo, hi)]}) and device
    events at ``busy``, reading ``laid``'s spans."""
    events = [{"ph": "X", "cat": "user_annotation", "name": "window", "ts": 0.0, "dur": 10_000.0}]
    for phase, calls in phases.items():
        events += [{"ph": "X", "cat": "user_annotation", "name": phase, "ts": lo, "dur": hi - lo}
                   for lo, hi in calls]
    events += [{"ph": "X", "cat": "kernel", "name": "void encode_kernel<true>(int)", "ts": lo,
                "dur": hi - lo} for lo, hi in busy]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    monkeypatch.setattr(dspans, "recorded", lambda: list(laid.spans))
    return readers.Window(phase_bytes={"compress": int(mb * 1e6), "restore": int(mb * 1e6)},
                          trace=Trace(str(path)))


def metrics(run, phase):
    names = [m for m in _NAMES if m.endswith(f".{phase}.silesia")]
    return {m.split(".")[0]: readers.load(m)(run) for m in names}


_NAMES = [
    "idle_prepass_ms_per_MB.compress.silesia", "idle_transfer_ms_per_MB.compress.silesia",
    "idle_io_ms_per_MB.compress.silesia", "idle_unspanned.compress.silesia",
    "host_overlap.compress.silesia", "idle_verify_ms_per_MB.restore.silesia",
    "idle_transfer_ms_per_MB.restore.silesia", "idle_io_ms_per_MB.restore.silesia",
    "idle_unspanned.restore.silesia", "host_overlap.restore.silesia",
]


def one_compress(laid, at=0.0, skew_us=0.0):
    """A compress request over [at, at+100) us: the main thread opens, waits
    on the job, writes and closes; the worker reads, hashes, counts, builds
    the codebook and encodes."""
    k = dict(skew_us=skew_us)
    req = laid.add("compress", MAIN, at + 0, at + 100, **k)
    laid.add("open", MAIN, at + 0, at + 5, req, **k)
    laid.add("wait", MAIN, at + 5, at + 60, req, **k)
    laid.add("write", MAIN, at + 60, at + 70, req, "FILE_IO", **k)
    laid.add("sidecar", MAIN, at + 70, at + 75, req, **k)
    laid.add("footer", MAIN, at + 80, at + 90, req, **k)
    job = laid.add("job", WORKER, at + 6, at + 58, req, **k)
    laid.add("read", WORKER, at + 6, at + 10, job, "FILE_IO", **k)
    laid.add("sha256", WORKER, at + 20, at + 30, job, "CHECKSUM_COMPUTE", **k)
    laid.add("histogram", WORKER, at + 30, at + 35, job, "FREQUENCY_ANALYSIS", **k)
    laid.add("codebook", WORKER, at + 35, at + 40, job, "HUFFMAN_TREE_BUILD", **k)
    enc = laid.add("encode", WORKER, at + 40, at + 55, job, "ENCODING", **k)
    laid.add("upload", WORKER, at + 40, at + 45, enc, **k)
    laid.add("launch", WORKER, at + 45, at + 50, enc, **k)
    laid.add("fetch", WORKER, at + 50, at + 52, enc, **k)
    laid.add("unpack", WORKER, at + 52, at + 55, enc, **k)


def test_exact_attribution(tmp_path, monkeypatch):
    laid = Laid()
    one_compress(laid)
    run = window(tmp_path, laid, monkeypatch, {"compress": [(0, 100)]}, busy=[(10, 20)])
    got = metrics(run, "compress")
    # idle [0, 10) and [20, 100): 90 us, on 0.001 MB
    assert got["idle_prepass_ms_per_MB"] == pytest.approx(20.0)  # sha 10, histogram 5, codebook 5
    assert got["idle_transfer_ms_per_MB"] == pytest.approx(15.0)  # 5 + 5 + 2 + 3; encode's own 0
    # open 5, read 4, write 10, sidecar 5, footer 10
    assert got["idle_io_ms_per_MB"] == pytest.approx(34.0)
    # wait alone [5, 6) and [58, 60), the job's glue [55, 58), the request's [75, 80) and [90, 100)
    assert got["idle_unspanned"] == pytest.approx(100.0 * 21 / 90)
    # main 45 us of leaves outside `wait`, the worker's job 52 us, over 100 us
    assert got["host_overlap"] == pytest.approx(0.97)
    split = dspans.split(run, "compress")
    assert sum(split.idle_by_name.values()) + split.unspanned_us == pytest.approx(split.idle_us)


def test_restore_groups(tmp_path, monkeypatch):
    laid = Laid()
    req = laid.add("decompress", MAIN, 0, 50)
    laid.add("open", MAIN, 0, 4, req, "FILE_IO")
    laid.add("wait", MAIN, 4, 50, req)
    job = laid.add("job", WORKER, 4, 48, req)
    laid.add("pread", WORKER, 4, 6, job, "FILE_IO")
    laid.add("decode_tables", WORKER, 6, 8, job, "HUFFMAN_TREE_BUILD")
    dec = laid.add("decode", WORKER, 8, 30, job, "DECODING")
    laid.add("upload", WORKER, 8, 12, dec)
    laid.add("launch", WORKER, 12, 14, dec)
    laid.add("fetch", WORKER, 20, 26, dec)
    laid.add("verify", WORKER, 30, 40, job, "CHECKSUM_VERIFY")
    laid.add("pwrite", WORKER, 40, 46, job, "FILE_IO")
    run = window(tmp_path, laid, monkeypatch, {"restore": [(0, 50)]}, busy=[(14, 20)])
    got = metrics(run, "restore")
    assert got["idle_verify_ms_per_MB"] == pytest.approx(10.0)
    # decode_tables 2, upload 4, launch 2, fetch 6, decode's own [26, 30) 4
    assert got["idle_transfer_ms_per_MB"] == pytest.approx(18.0)
    assert got["idle_io_ms_per_MB"] == pytest.approx(12.0)  # open 4, pread 2, pwrite 6
    # the job's [46, 48), none open [48, 50)
    assert got["idle_unspanned"] == pytest.approx(100.0 * 4 / 44)
    assert got["host_overlap"] == pytest.approx((4 + 44) / 50)


def test_equal_split_between_threads(tmp_path, monkeypatch):
    laid = Laid()
    req = laid.add("compress", MAIN, 0, 12)
    laid.add("write", MAIN, 0, 9, req, "FILE_IO")
    laid.add("sha256", WORKER, 0, 9, req, "CHECKSUM_COMPUTE")
    laid.add("job", OTHER, 0, 9, req)
    run = window(tmp_path, laid, monkeypatch, {"compress": [(0, 12)]}, busy=[(100, 101)])
    got = metrics(run, "compress")
    assert got["idle_io_ms_per_MB"] == pytest.approx(3.0)
    assert got["idle_prepass_ms_per_MB"] == pytest.approx(3.0)
    # the job's third of [0, 9), and the request alone in [9, 12)
    assert got["idle_unspanned"] == pytest.approx(100.0 * 6 / 12)
    assert got["host_overlap"] == pytest.approx((9 * 3 + 3) / 12)


def test_wait_is_left_out(tmp_path, monkeypatch):
    laid = Laid()
    req = laid.add("compress", MAIN, 0, 10)
    laid.add("wait", MAIN, 0, 10, req)
    laid.add("sha256", WORKER, 0, 10, req, "CHECKSUM_COMPUTE")
    run = window(tmp_path, laid, monkeypatch, {"compress": [(0, 10)]}, busy=[(100, 101)])
    got = metrics(run, "compress")
    assert got["idle_prepass_ms_per_MB"] == pytest.approx(10.0)
    assert got["idle_unspanned"] == pytest.approx(0.0)
    assert got["host_overlap"] == pytest.approx(1.0)


@pytest.mark.parametrize("skew_us, lined_up", [(150.0, True), (-150.0, True), (250.0, False),
                                              (-250.0, False)])
def test_offsets_must_agree(tmp_path, monkeypatch, skew_us, lined_up):
    """Three requests; the middle one's clock offset is ``skew_us`` off the
    others': within 0.2 ms of the median the spans are read, past it none."""
    laid = Laid()
    for k, at in enumerate((0.0, 1000.0, 2000.0)):
        one_compress(laid, at, skew_us if k == 1 else 0.0)
    run = window(tmp_path, laid, monkeypatch,
                 {"compress": [(0, 100), (1000, 1100), (2000, 2100)]}, busy=[(10, 20)])
    got = metrics(run, "compress")
    if lined_up:
        assert all(v is not None for v in got.values())
        _, offsets = dspans.align(run.trace, "compress", laid.spans)
        assert offsets == pytest.approx([0.0, -skew_us, 0.0])
    else:
        assert all(v is None for v in got.values())


def test_nothing_to_read(tmp_path, monkeypatch):
    laid = Laid()
    one_compress(laid)
    # a request the spans lack
    run = window(tmp_path, laid, monkeypatch, {"compress": [(0, 100), (200, 300)]}, busy=[(10, 20)])
    assert all(v is None for v in metrics(run, "compress").values())
    # a program that keeps no spans, and a run with no trace
    run = window(tmp_path, laid, monkeypatch, {"compress": [(0, 100)]}, busy=[(10, 20)])
    monkeypatch.setattr(dspans, "recorded", lambda: None)
    assert all(v is None for v in metrics(run, "compress").values())
    assert all(readers.load(m)(readers.Window()) is None for m in _NAMES)
