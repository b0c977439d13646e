"""The ``java-v1.silesia`` cell as BENCHMARK.json holds it: its files are the
format-1 document the harness was tested on (``helpers.format1_document``),
its run cut to the CPU is correct and its control incorrect, and the host
decode route's three readers read a traced CPU run, the idle one also where
a request's start lies far off the others'."""

import pytest

from dczbench import readers, run, spans, trace
from datacomp_tpu_torch.models import stage_metrics

from .helpers import FORMAT1, cut, format1_document

#: the host decode route's readers, each listing this cell alone
READERS = ("host_decode_ms_per_MB.java-v1.silesia",
           "idle_host_decode_ms_per_MB.restore.java-v1.silesia",
           "host_decode_share.restore.java-v1.silesia")
#: what the cell reports besides them: restore-side readers that need no
#: request-by-request alignment of the program's spans with the trace
SHARED = ("decode_stage_ms_per_MB.silesia", "device_idle.restore.silesia")


def _cut_run(control=False, trace_on=False, seed=2**31 + 91):
    bench, _, config_doc, traffic = cut(run.load_cell(FORMAT1))
    return run.run_cell(FORMAT1, bench, config_doc, traffic, seed, 600.0, trace=trace_on,
                        device="cpu", control=control)


def test_files_are_the_tested_document():
    bench, cell, config_doc, traffic = run.load_cell(FORMAT1)
    _, want_cell, want_doc, want_traffic = format1_document()
    for key in ("name", "compression", "device", "codebook_rule", "control"):
        assert config_doc[key] == want_doc[key], key
    for key in ("name", "config", "traffic", "chips"):
        assert cell[key] == want_cell[key], key
    assert traffic == want_traffic
    config = next(c for c in bench["configs"] if c["name"] == "java-v1")
    assert config["file"] == "dczbench/configs/java-v1.json" and config["reduced"] == []
    assert {m["name"] for m in run.end_to_end_metrics(bench, FORMAT1)} == {
        "decompress_MBps", "setup_s"}
    assert {m["name"] for m in run.per_layer_metrics(bench, FORMAT1)} == {*READERS, *SHARED}


def test_cut_cell_is_correct_and_its_control_is_not(tmp_tmpdir):
    sound = _cut_run()
    assert sound["correct"], sound["checks"]
    assert sound["attempted"] == 3 and sound["failed"] == 0
    assert set(sound["metrics"]) == {"decompress_MBps", "setup_s"}
    control = _cut_run(control=True, seed=2**31 + 92)
    assert not control["correct"]
    assert control["checks"]["codebook_faults"]["value"] > 0


class _OneKernel(trace.Trace):
    """A CPU run's trace with one 1 us kernel at the window's start, so the
    device is idle through every restore call."""

    def __init__(self, path):
        super().__init__(path)
        self.device = [{"ph": "X", "cat": "kernel", "name": "void k()", "ts": self.lo,
                        "dur": 1.0}]
        self.busy = [[self.lo, self.lo + 1.0]]


def _traced_cut_run(monkeypatch):
    """A traced cut run, and the window its readers read and the program's
    spans of it, taken before they are cleared."""
    monkeypatch.setattr(trace, "Trace", _OneKernel)
    seen = {}
    load = readers.load

    def spying_load(name):
        def read(window):
            seen.setdefault("window", window)
            seen.setdefault("spans", stage_metrics.spans())
            return load(name)(window)
        return read

    monkeypatch.setattr(readers, "load", spying_load)
    stage_metrics.clear_spans()
    try:
        result = _cut_run(trace_on=True)
    finally:
        stage_metrics.clear_spans()
    return result, seen["window"], seen["spans"]


def test_host_decode_readers_on_a_traced_run(tmp_tmpdir, monkeypatch):
    result, window, kept = _traced_cut_run(monkeypatch)
    assert result["correct"], result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert got["host_decode_share.restore.java-v1.silesia"] == pytest.approx(100.0)
    assert got["host_decode_ms_per_MB.java-v1.silesia"] > 0
    assert got["idle_host_decode_ms_per_MB.restore.java-v1.silesia"] > 0
    # the route's decoding is its own leaf: no longer the transfer group's
    monkeypatch.setattr(spans, "recorded", lambda: kept)
    assert got["idle_host_decode_ms_per_MB.restore.java-v1.silesia"] > \
        spans.idle_ms_per_mb(window, "restore", "transfer")
    assert set(got) == {*READERS, *SHARED}


def test_idle_host_decode_reads_past_one_stalled_request(tmp_tmpdir, monkeypatch):
    """One request whose span starts far after the harness's range makes
    ``spans.split`` give up; the reader still reads, what ``split`` gives
    without the check."""
    _, window, kept = _traced_cut_run(monkeypatch)
    last = max((s for s in kept if s.name == "decompress"), key=lambda s: s.start_ns)
    late = 2 * int(spans.MAX_SKEW_US) * 1000
    stalled = [s._replace(start_ns=s.start_ns + late) if s is last else s for s in kept]
    monkeypatch.setattr(spans, "recorded", lambda: stalled)
    assert spans.split(window, "restore") is None
    reader = readers.load("idle_host_decode_ms_per_MB.restore.java-v1.silesia")
    got = reader(window)
    assert got is not None and got > 0
    monkeypatch.setattr(spans, "MAX_SKEW_US", float("inf"))
    assert got == pytest.approx(reader(window))
