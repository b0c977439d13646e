"""``k5_roofline.java-v1.silesia``: the gap finder's bytes over its traced
time in restore calls.  On a traced CPU run of the cut ``java-v1.silesia``
cell whose trace holds one stand-in K5 kernel in each restore call, it
reads the share those kernels give; on a trace with none (a program that
decodes format 1 on the host), nothing."""

import json

import pytest

from dczbench import readers, run, trace, work

from .helpers import FORMAT1, cut

READER = "k5_roofline.java-v1.silesia"
#: the stand-in kernel's name as the profiler writes it
KERNEL = "void (anonymous namespace)::gap_finder_kernel(unsigned int const*, int)"


def _k5():
    return readers.load(READER)


def test_bytes_count_coded_chunks_the_device_decodes():
    chunks = [{"n": 16 << 20, "size": 9 << 20, "raw": False, "depth": 12},
              {"n": 5000, "size": 3000, "raw": False, "depth": 16},
              {"n": 4000, "size": 4000, "raw": True, "depth": 0},
              {"n": 7000, "size": 6000, "raw": False, "depth": 17}]
    window = readers.Window(chunks=chunks, trace=_Stub(2e-3))
    want = (9 << 20) + 4 * 4162 + 3000 + 4 * 2
    assert _k5()(window) == pytest.approx(100.0 * want / work.HBM_BYTES_PER_S / 2e-3)


class _Stub:
    """A trace whose K5 kernels read ``seconds`` in any phase."""

    device = [{}]

    def __init__(self, seconds):
        self.seconds = seconds

    def device_s(self, phase=None, kernels=(), category=None):
        return self.seconds if kernels == ("gap_finder_kernel",) else 0.0


def test_no_k5_kernel_reads_nothing(tmp_path):
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": ts, "dur": 1000}
              for n, ts in (("window", 0), ("restore", 10))]
    events.append({"ph": "X", "cat": "kernel", "name": "void decode_kernel(int)", "ts": 20,
                   "dur": 5})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    chunks = [{"n": 1 << 20, "size": 1 << 19, "raw": False, "depth": 10}]
    assert _k5()(readers.Window(chunks=chunks, trace=trace.Trace(str(path)))) is None
    assert _k5()(readers.Window(chunks=chunks)) is None  # an untraced run


class _OneK5AnEachRestore(trace.Trace):
    """A CPU run's trace with a 1 us stand-in K5 kernel at the start of each
    restore call."""

    def __init__(self, path):
        super().__init__(path)
        self.device = [{"ph": "X", "cat": "kernel", "name": KERNEL, "ts": lo, "dur": 1.0}
                       for lo, _ in self.phases["restore"]]
        self.busy = [[e["ts"], e["ts"] + 1.0] for e in self.device]


def test_reads_a_traced_cut_run(tmp_tmpdir, monkeypatch):
    monkeypatch.setattr(trace, "Trace", _OneK5AnEachRestore)
    seen = {}
    load = readers.load

    def spying_load(name):
        def read(window):
            seen.setdefault("window", window)
            return load(name)(window)
        return read

    monkeypatch.setattr(readers, "load", spying_load)
    bench, _, config_doc, traffic = cut(run.load_cell(FORMAT1))
    result = run.run_cell(FORMAT1, bench, config_doc, traffic, 2**31 + 93, 600.0, trace=True,
                          device="cpu")
    assert result["correct"], result["checks"]
    window = seen["window"]
    restores = len(window.trace.phases["restore"])
    nbytes = sum(c["size"] + 4 * -(-c["n"] // 4032) for c in work.coded(window.chunks)
                 if c["depth"] <= 16)
    assert restores > 0 and nbytes > 0
    got = result["metrics"][READER]["value"]
    assert got == pytest.approx(100.0 * nbytes / work.HBM_BYTES_PER_S / (restores * 1e-6),
                                rel=1e-3)
