"""BENCHMARK.json's metrics fit together, and the readers and the card's
kernel time read what they say."""

import json

import pytest

from dczbench import readers, run
from dczbench.trace import Trace

from .helpers import cpu_run

BENCH, _, _, _ = run.load_cell("fast-v2.silesia")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_reports_what_its_per_layer_metrics_move(workload):
    e2e = {m["name"] for m in run.end_to_end_metrics(BENCH, workload)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = run.per_layer_metrics(BENCH, workload)
    assert per_layer
    assert all(m["moves"] in e2e for m in per_layer), workload


class _Kernels:
    """A trace whose every kernel query reads 2 ms."""

    device = [{}]

    def device_s(self, phase=None, kernels=(), category=None):
        return 2e-3


@pytest.mark.parametrize("name", ["k2_roofline", "k3_roofline"])
def test_device_v2_rooflines_read_what_the_shared_ones_read(name):
    chunks = [{"n": 1 << 24, "size": 9 << 20, "raw": False, "depth": 12}] * 3
    window = readers.Window(chunks=chunks, trace=_Kernels())
    want = readers.load(f"{name}.silesia")(window)
    assert want is not None
    assert readers.load(f"{name}.device-v2.silesia")(window) == want


def test_rate_stand_ins_are_the_end_to_end_rates():
    window = readers.Window(phase_bytes={"compress": 2_000_000, "restore": 3_000_000},
                            phase_s={"compress": 0.5, "restore": 1.5})
    assert readers.load("compress_MBps.device-v2")(window) == 4.0
    assert readers.load("decompress_MBps.device-v2")(window) == 2.0
    assert readers.load("compress_MBps.device-v2")(readers.Window()) is None


def _trace(tmp_path, device_events):
    events = [{"ph": "X", "cat": "user_annotation", "name": "window", "ts": 0, "dur": 1e6}]
    events += [{"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
               for cat, name, ts, dur in device_events]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace(str(path))


def test_kernel_time_counts_kernels_only(tmp_path):
    tr = _trace(tmp_path, [("kernel", "void decode_kernel(int)", 100, 1500),
                           ("kernel", "void encode_kernel<true>(int)", 5000, 500),
                           ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 9000, 40000),
                           ("gpu_memset", "Memset (Device)", 60000, 300)])
    assert run.kernel_ms_per_gb(tr, 2_000_000_000) == pytest.approx(1.0)
    assert run.kernel_ms_per_gb(_trace(tmp_path, [("gpu_memcpy", "Memcpy", 0, 9)]), 10) is None
    assert run.kernel_ms_per_gb(None, 10) is None


def test_device_v2_run_reports_no_host_rate_end_to_end(tmp_tmpdir):
    got = cpu_run("device-v2.silesia")
    assert got["correct"]
    # on the CPU no kernel is traced, so set-up is all there is to report
    assert set(got["metrics"]) == {"setup_s"}
    assert set(cpu_run("fast-v2.silesia")["metrics"]) == {"compress_MBps", "decompress_MBps",
                                                         "setup_s"}
