"""The port's benchmark module (``datacomp_tpu_torch/benchmark``) and test-data
writers on the CPU, against the JAX package's where both compute the same
thing: the corpus and file writers byte for byte, the corpus bench's sizes and
ratios number for number (the port's ``gpu`` backend on the kernels' plain
versions), the suite's rows and formats.  The kernel and batch benches need a
CUDA device: here they must refuse, and their bound, row and format helpers
give fixed answers on fixed numbers.  Their runs on the card are in
``tests/test_torch_gpu.py``."""

import json
import math
import os

import pytest
import torch

import datacomp_tpu.benchmark.corpus as jcorpus
import datacomp_tpu.utils.testdata as jtestdata
import datacomp_tpu_torch.benchmark.corpus as pcorpus
import datacomp_tpu_torch.config as pconfig
import datacomp_tpu_torch.utils.testdata as ptestdata
from datacomp_tpu_torch.benchmark import BenchmarkSuite, kernels
from datacomp_tpu_torch.benchmark.suite import device_time_split
from datacomp_tpu_torch.services import CpuCompressionService

SCALE = 1 / 64  # a 1 MB corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    written = ptestdata.generate_corpus(str(d / "p"), scale=SCALE)
    jwritten = jtestdata.generate_corpus(str(d / "j"), scale=SCALE)
    return d, written, jwritten


def test_corpus_identical(corpus):
    d, written, jwritten = corpus
    assert [(os.path.basename(p), k) for p, k in written] == \
        [(os.path.basename(p), k) for p, k in jwritten]
    assert len(written) == 7
    for (p, _), (j, _) in zip(written, jwritten):
        with open(p, "rb") as fp, open(j, "rb") as fj:
            assert fp.read() == fj.read(), p


@pytest.mark.parametrize("writer", ["random", "compressible"])
@pytest.mark.parametrize("size_mb", [0, 1, 2])
def test_file_writers_identical(tmp_path, writer, size_mb):
    p, j = str(tmp_path / "p.bin"), str(tmp_path / "j.bin")
    getattr(ptestdata, f"generate_{writer}_file")(size_mb, p)
    getattr(jtestdata, f"generate_{writer}_file")(size_mb, j)
    with open(p, "rb") as fp, open(j, "rb") as fj:
        data = fp.read()
        assert data == fj.read()
    assert len(data) == size_mb << 20


def _sizes(report):
    return {r["file"]: (r["compressed_bytes"], r["ratio"], r["entropy_bound_ratio"],
                        r["kind"], r["beats_reference"]) for r in report["files"]}


@pytest.fixture(scope="module")
def jax_corpus_report(corpus):
    d, _, _ = corpus
    return jcorpus.run_corpus_bench(str(d / "p"), backend="cpu")


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_corpus_bench_identical(corpus, jax_corpus_report, monkeypatch, backend):
    """The host codec and the GPU service on its plain versions give the JAX
    host codec's sizes and ratios, file for file."""
    monkeypatch.setenv("DATACOMP_DEVICE_PLATFORM", "cpu")
    d, _, _ = corpus
    report = pcorpus.run_corpus_bench(str(d / "p"), backend=backend)
    assert report["backend"] == backend
    assert _sizes(report) == _sizes(jax_corpus_report)
    for key in ("original_bytes", "compressed_bytes", "ratio"):
        assert report["totals"][key] == jax_corpus_report["totals"][key]
    assert json.loads(pcorpus.format_corpus_results(report, "json"))["files"]
    assert pcorpus.format_corpus_results(report, "csv").splitlines()[0].startswith("file,")
    assert "TOTAL" in pcorpus.format_corpus_results(report)


def test_corpus_bench_gpu_needs_a_card(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("DATACOMP_DEVICE_PLATFORM", raising=False)
    d, _, _ = corpus
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcorpus.run_corpus_bench(str(d / "p"), backend="gpu")
    with pytest.raises(ValueError, match="cpu|gpu"):
        pcorpus.run_corpus_bench(str(d / "p"), backend="tpu")


def _suite(monkeypatch, **device):
    monkeypatch.setenv("DATACOMP_DEVICE_PLATFORM", "cpu")
    cfg = pconfig.load_config(
        compression={"chunk_size_mb": 1},
        benchmark={"warmup_iterations": 0, "measurement_iterations": 1},
        device=device,
    )
    suite = BenchmarkSuite(cfg)
    return suite, suite.run_full_suite(size_mb=1)


@pytest.fixture(scope="module")
def suite_results():
    mp = pytest.MonkeyPatch()
    try:
        yield _suite(mp)
    finally:
        mp.undo()


def test_suite_rows(suite_results):
    suite, res = suite_results
    gpu = "GPU (plain PyTorch on the CPU)"
    assert [(r.service_name, r.operation) for r in res] == [
        ("CPU", "compress"), ("CPU", "decompress"), (gpu, "compress"), (gpu, "decompress")]
    for r in res:
        assert r.throughput_mbps > 0 and r.mean_s > 0 and r.iterations == 1
        assert r.file_size == 1 << 20
    # both services write the same container in the same config
    assert res[0].compressed_size == res[2].compressed_size
    assert 0 < res[0].compression_ratio < 1
    assert res[0].stage_ms and res[2].stage_ms


def test_suite_formats(suite_results):
    suite, res = suite_results
    data = json.loads(suite.format_results(res, "json"))
    assert len(data["results"]) == len(res)
    assert data["speedup_compress"] == res[0].mean_s / res[2].mean_s
    assert data["speedup_decompress"] == res[1].mean_s / res[3].mean_s
    lines = suite.format_results(res, "csv").splitlines()
    assert lines[0].startswith("service,operation") and len(lines) == len(res) + 1
    text = suite.format_results(res, "console")
    assert "Benchmark Results" in text and "MB/s" in text
    assert "GPU speedup (compress)" in text and "[GPU (plain PyTorch on the CPU)]" in text


def test_suite_force_cpu(monkeypatch):
    suite, res = _suite(monkeypatch, force_cpu=True)
    assert [r.service_name for r in res] == ["CPU", "CPU"]
    assert suite.speedup(res) is None
    assert "speedup" not in suite.format_results(res)


def test_suite_gpu_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    suite = BenchmarkSuite(pconfig.load_config(device={"platform": "any"}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        suite._services()


def test_detailed_profiling_writes_a_trace(tmp_path):
    """The trace is written on the CPU too (the host codec runs no torch
    operation, so it holds the profiled window alone), with no device event."""
    src = tmp_path / "in.bin"
    src.write_bytes(ptestdata.generate_bytes("text", 300_000))
    cfg = pconfig.load_config(
        compression={"chunk_size_mb": 1},
        benchmark={"warmup_iterations": 0, "measurement_iterations": 2,
                   "detailed_profiling": True})
    with CpuCompressionService(cfg) as svc:
        comp, decomp = BenchmarkSuite(cfg).benchmark_service(svc, "CPU", str(src), str(tmp_path))
    trace = tmp_path / "torch-trace-CPU.json"
    assert trace.is_file()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "Trace" for e in events)  # the profiled window
    assert device_time_split(str(trace)) is None
    assert len(comp.durations_s) == len(decomp.durations_s) == 2


def test_device_time_split(tmp_path):
    """Kernels, copies and fills summed; overlaps counted once in the busy
    time; the window is the profiler's own span."""
    events = [
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 5, "dur": 900},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 100, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "encode_kernel", "ts": 250, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "decode_kernel", "ts": 500, "dur": 50},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 600, "dur": 10},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 700},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    split = device_time_split(str(path))
    assert split == pytest.approx({"kernel_ms": 0.15, "memcpy_ms": 0.2, "memset_ms": 0.01,
                                   "busy_ms": 0.31, "window_ms": 1.0, "idle_share": 0.69,
                                   "events": 4}, rel=1e-12)


@pytest.mark.parametrize("bench", ["run_kernel_bench", "run_pipeline_batch_bench",
                                   "run_decode_batch_bench", "calibrate_primitives"])
def test_device_benches_refuse_the_cpu(monkeypatch, bench):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        getattr(kernels, bench)()


def test_batch_chunks_are_distinct_parts_of_one_stream():
    """The batch benches' chunks, made once for both: consecutive parts of
    the JAX package's ``text`` stream."""
    blob = kernels.batch_chunks(1, "text", 3)
    assert blob.shape == (3, 1 << 20)
    assert blob.tobytes() == jtestdata.generate_bytes("text", 3 << 20)
    assert len({row.tobytes() for row in blob}) == 3


def test_device_info_names_the_current_card(monkeypatch):
    """The power limit is read for the card torch runs on, named to
    nvidia-smi by its PCI address, not by torch's index."""
    from types import SimpleNamespace

    props = SimpleNamespace(name="Card B", pci_domain_id=0, pci_bus_id=0x1B, pci_device_id=0)
    seen = {}

    def run(argv, **kw):
        seen["argv"] = argv
        return SimpleNamespace(stdout="650.00 W\n")

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: props if i == 2 else None)
    monkeypatch.setattr(kernels.subprocess, "run", run)
    assert kernels.device_info() == {"name": "Card B", "power_limit": "650.00 W"}
    assert seen["argv"][:3] == ["nvidia-smi", "-i", "00000000:1B:00.0"]


def test_bound():
    assert kernels.bound(3.35e9, 0) == {"bound_ms": pytest.approx(1.0), "bound_by": "bytes"}
    assert kernels.bound(0, 67e9) == {"bound_ms": pytest.approx(1.0),
                                      "bound_by": "operations"}
    assert kernels.bound(3.35e9, 67e9)["bound_by"] == "bytes"  # a tie goes to bytes
    n = 16 << 20
    assert kernels.histogram_work([n]) == (n + 1024, n)
    assert kernels.histogram_work([n, 17, 0]) == (n + 17 + 3 * 1024, n + 17)
    assert kernels.codebook_work(4) == (4 * 3072, 4 * 256 * 63)
    assert kernels.encode_work([n, n], 100, 10) == (2 * n + 2 * 2048 + 440, 2 * n)
    assert kernels.decode_work(100, 10, 1152, n) == (400 + 40 + 1152 + n, n)


def test_kernel_row():
    row = kernels.kernel_row(0.5, 0.75, 1 << 20, (3.35e8, 0))
    assert row == {"ms_per_chunk": 0.5, "call_ms": 0.75,
                   "mbps": pytest.approx((1 << 20) / 1e6 / 5e-4),
                   "bound_ms": pytest.approx(0.1), "bound_kind": "bytes",
                   "efficiency": pytest.approx(0.2), "exact": True}
    ops = kernels.kernel_row(1.0, 1.0, 1000, (0, 6.7e9))
    assert (ops["bound_ms"], ops["bound_kind"]) == (pytest.approx(0.1), "ops")
    k4 = kernels.kernel_row(0.004, 0.02, 0, kernels.codebook_work(1), floor_ms=0.001)
    assert (k4["bound_ms"], k4["bound_kind"], k4["mbps"]) == (0.001, "launch floor", None)
    assert k4["efficiency"] == pytest.approx(0.25)
    tiny_floor = kernels.kernel_row(1.0, 1.0, 1000, (3.35e9, 0), floor_ms=0.5)
    assert tiny_floor["bound_kind"] == "bytes"  # the floor only counts when it is longer


def test_batch_row():
    row = kernels.batch_row(4, 1 << 20, 0.2, 0.3)
    assert row["batch"] == 4
    assert row["compute_ms_per_chunk"] == pytest.approx(0.05)
    assert row["mbps_per_chunk"] == pytest.approx((1 << 20) / 1e6 / 5e-5)
    assert math.isclose(row["overhead_ms_per_program"], 0.1)
    assert math.isclose(row["overhead_ms_per_chunk"], 0.025)
    # host work that hides under the device time reads as it is, not clamped
    assert kernels.batch_row(1, 1, 0.3, 0.2)["overhead_ms_per_program"] < 0


def test_primitive_readings():
    got = kernels.primitive_readings(1.0, 0.02, 0.04, 0.001, copy_bytes=1 << 30,
                                     count=1 << 20)
    assert got == {"hbm_copy_bytes_per_s": 2 * (1 << 30) / 1e-3,
                   "hbm_copy_peak_frac": 2 * (1 << 30) / 1e-3 / 3.35e12,
                   "gather_ns": 0.02 * 1e6 / (1 << 20), "atomic_add_ns": 0.04 * 1e6 / (1 << 20),
                   "launch_floor_ms": 0.001}
    assert got["gather_ns"] > 0


@pytest.mark.parametrize("bad", [0.0, -0.5, float("nan"), float("inf")])
def test_primitive_readings_flag_bad_times(bad):
    """A reading that is not a finite time above zero is null and suspect,
    never a clamped or rounded 0."""
    got = kernels.primitive_readings(bad, bad, 1.0, bad)
    assert got["hbm_copy_bytes_per_s"] is None and got["hbm_copy_peak_frac"] is None
    assert got["gather_ns"] is None and got["launch_floor_ms"] is None
    assert got["atomic_add_ns"] == 1e6 / kernels.PRIMITIVE_COUNT
    assert [s.split(":")[0] for s in got["suspect"]] == ["hbm_copy", "gather", "launch_floor"]


def _fixed_results():
    return {
        "histogram": kernels.kernel_row(0.0105, 0.044, 16 << 20,
                                        kernels.histogram_work([16 << 20])),
        "codebook": kernels.kernel_row(0.0053, 0.017, 0, kernels.codebook_work(1),
                                       floor_ms=0.00107),
        "_skipped": {"decode": "depth 24 > 16: the codec decodes such chunks on the host"},
        "_primitives": kernels.primitive_readings(0.4, 0.0, 0.1, 0.00107),
        "_device": {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"},
    }


def test_format_kernel_results():
    res = _fixed_results()
    text = kernels.format_kernel_results(res, 16)
    assert "histogram" in text and "[bytes]" in text and "[launch floor]" in text
    assert "not run: depth 24 > 16" in text
    assert "gather not measured (suspect) ns/elem" in text
    assert "suspect: gather: timed 0.0 ms" in text
    assert "device: NVIDIA H100 80GB HBM3, power limit 700.00 W" in text
    data = json.loads(kernels.format_kernel_results(res, 16, "json"))
    assert data["chunk_mb"] == 16
    assert data["device"] == res["_device"]
    assert set(data["kernels"]) == {"histogram", "codebook", "_skipped", "_primitives"}
    assert data["kernels"]["_primitives"]["gather_ns"] is None


def test_format_pipeline_batch_results():
    rows = {"pipeline-b1": kernels.batch_row(1, 16 << 20, 0.07, 0.15),
            "decode-b4": kernels.batch_row(4, 16 << 20, 0.32, 0.36)}
    text = kernels.format_pipeline_batch_results(rows, 16)
    assert "pipeline-b1" in text and "decode-b4" in text
    assert "0.0800 ms/program" in text and "0.0100 ms/chunk" in text

