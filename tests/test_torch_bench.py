"""The port's headline benchmark (``python -m datacomp_tpu_torch.bench``) on
the CPU, against root ``bench.py`` where both compute the same thing.

The entry point runs once as a subprocess at 4 MB on the kernels' plain
versions (``DATACOMP_DEVICE_PLATFORM=cpu``): one JSON line with root
``bench.py``'s keys, the link fields and the device, and no module of jax or
of the JAX package loaded.  Without that variable, on a machine with no CUDA
device, it prints ``{"error": ...}`` and exits 1.  The corpus is root
``bench.py``'s byte for byte, the ``gpu`` leg's ``.dcz`` is the JAX host
codec's, and the ceiling is root ``bench.py``'s formula.  The run on the card
is ``chip_smoke.py``'s."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

import datacomp_tpu.config as jconfig
from datacomp_tpu.services.cpu_service import CpuCompressionService as JaxCpuService
from datacomp_tpu.utils.testdata import generate_bytes as jax_generate_bytes
from datacomp_tpu_torch import bench
from datacomp_tpu_torch.services import GpuCompressionService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE_KEYS = {
    "metric", "value", "unit", "vs_baseline", "best_backend", "file_mb", "iters",
    *(f"{leg}_{m}" for leg in ("cpu", "gpu") for m in ("compress_mbps", "decompress_mbps", "ratio")),
    *bench.LINK_KEYS, "device",
}

# python -m datacomp_tpu_torch.bench, then the modules of jax and of the JAX
# package that it loaded, on stderr's last line
_ENTRY = r"""
import json, runpy, sys
code = 0
try:
    runpy.run_module("datacomp_tpu_torch.bench", run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code
print("MODULES " + json.dumps(sorted(m for m in sys.modules
                                     if m.split(".")[0] in ("jax", "datacomp_tpu"))),
      file=sys.stderr)
sys.exit(code)
"""


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", os.path.join(REPO, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_entry_point_prints_one_line_on_the_plain_versions():
    env = {**os.environ, "DATACOMP_DEVICE_PLATFORM": "cpu", "BENCH_SIZE_MB": "4",
           "BENCH_CHUNK_MB": "1", "BENCH_ITERS": "1", "PYTHONPATH": REPO}
    env.pop("BENCH_BACKENDS", None)
    proc = subprocess.run([sys.executable, "-c", _ENTRY], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout
    line = json.loads(lines[0])
    assert set(line) == LINE_KEYS
    assert line["metric"] == "end_to_end_compress_throughput" and line["unit"] == "MB/s"
    assert line["value"] == max(line["cpu_compress_mbps"], line["gpu_compress_mbps"])
    assert line["value"] == line[f"{line['best_backend']}_compress_mbps"]
    assert line["vs_baseline"] == round(line["value"] / 12.6, 2)
    assert (line["file_mb"], line["iters"]) == (4, 1)
    # v2, java codes on the host against fast codes on the plain versions
    assert 0.6 < line["cpu_ratio"] < 0.8 and 0.6 < line["gpu_ratio"] < 0.8
    assert all(line[k] is None for k in bench.LINK_KEYS)  # no link on the CPU
    assert line["device"] == {"name": "cpu", "power_limit": None}
    assert json.loads(proc.stderr.splitlines()[-1].removeprefix("MODULES ")) == []


@pytest.fixture
def no_cuda(monkeypatch):
    for var in ("DATACOMP_DEVICE_PLATFORM", "DATACOMP_DEVICE_FORCE_CPU", "BENCH_BACKENDS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("BENCH_SIZE_MB", "1")
    monkeypatch.setenv("BENCH_CHUNK_MB", "1")
    monkeypatch.setenv("BENCH_ITERS", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _error_line(capsys) -> dict:
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    line = json.loads(lines[0])
    assert list(line) == ["error"]
    return line


def test_no_cuda_device_is_an_error(no_cuda, capsys):
    assert bench.main() == 1
    assert "gpu leg" in _error_line(capsys)["error"]


@pytest.mark.parametrize("backends", ["cpu,tpu", "tpu", ","])
def test_unknown_backend_is_an_error(no_cuda, monkeypatch, capsys, backends):
    monkeypatch.setenv("BENCH_BACKENDS", backends)
    assert bench.main() == 1
    assert "each must be one of" in _error_line(capsys)["error"]


@pytest.mark.parametrize("failure", ["exception", "probe", "round trip"])
def test_failed_gpu_leg_is_never_replaced_by_cpu(no_cuda, monkeypatch, capsys, failure):
    monkeypatch.setenv("DATACOMP_DEVICE_PLATFORM", "cpu")

    def broken_leg(src, workdir, chunk_mb, iters):
        if failure == "exception":
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        if failure == "probe":
            return bench.link_rates({16: (0.002, 0.002), 64: (0.001, 0.004)})
        raise bench.BenchError("round trip mismatch")

    monkeypatch.setattr(bench, "gpu_leg", broken_leg)
    assert bench.main() == 1
    assert _error_line(capsys)["error"].startswith("gpu leg: ")


class _FakeService:
    """Records its calls, and restores ``restored`` whatever it was given."""

    def __init__(self, restored: bytes):
        self.calls, self.restored = [], restored

    def get_service_name(self):
        return "fake"

    def compress(self, src, dcz):
        self.calls.append("compress")
        with open(src, "rb") as f, open(dcz, "wb") as g:
            g.write(f.read()[::2])

    def decompress(self, dcz, out):
        self.calls.append("decompress")
        with open(out, "wb") as g:
            g.write(self.restored)


@pytest.mark.parametrize("iters", [1, 3])
def test_time_service_warms_up_then_takes_the_best(tmp_path, iters):
    src, dcz, out = (str(tmp_path / n) for n in ("s", "d", "o"))
    with open(src, "wb") as f:
        f.write(bytes(range(256)) * 64)
    svc = _FakeService(open(src, "rb").read())
    res = bench.time_service(svc, src, dcz, out, iters)
    assert svc.calls == ["compress"] * (1 + iters) + ["decompress"] * (1 + iters)
    assert set(res) == {"compress_mbps", "decompress_mbps", "ratio"}
    assert res["ratio"] == 0.5 and res["compress_mbps"] > 0 and res["decompress_mbps"] > 0
    svc = _FakeService(open(src, "rb").read()[:-1] + b"?")
    with pytest.raises(bench.BenchError, match="round trip mismatch"):
        bench.time_service(svc, src, dcz, out, iters)


@pytest.mark.parametrize("size_mb", [1, 5])
def test_corpus_is_root_bench_corpus(tmp_path, size_mb):
    """Root ``bench.py``'s corpus (``bench.py:157-165``), built here with the
    JAX package's generator."""
    mb = 1024 * 1024
    per = max(size_mb // 4, 1)
    want = b"".join([jax_generate_bytes("text", per * mb),
                     jax_generate_bytes("compressible", per * mb),
                     jax_generate_bytes("skewed", per * mb),
                     jax_generate_bytes("random", max(size_mb - 3 * per, 1) * mb)])
    path = str(tmp_path / "bench.bin")
    bench.write_corpus(path, size_mb)
    assert open(path, "rb").read() == want


def test_gpu_leg_writes_the_jax_host_codec_bytes(tmp_path, monkeypatch):
    """The ``gpu`` leg's config on the plain versions against the JAX
    package's host codec in fast v2, on the 4 MB corpus in 1 MiB chunks."""
    monkeypatch.setenv("DATACOMP_DEVICE_PLATFORM", "cpu")
    src = str(tmp_path / "bench.bin")
    bench.write_corpus(src, 4)
    with GpuCompressionService(bench.gpu_config(1)) as svc:
        svc.compress(src, str(tmp_path / "port.dcz"))
    cfg = jconfig.load_config(compression={"chunk_size_mb": 1, "format_version": 2,
                                           "codebook_mode": "fast"})
    with JaxCpuService(cfg) as svc:
        svc.compress(src, str(tmp_path / "jax.dcz"))
    port = open(tmp_path / "port.dcz", "rb").read()
    assert port == open(tmp_path / "jax.dcz", "rb").read()
    # the random MiB is stored raw: a quarter of the input never rides the link
    assert bench.raw_fraction(str(tmp_path / "port.dcz"), 4 << 20) == 0.25


def test_ceiling_is_root_bench_formula():
    root = _root_bench()
    for ratio in (0.0, 0.2, 0.25, 0.5, 0.7033, 0.9, 1.0, 1.2):
        for raw in (0.0, 0.1, 0.25, 0.5, 1.0):
            for h2d, d2h in ((55.8, 64.6), (12000.0, 9000.0), (25000.5, 3000.25)):
                assert bench.link_ceiling_mbps(ratio, raw, h2d, d2h) == \
                    root.relay_ceiling_mbps(ratio, raw_frac=raw, h2d=h2d, d2h=d2h)


def test_link_rates_and_fields():
    mib = (1 << 20) / 1e6
    rates = bench.link_rates({16: (0.0015 + 16 * mib / 12000, 16 * mib / 8000),
                              64: (0.0015 + 64 * mib / 12000, 64 * mib / 8000)})
    assert rates == {"h2d_mbps": 12000.0, "d2h_mbps": 8000.0, "latency_ms": 1.5}
    for bad in ({16: (0.002, 0.002), 64: (0.002, 0.004)},  # no slope
                {16: (0.004, 0.002), 64: (0.002, 0.004)},  # negative
                {16: (0.002, 0.002), 64: (0.0020001, 0.004)}):  # past 1e5 MB/s
        with pytest.raises(bench.BenchError, match="link probe"):
            bench.link_rates(bad)
    with pytest.raises(bench.BenchError, match="needs a CUDA device"):
        bench.probe_link("cpu")
    end = {"h2d_mbps": 10000.0, "d2h_mbps": 10000.0, "latency_ms": 0.5}
    fields = bench.link_fields(rates, end, {"compress_mbps": 500.0, "ratio": 0.7}, 0.25)
    assert set(fields) == set(bench.LINK_KEYS)
    assert (fields["gpu_link_h2d_mbps"], fields["gpu_link_d2h_mbps"],
            fields["gpu_link_latency_ms"]) == (11000.0, 9000.0, 1.0)
    assert fields["gpu_link_h2d_mbps_start"] == 12000.0 and fields["gpu_link_d2h_mbps_end"] == 10000.0
    assert fields["gpu_link_drift"] == round(2000 / 9000, 3)
    ceiling = bench.link_ceiling_mbps(0.7, 0.25, 11000.0, 9000.0)
    assert fields["gpu_link_ceiling_mbps"] == round(ceiling, 1)
    assert fields["gpu_vs_link_ceiling"] == round(500.0 / ceiling, 3)
