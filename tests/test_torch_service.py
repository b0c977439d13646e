"""The port's slice as a whole on the CPU: ``GpuCompressionService`` with
``device="cpu"`` (the kernels' plain PyTorch versions) writes ``.dcz`` files
byte-identical to the JAX package's CPU and TPU services, files decode across
the two packages, corruption is caught, and the port's CLI, factory and
imports behave.  Each package gets its own config, from the same settings.
Exact equality throughout: the outputs are bytes."""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import datacomp_tpu.config  # noqa: E402
import datacomp_tpu_torch.config  # noqa: E402
from datacomp_tpu.core import read_container  # noqa: E402
from datacomp_tpu.services.cpu_service import CpuCompressionService  # noqa: E402
from datacomp_tpu.services.tpu_service import TpuCompressionService  # noqa: E402
from datacomp_tpu.utils.testdata import generate_bytes  # noqa: E402
from datacomp_tpu_torch import cli  # noqa: E402
from datacomp_tpu_torch.ops import COUNTERS  # noqa: E402
from datacomp_tpu_torch.services import (  # noqa: E402
    CpuCompressionService as PortCpuCompressionService,
    GpuCompressionService,
    create_compression_service,
    gpu_service,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _comp(over):
    comp = {"chunk_size_mb": 1, "subblock_symbols": 256, "format_version": 2,
            "codebook_mode": "fast"}
    comp.update(over)
    return comp


def cfg(**over):
    """The port's config."""
    return datacomp_tpu_torch.config.load_config(compression=_comp(over))


def jax_cfg(**over):
    """The JAX package's config, from the same settings."""
    return datacomp_tpu.config.load_config(
        compression=_comp(over), device={"fallback_on_error": False})


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three 1 MiB chunks: text (depth 8), skewed (depth 16), random (raw)."""
    d = tmp_path_factory.mktemp("corpus")
    data = (generate_bytes("text", 1 << 20) + generate_bytes("skewed", 1 << 20)
            + generate_bytes("random", 300_000))
    src = d / "in.bin"
    src.write_bytes(data)
    return d, str(src), data


@pytest.fixture(scope="module")
def dcz_files(corpus):
    """The corpus compressed by the port, the CPU service and the TPU service."""
    d, src, _ = corpus
    out = {}
    for name, make in (
        ("port", lambda: GpuCompressionService(cfg(), device="cpu")),
        ("cpu", lambda: CpuCompressionService(jax_cfg())),
        ("tpu", lambda: TpuCompressionService(jax_cfg())),
    ):
        out[name] = str(d / f"{name}.dcz")
        with make() as svc:
            svc.compress(src, out[name])
    return out


def read(path):
    with open(path, "rb") as f:
        return f.read()


def test_dcz_identical_to_cpu_and_tpu_services(dcz_files):
    header, _ = read_container(dcz_files["port"])
    assert header.version == 2 and header.subblock_symbols == 256
    assert [c.code_lengths.any() for c in header.chunks] == [True, True, False]
    assert read(dcz_files["port"]) == read(dcz_files["cpu"])
    assert read(dcz_files["port"]) == read(dcz_files["tpu"])


def test_port_decodes_jax_written_file(corpus, dcz_files):
    d, _, data = corpus
    out = str(d / "from_tpu.out")
    plain_calls = COUNTERS["decode_batch"][1].value
    with GpuCompressionService(cfg(), device="cpu") as svc:
        svc.decompress(dcz_files["tpu"], out)
    assert read(out) == data
    assert COUNTERS["decode_batch"][1].value == plain_calls + 2  # the two coded chunks


def test_jax_decodes_port_written_file(corpus, dcz_files):
    d, _, data = corpus
    out = str(d / "from_port.out")
    with TpuCompressionService(jax_cfg()) as svc:
        svc.decompress(dcz_files["port"], out)
    assert read(out) == data


def test_corrupt_payload_raises_checksum_error(corpus, dcz_files):
    d, _, _ = corpus
    raw = bytearray(read(dcz_files["port"]))
    raw[1000] ^= 0x40  # inside the first chunk's payload
    bad = d / "bad.dcz"
    bad.write_bytes(bytes(raw))
    with GpuCompressionService(cfg(), device="cpu") as svc:
        with pytest.raises(IOError, match="Checksum mismatch in chunk 0"):
            svc.decompress(str(bad), str(d / "bad.out"))


@pytest.mark.parametrize("version,mode,max_len", [(1, "java", 0), (2, "fast", 32)])
def test_host_decode_routes(tmp_path, version, mode, max_len):
    """v1 containers and codebooks deeper than 16 bits decode on the host,
    through the counted route; the files still match the CPU service's."""
    f = np.zeros(256, np.int64)
    a, b = 1, 1
    for s in range(24):  # Fibonacci counts: a 23-bit-deep optimal code
        f[s] = a
        a, b = b, a + b
    data = np.repeat(np.arange(256, dtype=np.uint8), f).tobytes()
    src = tmp_path / "fib.bin"
    src.write_bytes(data)
    over = dict(format_version=version, codebook_mode=mode, max_code_len=max_len)
    with CpuCompressionService(jax_cfg(**over)) as svc:
        svc.compress(str(src), str(tmp_path / "c.dcz"))
    routes = gpu_service.host_decode_routes.value
    with GpuCompressionService(cfg(**over), device="cpu") as svc:
        svc.compress(str(src), str(tmp_path / "p.dcz"))
        svc.decompress(str(tmp_path / "p.dcz"), str(tmp_path / "p.out"))
    assert read(tmp_path / "p.dcz") == read(tmp_path / "c.dcz")
    assert read(tmp_path / "p.out") == data
    assert gpu_service.host_decode_routes.value == routes + 1


def test_cli_round_trip(corpus, capsys, monkeypatch):
    """The CLI on the plain versions, selected by the config's device platform."""
    d, src, data = corpus
    monkeypatch.setenv("DATACOMP_DEVICE_PLATFORM", "cpu")
    dcz, out = str(d / "cli.dcz"), str(d / "cli.out")
    launches = COUNTERS["encode_batch"][1].value
    assert cli.main(["compress", src, dcz, "1", "--format", "2",
                     "--codebook-mode", "fast"]) == 0
    assert "Verify:     OK" in capsys.readouterr().out
    assert COUNTERS["encode_batch"][1].value == launches + 2  # the two coded chunks
    assert read_container(dcz)[0].version == 2
    assert cli.main(["decompress", dcz, out, "1"]) == 0
    assert read(out) == data
    assert cli.main(["verify", dcz, "1", "--deep"]) == 0
    assert "OK" in capsys.readouterr().out
    assert cli.main(["devices"]) == 0


def test_cuda_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GpuCompressionService(cfg(), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_compression_service(cfg())
    assert cli.main(["compress", __file__, str(tmp_path / "x.dcz")]) == 1


def test_factory_force_cpu_returns_host_codec():
    with create_compression_service(cfg(), force_cpu=True) as svc:
        assert isinstance(svc, PortCpuCompressionService)


def test_port_imports_no_jax():
    """Every module of the port loads without jax and without the JAX package
    (in a fresh interpreter: this test process has both loaded already)."""
    code = (
        "import pkgutil, importlib, sys, datacomp_tpu_torch\n"
        "for m in pkgutil.walk_packages(datacomp_tpu_torch.__path__, 'datacomp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'datacomp_tpu'))\n"
        "assert not bad, bad\n"
        "print('modules', len([k for k in sys.modules if k.startswith('datacomp_tpu_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 10
