"""The port's device-codebook slice on the CPU: K4's plain version against the
JAX device builder, K1's A/B variants' plain paths against ``np.bincount`` and
the Pallas histogram (interpret mode), and ``GpuCompressionService`` in
``codebook_mode="device"`` (``device="cpu"``: the plain versions) against the
JAX package's services.  Exact equality throughout: the outputs are integers
and bytes."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import datacomp_tpu.config  # noqa: E402
import datacomp_tpu_torch.config  # noqa: E402
from datacomp_tpu.core import huffman as jax_huffman  # noqa: E402
from datacomp_tpu.ops.codebook import device_canonical_codes, device_code_lengths  # noqa: E402
from datacomp_tpu.ops.histogram_pallas import histogram_pallas  # noqa: E402
from datacomp_tpu.services.cpu_service import CpuCompressionService  # noqa: E402
from datacomp_tpu.services.tpu_service import TpuCompressionService  # noqa: E402
from datacomp_tpu.utils.testdata import generate_bytes  # noqa: E402
from datacomp_tpu_torch import cli, ops  # noqa: E402
from datacomp_tpu_torch.core import read_container  # noqa: E402
from datacomp_tpu_torch.services import (  # noqa: E402
    CpuCompressionService as PortCpuCompressionService,
    GpuCompressionService,
    gpu_service,
)


def _jax_codebook(hist: np.ndarray):
    lengths = device_code_lengths(jnp.asarray(hist, dtype=jnp.int32))
    return np.asarray(lengths), np.asarray(device_canonical_codes(lengths))


def _port_codebook(hist: np.ndarray):
    lengths, codes = ops.codebook(torch.from_numpy(hist.astype(np.int32)))
    assert lengths.dtype == torch.int32 and codes.dtype == torch.uint32
    return lengths.numpy(), codes.numpy()


def _fibonacci(depth: int) -> np.ndarray:
    """Counts 1, 1, 2, 3, 5, ... on symbols 0..depth: an optimal code of that depth."""
    hist = np.zeros(256, np.int32)
    a, b = 1, 1
    for s in range(depth + 1):
        hist[s] = a
        a, b = b, a + b
    return hist


def _fuzz_histograms(seed: int, count: int) -> list:
    """Random symbol subsets with counts up to 2^26, many of them tied; totals
    stay below 2^30, where the JAX builder's int32 sums are exact."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        k = int(rng.integers(0, 257))
        top = int(rng.choice([1, 2, 3, 17, 1000, 1 << 16, 1 << 22, 1 << 26]))
        top = max(1, min(top, ((1 << 30) - 1) // max(k, 1)))
        vals = rng.integers(1, top + 1, k)
        if k and rng.random() < 0.4:  # heavy ties: few distinct counts
            vals = rng.choice(vals[: max(1, k // 8)], k)
        hist = np.zeros(256, np.int32)
        hist[rng.choice(256, k, replace=False)] = vals
        out.append(hist)
    return out


class TestCodebook:
    @pytest.mark.parametrize("seed", range(6))
    def test_fuzz_matches_jax_builder(self, seed):
        for hist in _fuzz_histograms(seed, 20):
            lengths, codes = _port_codebook(hist)
            jl, jc = _jax_codebook(hist)
            assert np.array_equal(lengths, jl)
            assert np.array_equal(codes, jc)

    @pytest.mark.parametrize("case", ["empty", "one", "two", "all_equal", "pairs"])
    def test_edge_cases_match_jax_and_host(self, case):
        hist = np.zeros(256, np.int32)
        if case == "one":
            hist[77] = 5
        elif case == "two":
            hist[[3, 200]] = [9, 1]
        elif case == "all_equal":
            hist[:] = 4096
        elif case == "pairs":
            hist[:] = np.repeat(np.arange(1, 129), 2)
        lengths, codes = _port_codebook(hist)
        jl, jc = _jax_codebook(hist)
        assert np.array_equal(lengths, jl) and np.array_equal(codes, jc)
        host = jax_huffman.build_codebook(hist.astype(np.int64), mode="fast")
        assert np.array_equal(lengths, host[0]) and np.array_equal(codes, host[1])

    def test_depth_32_codes_are_canonical(self):
        """At depth 32 the JAX builder's int32 ``code << 1`` wraps; the bits
        still equal the host's canonical codes, and so do the port's."""
        hist = _fibonacci(32)
        lengths, codes = _port_codebook(hist)
        jl, jc = _jax_codebook(hist)
        assert lengths.max() == 32
        assert np.array_equal(lengths, jl) and np.array_equal(codes, jc)
        assert np.array_equal(codes, jax_huffman.canonical_codes_from_lengths(lengths))

    def test_depth_40_lengths_are_exact(self):
        hist = _fibonacci(40)
        lengths, _ = _port_codebook(hist)
        jl, _ = _jax_codebook(hist)
        assert lengths.max() == 40 and np.array_equal(lengths, jl)

    def test_counts_plain_calls_and_checks_its_input(self):
        launches, plain = ops.COUNTERS["codebook"]
        before = (launches.value, plain.value)
        ops.codebook(torch.ones(256, dtype=torch.int32))
        assert (launches.value, plain.value) == (before[0], before[1] + 1)
        with pytest.raises(ValueError):
            ops.codebook(torch.ones(256, dtype=torch.int64))
        with pytest.raises(ValueError):
            ops.codebook(torch.ones(255, dtype=torch.int32))


_PALLAS_CACHE: dict = {}


def _pallas(data: np.ndarray, n: int) -> np.ndarray:
    key = (data.size, n)
    if key not in _PALLAS_CACHE:
        _PALLAS_CACHE[key] = np.asarray(histogram_pallas(
            jnp.asarray(data), jnp.int32(n), rows=64, interpret=True))
    return _PALLAS_CACHE[key]


class TestHistogramVariants:
    @pytest.mark.parametrize("cap,n", [(20_000, 20_000), (20_000, 12_345), (1 << 15, 7)])
    @pytest.mark.parametrize("variant", [*ops.STACKED, *(f"partial-k{k}" for k in ops.PARTIAL_K)])
    def test_plain_path_matches_bincount_and_pallas(self, variant, cap, n):
        data = np.random.default_rng(cap + n).integers(0, 256, cap).astype(np.uint8)
        x = torch.from_numpy(data)
        if variant in ops.STACKED:
            groups, bits = ops.STACKED[variant]
            got = ops.histogram_stacked(x, n, groups, bits)
        else:
            got = ops.histogram_partial(x, n, int(variant.rsplit("k", 1)[1]))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.bincount(data[:n], minlength=256))
        assert np.array_equal(got.numpy(), _pallas(data, n))

    def test_count_plain_calls(self):
        x = torch.zeros(64, dtype=torch.uint8)
        for name, call in (("histogram_stacked", lambda: ops.histogram_stacked(x, 64)),
                           ("histogram_partial", lambda: ops.histogram_partial(x, 64))):
            launches, plain = ops.COUNTERS[name]
            before = (launches.value, plain.value)
            call()
            assert (launches.value, plain.value) == (before[0], before[1] + 1)

    @pytest.mark.parametrize("bad", [
        dict(groups=0), dict(groups=17), dict(counter_bits=12), dict(k=0), dict(k=65)])
    def test_reject_bad_arguments(self, bad):
        x = torch.zeros(64, dtype=torch.uint8)
        with pytest.raises(ValueError):
            if "k" in bad:
                ops.histogram_partial(x, 64, **bad)
            else:
                ops.histogram_stacked(x, 64, **bad)


def _comp(version, **over):
    comp = {"chunk_size_mb": 1, "subblock_symbols": 256, "format_version": version,
            "codebook_mode": "device"}
    comp.update(over)
    return comp


def _port_cfg(version, **over):
    return datacomp_tpu_torch.config.load_config(compression=_comp(version, **over))


def _jax_cfg(version, **over):
    return datacomp_tpu.config.load_config(
        compression=_comp(version, **over), device={"fallback_on_error": False})


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def device_files(tmp_path_factory):
    """text + skewed + random at 1 MiB chunks, compressed in device mode, v1
    and v2, by the port (plain versions), the JAX TPU service on CPU JAX, and
    the host codecs."""
    d = tmp_path_factory.mktemp("device_mode")
    data = (generate_bytes("text", 1 << 20) + generate_bytes("skewed", 1 << 20)
            + generate_bytes("random", 300_000))
    src = str(d / "in.bin")
    with open(src, "wb") as f:
        f.write(data)
    files = {}
    for version in (1, 2):
        for name, make in (
            ("port", lambda: GpuCompressionService(_port_cfg(version), device="cpu")),
            ("tpu", lambda: TpuCompressionService(_jax_cfg(version))),
            ("cpu", lambda: CpuCompressionService(_jax_cfg(version))),
            ("port_cpu", lambda: PortCpuCompressionService(_port_cfg(version))),
        ):
            files[name, version] = str(d / f"{name}{version}.dcz")
            with make() as svc:
                svc.compress(src, files[name, version])
    return d, src, data, files


def test_v2_dcz_identical_to_jax_service(device_files):
    """v2 device mode: uncapped device codes, as in the JAX service; the host
    codecs cap v2 codes, so their files differ."""
    _, _, _, files = device_files
    assert _read(files["port", 2]) == _read(files["tpu", 2])
    header, _ = read_container(files["port", 2])
    depths = [ops.max_code_len(c.code_lengths) for c in header.chunks]
    assert depths == [10, 20, 0]  # the skewed chunk is deeper than K3's tables
    assert _read(files["port", 2]) != _read(files["cpu", 2])
    assert _read(files["port_cpu", 2]) == _read(files["cpu", 2])


def test_v1_dcz_identical_to_jax_service_and_host_codec(device_files):
    _, _, _, files = device_files
    port = _read(files["port", 1])
    assert port == _read(files["tpu", 1])
    assert port == _read(files["cpu", 1])
    assert port == _read(files["port_cpu", 1])


@pytest.mark.parametrize("version", [1, 2])
def test_cross_decode(device_files, version):
    d, _, data, files = device_files
    routes = gpu_service.host_decode_routes.value
    out = str(d / f"port_from_tpu{version}.out")
    with GpuCompressionService(_port_cfg(version), device="cpu") as svc:
        svc.decompress(files["tpu", version], out)
    assert _read(out) == data
    # v1: every chunk decodes on the host; v2: the 20-bit skewed chunk
    assert gpu_service.host_decode_routes.value == routes + (3 if version == 1 else 1)
    out = str(d / f"tpu_from_port{version}.out")
    with TpuCompressionService(_jax_cfg(version)) as svc:
        svc.decompress(files["port", version], out)
    assert _read(out) == data


def test_device_mode_runs_the_three_ops(device_files, tmp_path):
    """Device mode v2 runs histogram, codebook and encode once per coded chunk
    and takes no encode route."""
    _, src, _, files = device_files
    counts = {name: ops.COUNTERS[name][1].value for name in ("histogram", "codebook", "encode")}
    routes = gpu_service.host_encode_routes.value
    out = str(tmp_path / "again.dcz")
    with GpuCompressionService(_port_cfg(2), device="cpu") as svc:
        svc.compress(src, out)
    assert _read(out) == _read(files["port", 2])
    assert ops.COUNTERS["codebook"][1].value == counts["codebook"] + 2
    assert ops.COUNTERS["encode"][1].value == counts["encode"] + 2
    assert ops.COUNTERS["histogram"][1].value >= counts["histogram"] + 2
    assert gpu_service.host_encode_routes.value == routes


def test_cli_round_trip_device_mode(device_files, capsys, monkeypatch):
    d, src, data, files = device_files
    monkeypatch.setenv("DATACOMP_DEVICE_PLATFORM", "cpu")
    dcz, out = str(d / "cli.dcz"), str(d / "cli.out")
    assert cli.main(["compress", src, dcz, "1", "--format", "2",
                     "--codebook-mode", "device"]) == 0
    assert "Verify:     OK" in capsys.readouterr().out
    assert cli.main(["decompress", dcz, out, "1"]) == 0
    assert _read(out) == data
    assert cli.main(["compress", src, dcz, "1", "--format", "1",
                     "--codebook-mode", "device", "--no-verify"]) == 0
    assert _read(dcz) == _read(files["cpu", 1])


@pytest.mark.parametrize("version", [1, 2])
def test_codebook_deeper_than_32_bits_raises_host_error(tmp_path, monkeypatch, version):
    """A device codebook deeper than the format's 32-bit codewords raises the
    host codec's ValueError (the JAX device path would write a corrupt stream)."""
    deep = ops.codebook_reference(torch.from_numpy(_fibonacci(40)))
    monkeypatch.setattr(gpu_service, "codebook", lambda hist: deep)
    with pytest.raises(ValueError) as host:
        jax_huffman.build_code_lengths(_fibonacci(40).astype(np.int64), mode="fast")
    src = tmp_path / "in.bin"
    src.write_bytes(generate_bytes("text", 100_000))
    with GpuCompressionService(_port_cfg(version), device="cpu") as svc:
        with pytest.raises(ValueError) as port:
            svc.compress(str(src), str(tmp_path / "out.dcz"))
    assert str(port.value) == str(host.value)
