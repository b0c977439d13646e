"""The port's dry-run entry points and the service's selection rules, on the
CPU.  ``graft_entry.entry(device="cpu")`` against the root
``__graft_entry__.entry()`` on the same data, ``dryrun_multichip`` over two
``cpu`` entries and without enough cards; the JAX package's
``auto_detect = false`` read as ``force_cpu``, and ``create_frequency_service``;
``fallback_on_error`` off (the default: an injected device error propagates)
and on (refused: the port never redoes a failed operation on the host); and
deep verify, which reads a corrupt chunk as False and lets every other error
propagate.
Everything compared is integers or bytes: exact (tolerance 0).
"""

import json
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import datacomp_tpu.config  # noqa: E402
from datacomp_tpu.utils.testdata import generate_bytes  # noqa: E402
import datacomp_tpu_torch.config  # noqa: E402
from datacomp_tpu_torch import graft_entry  # noqa: E402
from datacomp_tpu_torch.core import CorruptChunkError, container as ct, read_container  # noqa: E402
from datacomp_tpu_torch.ops import _build  # noqa: E402
from datacomp_tpu_torch.services import (  # noqa: E402
    CpuCompressionService, CpuFrequencyService, GpuChunkCodec, GpuCompressionService,
    GpuFrequencyService, create_compression_service, create_frequency_service,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**device):
    return datacomp_tpu_torch.config.load_config(
        compression={"chunk_size_mb": 1, "format_version": 2, "codebook_mode": "fast"},
        device=device)


def test_entry_equals_the_jax_entry():
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__
    finally:
        sys.path.remove(REPO)
    jfn, jargs = __graft_entry__.entry()
    want = [np.asarray(a) for a in jfn(*jargs)]
    fn, args = graft_entry.entry(device="cpu")
    assert args[0].device == torch.device("cpu") and args[1] == int(jargs[1])
    assert np.array_equal(args[0].numpy(), np.asarray(jargs[0]))
    got = fn(*args)
    for name, g, w in zip(("words", "total_bits", "lengths"), got, want):
        assert np.array_equal(g.numpy().astype(np.int64), w.astype(np.int64)), name


def test_dryrun_multichip_on_two_cpu_devices():
    graft_entry.dryrun_multichip(2, device="cpu")


@pytest.mark.parametrize("cards", [0, 1])
def test_dry_runs_need_enough_cards(monkeypatch, cards):
    """No CPU fallback: too few CUDA devices raise before anything runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(RuntimeError, match=f"needs 2 CUDA devices, this process sees {cards}"):
        graft_entry.dryrun_multichip(2)
    if not cards:
        with pytest.raises(RuntimeError, match="needs 1 CUDA devices"):
            graft_entry.entry()


def test_selection_config_keys(monkeypatch, tmp_path):
    """``auto_detect`` and ``fallback_on_error`` are read from the file, the
    environment and overrides as the JAX package reads them.  ``auto_detect
    = false`` selects the host codec, as it does in the JAX package, by
    setting ``force_cpu``; the port's ``fallback_on_error`` defaults to False
    (the JAX package's to True)."""
    load, jload = datacomp_tpu_torch.config.load_config, datacomp_tpu.config.load_config
    cfg = load()
    assert (cfg.device.force_cpu, cfg.device.fallback_on_error) == (False, False)
    assert not hasattr(cfg.device, "auto_detect")
    assert jload().device.fallback_on_error is True
    toml = tmp_path / "datacomp.toml"
    toml.write_text("[datacomp.device]\nauto-detect = false\n")
    assert load(str(toml)).device.force_cpu and not jload(str(toml)).device.auto_detect
    # a later source turns it back on; force_cpu set elsewhere stays set
    assert not load(str(toml), device={"auto_detect": True}).device.force_cpu
    assert load(device={"auto_detect": True, "force_cpu": True}).device.force_cpu
    monkeypatch.setenv("DATACOMP_DEVICE_AUTO_DETECT", "0")
    monkeypatch.setenv("DATACOMP_DEVICE_FALLBACK_ON_ERROR", "1")
    p, j = load(), jload()
    assert (p.device.force_cpu, p.device.fallback_on_error) == (True, True)
    assert (j.device.auto_detect, j.device.fallback_on_error) == (False, True)


def test_auto_detect(monkeypatch):
    """Off: the host codec by choice, with no device touched, unless the
    caller's explicit ``force_cpu=False`` asks for the GPU service.  On: the
    GPU service, which raises without a card (and runs the plain versions
    under ``platform="cpu"``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with create_compression_service(_cfg(auto_detect=False)) as svc:
        assert isinstance(svc, CpuCompressionService)
    with create_compression_service(_cfg(auto_detect=False, platform="cpu"),
                                    force_cpu=False) as svc:
        assert isinstance(svc, GpuCompressionService)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_compression_service(_cfg())
    with create_compression_service(_cfg(platform="cpu")) as svc:
        assert isinstance(svc, GpuCompressionService) and svc.device.type == "cpu"
    with create_compression_service(_cfg(), force_cpu=True) as svc:
        assert isinstance(svc, CpuCompressionService)


def test_create_frequency_service(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert isinstance(create_frequency_service(_cfg(), force_cpu=True), CpuFrequencyService)
    assert isinstance(create_frequency_service(_cfg(force_cpu=True)), CpuFrequencyService)
    svc = create_frequency_service(_cfg(platform="cpu"))
    assert isinstance(svc, GpuFrequencyService) and svc.device.type == "cpu"
    data = np.frombuffer(generate_bytes("skewed", 5000), np.uint8)
    assert np.array_equal(svc.compute_histogram(data), np.bincount(data, minlength=256))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_frequency_service(_cfg())
    monkeypatch.setattr(GpuFrequencyService, "is_available", lambda self: False)
    with pytest.raises(RuntimeError, match="probe"):
        create_frequency_service(_cfg(platform="cpu"))


def test_cli_sharded_honours_auto_detect(tmp_path, monkeypatch, capsys):
    """``--sharded`` with ``auto_detect`` off runs the host codec, as the
    unsharded verbs do: no device is picked (there is none here), no op of
    the port runs, and the file is the host codec's."""
    from datacomp_tpu_torch import cli, ops

    src, dcz, ref, out = (str(tmp_path / f) for f in ("in.bin", "x.dcz", "ref.dcz", "x.out"))
    with open(src, "wb") as f:
        f.write(generate_bytes("text", 3 << 19))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DATACOMP_DEVICE_AUTO_DETECT", "0")
    calls = [c.value for pair in ops.COUNTERS.values() for c in pair]
    args = ["1", "--format", "2", "--codebook-mode", "fast", "--no-verify"]
    assert cli.main(["compress", src, ref, *args]) == 0
    assert cli.main(["compress", src, dcz, *args, "--sharded"]) == 0
    assert cli.main(["decompress", dcz, out, "1", "--sharded"]) == 0
    assert [c.value for pair in ops.COUNTERS.values() for c in pair] == calls
    assert open(dcz, "rb").read() == open(ref, "rb").read()
    assert open(out, "rb").read() == open(src, "rb").read()


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """Two 1 MiB chunks (text, random: stored raw in v2) and a tail."""
    path = tmp_path_factory.mktemp("entry") / "in.bin"
    path.write_bytes(generate_bytes("text", 1 << 20) + generate_bytes("random", 1 << 20)
                     + generate_bytes("skewed", 4321))
    return path


def _fail(*args, **kwargs):
    raise RuntimeError("injected device error")


@pytest.mark.parametrize("op", ["compress", "decompress"])
def test_fallback_on_error_off_propagates(src, tmp_path, monkeypatch, op):
    dcz = str(tmp_path / "x.dcz")
    with CpuCompressionService(_cfg()) as host:
        host.compress(str(src), dcz)
    target = "encode_chunk_batch" if op == "compress" else "decode_chunk_batch"
    monkeypatch.setattr(GpuChunkCodec, target, _fail)
    with GpuCompressionService(_cfg(), device="cpu") as svc:
        assert svc.config.device.fallback_on_error is False
        with pytest.raises(RuntimeError, match="injected device error"):
            if op == "compress":
                svc.compress(str(src), str(tmp_path / "y.dcz"))
            else:
                svc.decompress(dcz, str(tmp_path / "y.out"))


@pytest.mark.parametrize("source", ["override", "environment", "jax template"])
def test_fallback_on_error_on_is_refused(tmp_path, monkeypatch, source):
    """The GPU service refuses a config that asks for the JAX service's host
    redo, however it is set (the JAX package's ``config --init`` template
    sets it), and names ``force_cpu``; the host codec still runs."""
    path = None
    if source == "environment":
        monkeypatch.setenv("DATACOMP_DEVICE_FALLBACK_ON_ERROR", "true")
    elif source == "jax template":
        from datacomp_tpu import cli as jcli

        path = tmp_path / "datacomp.toml"
        path.write_text(jcli.TEMPLATE_TOML)
    cfg = datacomp_tpu_torch.config.load_config(
        str(path) if path else None,
        device={"fallback_on_error": True} if source == "override" else {})
    assert cfg.device.fallback_on_error is True
    for make in (lambda: GpuCompressionService(cfg, device="cpu"),
                 lambda: create_compression_service(cfg, force_cpu=False)):
        with pytest.raises(ValueError, match="fallback-on-error = true is not supported.*force-cpu"):
            make()
    with create_compression_service(cfg, force_cpu=True) as svc:
        assert isinstance(svc, CpuCompressionService)


@pytest.fixture(scope="module")
def dczs(src, tmp_path_factory):
    """The file in java v1 and fast v2 by the host codec."""
    d = tmp_path_factory.mktemp("verify")
    out = {}
    for version, mode in ((1, "java"), (2, "fast")):
        cfg = datacomp_tpu_torch.config.load_config(
            compression={"chunk_size_mb": 1, "format_version": version, "codebook_mode": mode})
        out[version] = str(d / f"v{version}.dcz")
        with CpuCompressionService(cfg) as svc:
            svc.compress(str(src), out[version])
    return out


def _services(version: int):
    cfg = datacomp_tpu_torch.config.load_config(
        compression={"chunk_size_mb": 1, "format_version": version})
    return [CpuCompressionService(cfg), GpuCompressionService(cfg, device="cpu")]


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("damage", ["none", "payload bit", "truncated", "code lengths"])
def test_deep_verify_reads_a_corrupt_file_as_false(dczs, tmp_path, version, damage):
    """Every service reads a damaged payload, a truncated file or a
    code-length table that is no prefix code as a corrupt file."""
    raw = bytearray(open(dczs[version], "rb").read())
    header, data_start = read_container(dczs[version])
    if damage == "payload bit":
        raw[data_start + 1000] ^= 0x10
    elif damage == "truncated":
        raw = raw[: len(raw) // 2]
    elif damage == "code lengths":  # every symbol one bit: over-subscribed
        header.chunks[0].code_lengths = np.ones(256, np.int32)
        raw = raw[: data_start + header.total_compressed_size()]
        raw += ct.serialize_footer(header)
        raw += int(data_start + header.total_compressed_size()).to_bytes(8, "big")
    path = tmp_path / "damaged.dcz"
    path.write_bytes(bytes(raw))
    for svc in _services(version):
        with svc:
            assert svc.verify_integrity(str(path), deep=True) is (damage == "none"), svc


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("decoder", ["native", "python", "gpu codec"])
def test_decoders_raise_corrupt_chunk_error(dczs, monkeypatch, version, decoder):
    """Each decoder raises ``CorruptChunkError`` on a code-length table that
    is no prefix code (the GPU codec decodes v2 on the device, and sends v1
    to the host codec), and the native decoder on a stream cut short (the
    Python decoder and K3's plain version read zeros past the end, a valid
    code, and leave the damage to the SHA-256 check)."""
    from datacomp_tpu_torch import native
    from datacomp_tpu_torch.models import StageMetrics

    if decoder == "native" and not native.is_available():
        pytest.skip("the native host codec did not build")
    if decoder == "python":
        monkeypatch.setattr(native, "is_available", lambda: False)
    header, data_start = read_container(dczs[version])
    meta = header.chunks[0]
    payload = open(dczs[version], "rb").read()[data_start : data_start + meta.compressed_size]
    cfg = datacomp_tpu_torch.config.load_config(
        compression={"chunk_size_mb": 1, "format_version": version})
    svc = (GpuCompressionService(cfg, device="cpu") if decoder == "gpu codec"
           else CpuCompressionService(cfg))
    with svc:
        codec = svc._pipeline.codec
        if decoder == "native":
            with pytest.raises(CorruptChunkError):
                codec.decode_chunk(payload[:16], meta, header, StageMetrics())
        meta.code_lengths = np.ones(256, np.int32)
        with pytest.raises(CorruptChunkError, match="code-length table"):
            codec.decode_chunk(payload, meta, header, StageMetrics())


@pytest.mark.parametrize("error,corrupt", [
    (CorruptChunkError("invalid Huffman code at bit 3"), True),
    (ValueError("tensors lie on several devices: ['cpu', 'cuda:0']"), False),
    (OSError("short read"), False),
    (RuntimeError("decode: CUDA error 700 (an illegal memory access)"), False),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), False),
])
def test_deep_verify_lets_device_errors_propagate(dczs, monkeypatch, error, corrupt):
    """The decoders' data errors (``CorruptChunkError``) read as a corrupt
    file; a CUDA error, a wrapper's ``RuntimeError`` or ``ValueError`` (its
    device and shape checks) and an I/O error propagate."""
    def decode_chunk(self, payload, meta, header, metrics):
        raise error

    monkeypatch.setattr(GpuChunkCodec, "decode_chunk", decode_chunk)
    with GpuCompressionService(_cfg(), device="cpu") as svc:
        if corrupt:
            assert svc.verify_integrity(dczs[2], deep=True) is False
        else:
            with pytest.raises(type(error)):
                svc.verify_integrity(dczs[2], deep=True)


def test_kernel_library_that_does_not_load_raises_runtime_error(tmp_path, monkeypatch):
    """A failed build or load of the kernels is a ``RuntimeError``, never an
    ``OSError`` that deep verify would read as a corrupt file."""
    lib = tmp_path / "libdcz_kernels.so"
    lib.write_bytes(b"not a library")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "library_path", lambda: str(lib))
    with pytest.raises(RuntimeError, match="did not build or load"):
        _build.library()


def test_ab_cli_on_the_plain_versions(monkeypatch):
    """``tools.ab_cli`` of this checkout against itself on the plain
    versions, one pair at 4 MB: every turn runs its side's package, every
    file is restored and equal across turns, and the summary holds each
    rate; without a card the tool refuses."""
    from datacomp_tpu_torch.tools import ab_cli

    lines = []
    monkeypatch.setenv("DATACOMP_DEVICE_PLATFORM", "cpu")
    summary = ab_cli.run(REPO, pairs=1, corpus_mb=4, emit=lines.append)
    turns = [json.loads(line) for line in lines[:-1]]
    assert [t["side"] for t in turns] == ["parent", "this"]
    assert {t["package"] for t in turns} == {os.path.join(REPO, "datacomp_tpu_torch")}
    assert summary["ok"] and json.loads(lines[-1]) == summary
    for mode in ab_cli.MODES:
        for rate in ab_cli.RATES:
            assert summary[f"{mode} {rate}"]["parent_median"] > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ab_cli.main(["--checkout", REPO]) == 1
