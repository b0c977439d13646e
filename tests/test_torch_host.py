"""The port's host layers against the JAX package's, which they copy: the same
codebooks, bitstreams, containers, native codec results, test data and config,
and the same ``.dcz`` bytes from the host codec (``CpuCompressionService``),
including a resumed compress.  Exact equality throughout: the outputs are
integers and bytes."""

import os

import numpy as np
import pytest

import datacomp_tpu.config as jconfig
import datacomp_tpu.core as jcore
import datacomp_tpu.native as jnative
import datacomp_tpu.services.cpu_service as jcpu
import datacomp_tpu.services.pipeline as jpipeline
import datacomp_tpu.utils.testdata as jtestdata
import datacomp_tpu_torch.config as pconfig
import datacomp_tpu_torch.core as pcore
import datacomp_tpu_torch.native as pnative
import datacomp_tpu_torch.services.cpu_service as pcpu
import datacomp_tpu_torch.services.pipeline as ppipeline
import datacomp_tpu_torch.utils.testdata as ptestdata


def histogram(seed: int, alphabet: int) -> np.ndarray:
    """Skewed counts over ``alphabet`` random symbols, with ties."""
    rng = np.random.default_rng(seed)
    h = np.zeros(256, np.int64)
    syms = rng.choice(256, alphabet, replace=False)
    h[syms] = rng.geometric(0.02, alphabet) + rng.integers(0, 3, alphabet)
    h[syms[: alphabet // 4]] *= 1000
    return h


@pytest.mark.parametrize("mode", ["java", "fast"])
@pytest.mark.parametrize("max_len", [0, -1, 9])
@pytest.mark.parametrize("seed,alphabet", [(0, 1), (1, 2), (2, 40), (3, 256)])
def test_codebooks_identical(mode, max_len, seed, alphabet):
    h = histogram(seed, alphabet)
    jl, jc = jcore.build_codebook(h, mode=mode, max_len=max_len)
    pl, pc = pcore.build_codebook(h, mode=mode, max_len=max_len)
    assert np.array_equal(jl, pl) and np.array_equal(jc, pc)
    assert pcore.validate_lengths(pl) == jcore.validate_lengths(jl)


@pytest.mark.parametrize("kind", ["random", "compressible", "text", "zeros", "skewed"])
def test_test_data_identical(kind):
    for n in (0, 1, 4099):
        assert ptestdata.generate_bytes(kind, n) == jtestdata.generate_bytes(kind, n)


@pytest.mark.parametrize("kind", ["text", "skewed"])
def test_bitstreams_and_native_codec_identical(kind):
    data = np.frombuffer(jtestdata.generate_bytes(kind, 50_000), np.uint8)
    assert np.array_equal(pnative.histogram(data), jnative.histogram(data))
    lengths, codes = jcore.build_codebook(jnative.histogram(data), mode="fast")
    assert pcore.encode_bitstream(data, lengths, codes) == jcore.encode_bitstream(
        data, lengths, codes)
    assert pnative.is_available() == jnative.is_available()
    if not jnative.is_available():
        return
    jp, jg = jnative.encode(data, lengths, codes, subblock=512)
    pp, pg = pnative.encode(data, lengths, codes, subblock=512)
    assert bytes(pp) == bytes(jp) and np.array_equal(pg, jg)
    back = pnative.decode_gaps(bytes(pp), data.size, lengths, pg, 512)
    assert np.array_equal(back, data)
    assert np.array_equal(pnative.decode(bytes(pp), data.size, lengths), data)


def test_config_identical(monkeypatch):
    monkeypatch.setenv("DATACOMP_COMPRESSION_MAX_CODE_LEN", "auto")
    monkeypatch.setenv("DATACOMP_COMPRESSION_CHUNK_SIZE_MB", "2")
    over = {"format_version": 2, "codebook_mode": "fast", "subblock_symbols": 512}
    j = jconfig.load_config(compression=over)
    p = pconfig.load_config(compression=over)
    assert vars(p.compression) == {k: getattr(j.compression, k) for k in vars(p.compression)}
    assert p.chunk_size_bytes == j.chunk_size_bytes == 2 << 20
    assert p.compression.effective_max_code_len() == -1
    with pytest.raises(ValueError, match="subblock-symbols"):
        pconfig.load_config(compression={"format_version": 2, "subblock_symbols": 100})


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """1 MiB chunks of text, skewed, random (stored raw in v2) and a short
    text tail."""
    d = tmp_path_factory.mktemp("host")
    data = b"".join(jtestdata.generate_bytes(k, 1 << 20) for k in
                    ("text", "skewed", "random")) + \
        jtestdata.generate_bytes("text", 1000, seed=7)
    src = d / "in.bin"
    src.write_bytes(data)
    return d, str(src), data


@pytest.mark.parametrize("version,mode", [(1, "java"), (2, "fast"), (2, "java")])
def test_host_codec_dcz_identical(source, version, mode):
    d, src, data = source
    comp = {"chunk_size_mb": 1, "format_version": version, "codebook_mode": mode}
    j, p = (str(d / f"{name}{version}{mode}.dcz") for name in ("j", "p"))
    with jcpu.CpuCompressionService(jconfig.load_config(compression=comp)) as svc:
        svc.compress(src, j)
    with pcpu.CpuCompressionService(pconfig.load_config(compression=comp)) as svc:
        svc.compress(src, p)
        assert svc.verify_integrity(p, deep=True)
        svc.decompress(j, str(d / "p.out"))  # the port reads the JAX package's file
    with open(j, "rb") as f, open(p, "rb") as g:
        assert f.read() == g.read()
    with open(d / "p.out", "rb") as f:
        assert f.read() == data
    jh, _ = jcore.read_container(j)
    ph, _ = pcore.read_container(p)
    assert pcore.serialize_footer(ph) == jcore.serialize_footer(jh)


def test_resumed_compress_identical(tmp_path):
    """A compress cut after two chunks and resumed writes the one-shot bytes
    (the port's pipeline copies the JAX package's, batching hooks included)."""
    data = jtestdata.generate_bytes("text", 4 << 20)
    src = tmp_path / "r.bin"
    src.write_bytes(data)
    comp = {"chunk_size_mb": 1, "format_version": 2, "codebook_mode": "fast"}
    one_shot = str(tmp_path / "j.dcz")
    with jcpu.CpuCompressionService(jconfig.load_config(compression=comp)) as svc:
        svc.compress(str(src), one_shot)
    with open(one_shot, "rb") as f:
        full = f.read()
    h, _ = pcore.read_container(one_shot)
    dcz = str(tmp_path / "p.dcz")
    with open(dcz + ppipeline.PARTIAL_SUFFIX, "wb") as f:
        ppipeline._write_partial_header(f, h)
        for c in h.chunks[:2]:
            ppipeline._append_partial_chunk(f, c)
    with open(dcz, "wb") as f:
        f.write(full[: h.chunks[1].compressed_offset + h.chunks[1].compressed_size])
    with pcpu.CpuCompressionService(pconfig.load_config(compression=comp)) as svc:
        svc.resume_compression(str(src), dcz, last_completed_chunk=1)
    assert not os.path.exists(dcz + ppipeline.PARTIAL_SUFFIX)
    with open(dcz, "rb") as f:
        assert f.read() == full
    assert ppipeline.PARTIAL_MAGIC == jpipeline.PARTIAL_MAGIC
