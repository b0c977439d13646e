"""Batched chunks in the port, on the CPU: the batched entry points of K1,
K4, K2 and K3 (``ops.*_batch``, here their plain versions) against today's
per-chunk plain versions row by row and against the JAX package's batched
functions on CPU JAX, and ``GpuCompressionService`` at ``batch_chunks=4``
(``device="cpu"``) against itself at 1 and against the JAX service's batched
path.  Inputs are made from seeds; everything compared is integers or bytes,
so every comparison is exact (tolerance 0).  The CUDA kernels are held to
these plain versions on the card (``tests/test_torch_gpu.py``).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import datacomp_tpu.config  # noqa: E402
import datacomp_tpu_torch.config  # noqa: E402
from datacomp_tpu.core.huffman import build_codebook  # noqa: E402
from datacomp_tpu.ops import codebook as jax_codebook  # noqa: E402
from datacomp_tpu.ops import decode as jax_decode  # noqa: E402
from datacomp_tpu.ops import histogram_device  # noqa: E402
from datacomp_tpu.ops.encode_merge import encode_device_merge_batch_slotted  # noqa: E402
from datacomp_tpu.services.tpu_service import TpuChunkCodec, TpuCompressionService  # noqa: E402
from datacomp_tpu.utils.testdata import generate_bytes  # noqa: E402
from datacomp_tpu_torch import ops  # noqa: E402
from datacomp_tpu_torch.core import read_container  # noqa: E402
from datacomp_tpu_torch.models import StageMetrics  # noqa: E402
from datacomp_tpu_torch.services import (  # noqa: E402
    CpuCompressionService, GpuCompressionService, gpu_service,
)
from datacomp_tpu_torch.services import pipeline  # noqa: E402

ROW = 1 << 16  # the kernels' rows: 64 KiB
S = 256  # sub-block symbols in every test here
KINDS = ("text", "skewed", "compressible", "zeros", "random")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows(rows: int):
    """``rows`` 64 KiB chunks (the kinds in turn) with ragged valid lengths:
    the whole row, n - 12345, 17, 0 and 1000 + 7 in turn."""
    edges = (ROW, ROW - 12_345, 17, 0, 1007)
    data = np.stack([np.frombuffer(generate_bytes(KINDS[b % 5], ROW, seed=b), np.uint8)
                     for b in range(rows)])
    return data, [edges[b % 5] for b in range(rows)]


def _host_books(data, valid):
    """Host ``fast`` codebooks capped at 16 bits, one a row, as the encoder's
    int32/uint32[rows, 256] tensors."""
    books = [build_codebook(np.bincount(row[:v], minlength=256), mode="fast", max_len=16)
             for row, v in zip(data, valid)]
    return (_t(np.stack([b[0] for b in books]).astype(np.int32)),
            _t(np.stack([b[1] for b in books]).astype(np.uint32)))


def _encoded_rows(data, valid):
    """Each row encoded with its capped host codebook: (streams as
    ``payload_to_words``, gap arrays, lengths)."""
    lens, codes = _host_books(data, valid)
    out_words = (9 * ROW + 31) // 32 + 2
    words, totals, gaps = ops.encode_batch(_t(data), valid, lens, codes, out_words, S)
    streams, gap_rows = [], []
    for b, v in enumerate(valid):
        tb = int(totals[b])
        payload = ops.words_to_bytes(words[b, : (tb + 31) // 32].numpy(), tb)
        streams.append(ops.payload_to_words(payload))
        gap_rows.append(gaps[b, : -(-v // S)].numpy())
    return streams, gap_rows, lens.numpy()


@pytest.mark.parametrize("rows", [1, 2, 3, 5])
@pytest.mark.parametrize("kernel", ["histogram", "codebook", "encode", "decode"])
def test_batched_plain_matches_per_chunk_plain(kernel, rows):
    data, valid = _rows(rows)
    x = _t(data)
    if kernel == "histogram":
        got = ops.histogram_batch(x, valid)
        for b, v in enumerate(valid):
            assert torch.equal(got[b], ops.histogram_reference(x[b], v))
    elif kernel == "codebook":
        hist = ops.histogram_batch(x, valid)
        lens, codes = ops.codebook_batch(hist)
        for b in range(rows):
            rl, rc = ops.codebook_reference(hist[b])
            assert torch.equal(lens[b], rl) and torch.equal(codes[b], rc)
    elif kernel == "encode":
        lens, codes = _host_books(data, valid)
        out_words = (9 * ROW + 31) // 32 + 2
        words, totals, gaps = ops.encode_batch(x, valid, lens, codes, out_words, S)
        for b, v in enumerate(valid):
            rw, rtb, rg = ops.encode_reference(x[b], v, lens[b], codes[b], out_words, S)
            assert torch.equal(words[b], rw) and int(totals[b]) == int(rtb)
            assert torch.equal(gaps[b], rg)
    else:
        streams, gap_rows, lengths = _encoded_rows(data, valid)
        tables = [ops.build_decode_tables(ln) for ln in lengths]
        lim, adj, sym = (_t(np.stack([t[k] for t in tables])) for k in range(3))
        word_off = np.cumsum([0] + [w.size for w in streams]).tolist()
        gap_off = np.cumsum([0] + [g.size for g in gap_rows]).tolist()
        w, g = _t(np.concatenate(streams)), _t(np.concatenate(gap_rows).astype(np.uint32))
        out = ops.decode_batch(w, word_off, g, gap_off, lim, adj, sym, S, valid)
        assert out.numel() == sum(valid)
        at = 0
        for b, v in enumerate(valid):
            one = ops.decode_reference(_t(streams[b]), _t(gap_rows[b].astype(np.uint32)),
                                       lim[b], adj[b], sym[b], S, v)
            assert torch.equal(out[at : at + v], one)
            assert np.array_equal(one.numpy(), data[b, :v])
            at += v


def test_batched_plain_counts_and_checks():
    data, valid = _rows(2)
    before = ops.COUNTERS["histogram_batch"][1].value
    ops.histogram_batch(_t(data), valid)
    assert ops.COUNTERS["histogram_batch"][1].value == before + 1  # one call, not one a row
    with pytest.raises(ValueError, match="valid_len"):
        ops.histogram_batch(_t(data), [ROW + 1, 0])
    with pytest.raises(ValueError, match="valid lengths"):
        ops.histogram_batch(_t(data), [0])
    with pytest.raises(ValueError, match="rows"):
        ops.histogram_batch(torch.zeros((ops.MAX_ROWS + 1, 32), dtype=torch.uint8),
                            [0] * (ops.MAX_ROWS + 1))
    with pytest.raises(ValueError, match="offsets"):
        ops.decode_batch(torch.zeros(4, dtype=torch.uint32), [0, 3],
                         torch.zeros(1, dtype=torch.uint32), [0, 1],
                         *(torch.zeros((1, k), dtype=torch.int32) for k in (16, 16, 256)),
                         S, [1])


def test_batched_encode_matches_jax_batch_slotted():
    data, valid = _rows(3)
    lens, codes = ops.codebook_batch(ops.histogram_batch(_t(data), valid))
    out_words = (9 * ROW + 31) // 32 + 2
    words, totals, gaps = ops.encode_batch(_t(data), valid, lens, codes, out_words, S)
    jw, jt, jg = encode_device_merge_batch_slotted(
        jnp.asarray(data), jnp.asarray(np.array(valid, np.int32)), jnp.asarray(lens.numpy()),
        jnp.asarray(codes.numpy()), out_words, S)
    assert np.array_equal(words.numpy(), np.asarray(jw))
    assert np.array_equal(totals.numpy(), np.asarray(jt))
    assert np.array_equal(gaps.numpy(), np.asarray(jg))


def test_batched_histogram_and_codebook_match_jax_vmap():
    data, valid = _rows(5)
    hist = ops.histogram_batch(_t(data), valid)
    lens, codes = ops.codebook_batch(hist)
    jl, jc = jax.vmap(lambda d, v: jax_codebook.device_codebook(histogram_device(d, v)))(
        jnp.asarray(data), jnp.asarray(np.array(valid, np.int32)))
    assert np.array_equal(lens.numpy(), np.asarray(jl))
    assert np.array_equal(codes.numpy(), np.asarray(jc))


def test_batched_decode_matches_jax_vmapped_decoder():
    """Batched K3 against ``jax.vmap(decode_device)`` as
    ``TpuChunkCodec._batched_decoder`` builds it: one word width, sub-block
    count and depth bucket for the group (the deepest member's)."""
    data, valid = _rows(3)
    streams, gap_rows, lengths = _encoded_rows(data, valid)
    tables = [ops.build_decode_tables(ln) for ln in lengths]
    lim, adj, sym = (np.stack([t[k] for t in tables]) for k in range(3))
    word_off = np.cumsum([0] + [w.size for w in streams]).tolist()
    gap_off = np.cumsum([0] + [g.size for g in gap_rows]).tolist()
    got = ops.decode_batch(_t(np.concatenate(streams)), word_off,
                           _t(np.concatenate(gap_rows).astype(np.uint32)), gap_off,
                           _t(lim), _t(adj), _t(sym), S, valid).numpy()

    nsub, padded = ROW // S, max(w.size for w in streams)
    ml = max(ops.max_code_len(ln) for ln in lengths)
    codec = TpuChunkCodec(datacomp_tpu.config.load_config(
        compression={"chunk_size_mb": 1, "format_version": 2, "subblock_symbols": S}))
    fn = codec._batched_decoder(len(valid), padded, nsub, S,
                                jax_decode.syms_per_refill(ml, S, jax_decode.DEFAULT_REFILL_WORDS),
                                jax_decode.cmp_len_bucket(ml))
    wpad = np.zeros((len(valid), padded), np.uint32)
    gpad = np.zeros((len(valid), nsub), np.uint32)
    for b, (w, g) in enumerate(zip(streams, gap_rows)):
        wpad[b, : w.size] = w
        gpad[b, : g.size] = g
    want = np.asarray(fn(wpad, gpad, lim, adj, sym))
    assert np.array_equal(got, np.concatenate([want[b, :v] for b, v in enumerate(valid)]))


def _port_cfg(batch: int, **comp):
    return datacomp_tpu_torch.config.load_config(
        compression={"chunk_size_mb": 1, "subblock_symbols": S, **comp},
        device={"batch_chunks": batch})


@pytest.fixture(scope="module")
def six_chunks(tmp_path_factory):
    """5 MiB + 321 bytes of text: 1 MiB chunks in a group of 4 and a tail
    group of 2 (``tests/test_tpu_service.py``'s batched case)."""
    d = tmp_path_factory.mktemp("batch")
    data = generate_bytes("text", 5 * (1 << 20) + 321)
    src = d / "six.bin"
    src.write_bytes(data)
    return d, str(src), data


@pytest.mark.parametrize("version,mode", [(1, "java"), (2, "fast"), (2, "device"), (1, "device")])
def test_batched_dcz_equals_unbatched(six_chunks, version, mode):
    d, src, data = six_chunks
    files = {}
    for batch in (1, 4):
        files[batch] = str(d / f"{version}{mode}{batch}.dcz")
        before = ops.COUNTERS["encode_batch"][1].value
        with GpuCompressionService(_port_cfg(batch, format_version=version,
                                             codebook_mode=mode), device="cpu") as svc:
            assert svc._codec.batch_chunks == batch
            svc.compress(src, files[batch])
        # six coded chunks: groups of four and two, or six groups of one
        assert ops.COUNTERS["encode_batch"][1].value == before + (2 if batch == 4 else 6)
    with open(files[1], "rb") as f, open(files[4], "rb") as g:
        assert f.read() == g.read()
    out = str(d / "back.out")
    with GpuCompressionService(_port_cfg(4, format_version=version), device="cpu") as svc:
        svc.decompress(files[4], out)
    with open(out, "rb") as f:
        assert f.read() == data


def test_batched_device_v2_equals_jax_batched_service(six_chunks):
    d, src, _ = six_chunks
    comp = {"chunk_size_mb": 1, "subblock_symbols": S, "format_version": 2,
            "codebook_mode": "device"}
    port, ref = str(d / "port4.dcz"), str(d / "jax4.dcz")
    with GpuCompressionService(_port_cfg(4, **{k: comp[k] for k in ("format_version",
                                                                   "codebook_mode")}),
                               device="cpu") as svc:
        svc.compress(src, port)
    jcfg = datacomp_tpu.config.load_config(
        compression=comp, device={"batch_chunks": 4, "fallback_on_error": False})
    with TpuCompressionService(jcfg) as svc:
        assert svc._codec.batch_chunks == 4
        svc.compress(src, ref)
    with open(port, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()


@pytest.fixture(scope="module")
def one_and_four(tmp_path_factory):
    """A file of one chunk (700,000 bytes of text) and one of four: text,
    random (stored raw in v2), skewed and a ragged tail."""
    d = tmp_path_factory.mktemp("one_path")
    srcs = {1: d / "one.bin", 4: d / "four.bin"}
    srcs[1].write_bytes(generate_bytes("text", 700_000, seed=5))
    srcs[4].write_bytes(b"".join(generate_bytes(kind, n) for kind, n in (
        ("text", 1 << 20), ("random", 1 << 20), ("skewed", 1 << 20), ("compressible", 12_345))))
    return d, srcs


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("version,mode", [(1, "java"), (2, "fast"), (2, "device")])
def test_a_lone_chunk_and_a_group_take_one_path(one_and_four, version, mode, chunks):
    """At ``batch_chunks`` 4 a file of one chunk and one of four run the
    batched ops alone, one call each a group: the unbatched encode, decode
    and codebook never run, and the histogram only for the availability
    probe.  Each ``.dcz`` is the reference's: the host codec's with a host
    codebook, the JAX service's with the device's."""
    d, srcs = one_and_four
    src = str(srcs[chunks])
    dcz, ref, out = (str(d / f"{version}{mode}{chunks}.{ext}") for ext in ("dcz", "ref", "out"))
    before = {name: [c.value for c in pair] for name, pair in ops.COUNTERS.items()}
    with GpuCompressionService(_port_cfg(4, format_version=version, codebook_mode=mode),
                               device="cpu") as svc:
        assert svc.is_available()
        svc.compress(src, dcz)
        svc.decompress(dcz, out)
    calls = {name: [c.value - b for c, b in zip(pair, before[name])]
             for name, pair in ops.COUNTERS.items()}
    assert {name: calls[name] for name in ("histogram", "encode", "decode", "codebook")} == {
        "histogram": [0, 1], "encode": [0, 0], "decode": [0, 0], "codebook": [0, 0]}
    assert calls["encode_batch"] == [0, 1] and calls["decode_batch"] == [0, 1]
    with open(src, "rb") as f, open(out, "rb") as g:
        assert f.read() == g.read()
    if mode == "device":
        jcfg = datacomp_tpu.config.load_config(
            compression={"chunk_size_mb": 1, "subblock_symbols": S, "format_version": 2,
                         "codebook_mode": "device"},
            device={"batch_chunks": 4, "fallback_on_error": False})
        with TpuCompressionService(jcfg) as svc:
            svc.compress(src, ref)
    else:
        with CpuCompressionService(_port_cfg(4, format_version=version,
                                             codebook_mode=mode)) as svc:
            svc.compress(src, ref)
    with open(dcz, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()


def _mixed_container(tmp_path):
    """text, random (stored raw), a Fibonacci-skewed chunk whose capped-at-32
    code is deeper than 16 bits, and a short compressible tail."""
    f = np.zeros(24, np.int64)
    a, b = 1, 1
    for s in range(24):
        f[s] = 8 * a
        a, b = b, a + b
    deep = np.repeat(np.arange(24, dtype=np.uint8), f)
    deep = np.concatenate([deep, np.full((1 << 20) - deep.size, 23, np.uint8)])
    data = (generate_bytes("text", 1 << 20) + generate_bytes("random", 1 << 20)
            + deep.tobytes() + generate_bytes("compressible", 512 * 1024 + 77))
    src = tmp_path / "mixed.bin"
    src.write_bytes(data)
    dcz = str(tmp_path / "mixed.dcz")
    cfg = _port_cfg(4, format_version=2, codebook_mode="fast", max_code_len=32)
    with GpuCompressionService(cfg, device="cpu") as svc:
        svc.compress(str(src), dcz)
    return cfg, dcz, data


def test_mixed_raw_store_group_round_trips(tmp_path):
    cfg, dcz, data = _mixed_container(tmp_path)
    header, _ = read_container(dcz)
    depths = [ops.max_code_len(c.code_lengths) for c in header.chunks]
    assert depths[1] == 0 and depths[2] > 16 and 0 < depths[0] <= 16 and 0 < depths[3] <= 16
    before = ops.COUNTERS["decode_batch"][1].value
    with GpuCompressionService(cfg, device="cpu") as svc:
        svc.decompress(dcz, str(tmp_path / "mixed.out"))
    assert (tmp_path / "mixed.out").read_bytes() == data
    assert ops.COUNTERS["decode_batch"][1].value == before + 1  # chunks 0 and 3


def test_decode_chunk_batch_equals_decode_chunk(tmp_path):
    cfg, dcz, data = _mixed_container(tmp_path)
    header, data_start = read_container(dcz)
    with open(dcz, "rb") as f:
        payloads = [(f.seek(data_start + m.compressed_offset), f.read(m.compressed_size))[1]
                    for m in header.chunks]
    codec = gpu_service.GpuChunkCodec(cfg, torch.device("cpu"))
    routes = gpu_service.host_decode_routes.value
    batch = codec.decode_chunk_batch(payloads, header.chunks, header, StageMetrics())
    assert gpu_service.host_decode_routes.value == routes + 1  # the deep chunk
    for m, out in zip(header.chunks, batch):
        assert np.array_equal(out, codec.decode_chunk(payloads[m.index], m, header,
                                                      StageMetrics()))
    assert b"".join(np.asarray(o).tobytes() for o in batch) == data


def test_resume_through_batched_path_equals_one_shot(six_chunks, tmp_path):
    _, src, _ = six_chunks
    cfg = _port_cfg(4, format_version=2, codebook_mode="device")
    one_shot = str(tmp_path / "one.dcz")
    with GpuCompressionService(cfg, device="cpu") as svc:
        svc.compress(src, one_shot)
    with open(one_shot, "rb") as f:
        full = f.read()
    h, _ = read_container(one_shot)
    dcz = str(tmp_path / "resumed.dcz")
    with open(dcz + pipeline.PARTIAL_SUFFIX, "wb") as f:
        pipeline._write_partial_header(f, h)
        for c in h.chunks[:2]:
            pipeline._append_partial_chunk(f, c)
    with open(dcz, "wb") as f:
        f.write(full[: h.chunks[1].compressed_offset + h.chunks[1].compressed_size])
    before = ops.COUNTERS["encode_batch"][1].value
    with GpuCompressionService(cfg, device="cpu") as svc:
        svc.resume_compression(src, dcz, last_completed_chunk=1)
    assert ops.COUNTERS["encode_batch"][1].value == before + 1  # chunks 2-5, one group
    assert not os.path.exists(dcz + pipeline.PARTIAL_SUFFIX)
    with open(dcz, "rb") as f:
        assert f.read() == full


def test_v1_device_batch_deeper_than_32_bits_raises_host_error(tmp_path, monkeypatch):
    """A member whose device codebook is deeper than 32 bits raises the host
    codec's ValueError before the batched encode runs."""
    f = np.zeros(256, np.int32)
    a, b = 1, 1
    for s in range(41):  # Fibonacci counts: an optimal code 40 bits deep
        f[s] = a
        a, b = b, a + b
    deep_l, deep_c = ops.codebook_reference(torch.from_numpy(f))

    def deep_second(hist):
        lens, codes = ops.codebook_batch_reference(hist)
        lens[1], codes[1] = deep_l, deep_c
        return lens, codes

    monkeypatch.setattr(gpu_service, "codebook_batch", deep_second)
    src = tmp_path / "in.bin"
    src.write_bytes(generate_bytes("text", 3 << 20))
    before = ops.COUNTERS["encode_batch"][1].value
    with GpuCompressionService(_port_cfg(4, format_version=1, codebook_mode="device"),
                               device="cpu") as svc:
        with pytest.raises(ValueError, match="exceeds 32 bits"):
            svc.compress(str(src), str(tmp_path / "out.dcz"))
    assert ops.COUNTERS["encode_batch"][1].value == before


def test_auto_batch_rule():
    assert gpu_service.resolve_batch_chunks(0, "cpu") == 1
    assert gpu_service.resolve_batch_chunks(0, "cuda") == 4
    assert gpu_service.resolve_batch_chunks(3, "cpu") == 3
    with GpuCompressionService(_port_cfg(0), device="cpu") as svc:
        assert svc._codec.batch_chunks == 1


@pytest.mark.parametrize("batch", [-1, 17])
def test_batch_chunks_outside_0_to_16_is_refused(batch):
    with pytest.raises(ValueError, match="batch-chunks") as port:
        datacomp_tpu_torch.config.load_config(device={"batch_chunks": batch})
    with pytest.raises(ValueError, match="batch-chunks") as ref:
        datacomp_tpu.config.load_config(device={"batch_chunks": batch})
    assert str(port.value) == str(ref.value)
