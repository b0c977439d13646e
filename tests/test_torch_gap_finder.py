"""K5, the gap finder, on the CPU: its plain version, and format-1 restores
through it.

The plain version (``ops.find_gaps`` on CPU tensors) is held to the gap
arrays that format 2 stores: streams written by the port's plain K2 and by
the JAX package's ``encode_device_merge``, over every generator of
``dczbench.corpus``, chain codes of depth 1 to 16, fixed-length codes (the
gcd of the lengths above 1), a one-symbol stream, ``n_out`` below the
sub-block and not a multiple of it, and rows of 0 and 17 bytes in one
batch.  Its end is the stream's total bits.  On garbage it follows the one
parse a symbol-by-symbol walk of the decoder's formula gives, past the
stream's end too.

``GpuCompressionService(device="cpu")`` restores format-1 files of every
codebook mode byte for byte at ``batch_chunks`` 1 and 4 through the gap
finder and the batched K3, with no host route; a chunk deeper than 16 bits
still takes the counted host route under a ``host_decode`` span.  A flipped
stored digest is refused, and a stream that ends past its payload raises
``CorruptChunkError``.  Everything compared is integers or bytes: every
comparison is exact.  The kernel is held to this plain version on the card
(``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from datacomp_tpu.ops.encode_merge import encode_device_merge  # noqa: E402
from datacomp_tpu_torch import ops  # noqa: E402
from datacomp_tpu_torch.config import load_config  # noqa: E402
from datacomp_tpu_torch.core import huffman, read_container  # noqa: E402
from datacomp_tpu_torch.core.huffman import CorruptChunkError  # noqa: E402
from datacomp_tpu_torch.models import StageMetrics, stage_metrics  # noqa: E402
from datacomp_tpu_torch.services import (  # noqa: E402
    CpuCompressionService, GpuCompressionService, gpu_service,
)
from dczbench import corpus  # noqa: E402

S = gpu_service.FORMAT1_SUBBLOCK


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _k2(data: np.ndarray, lengths, codes, subblock: int):
    """The port's plain K2 on ``data``: (payload, stored gap array, total bits)."""
    n = data.size
    x = np.zeros(-(-max(n, 1) // 32) * 32, np.uint8)
    x[:n] = data
    words, tb, gaps = ops.encode(_t(x), n, *ops.codebook_to_torch(lengths, codes, "cpu"),
                                 (16 * x.size + 31) // 32 + 2, subblock)
    tb = int(tb)
    payload = ops.words_to_bytes(words[: (tb + 31) // 32].numpy(), tb)
    return payload, gaps[: -(-n // subblock)].numpy(), tb


def _jax_k2(data: np.ndarray, lengths, codes, subblock: int):
    """The JAX package's ``encode_device_merge`` on ``data``, likewise."""
    n = data.size
    x = np.zeros(-(-n // 32) * 32, np.uint8)
    x[:n] = data
    words, tb, gaps = encode_device_merge(
        jnp.asarray(x), jnp.int32(n), jnp.asarray(lengths.astype(np.int32)),
        jnp.asarray(codes.astype(np.uint32)), (16 * x.size + 31) // 32 + 2, subblock)
    tb = int(tb)
    payload = ops.words_to_bytes(np.asarray(words)[: (tb + 31) // 32], tb)
    return payload, np.asarray(gaps)[: -(-n // subblock)], tb


def _row(payload: bytes, lengths):
    """One row for ``ops.find_gaps``: its words and its tables, batched."""
    words = _t(ops.payload_to_words(payload).view(np.int32)).view(torch.uint32)
    tables = tuple(_t(t.astype(np.int32)).view(1, -1) for t in ops.build_decode_tables(lengths))
    return words, tables


def _found(payload: bytes, lengths, subblock: int, n_out: int):
    """The plain version's gap bits (numpy) and end for one row."""
    words, tables = _row(payload, lengths)
    gaps, ends = ops.find_gaps(words, [0, words.numel()], *tables, subblock, [n_out])
    return gaps.view(torch.int32).numpy().view(np.uint32), int(ends[0])


def _hold(data, lengths, codes, subblock=S, encoder=_k2):
    payload, want, tb = encoder(data, lengths, codes, subblock)
    gaps, end = _found(payload, lengths, subblock, data.size)
    assert np.array_equal(gaps, want.astype(np.uint32))
    assert end == tb


def _fast_book(data: np.ndarray):
    return huffman.build_codebook(np.bincount(data, minlength=256), mode="fast", max_len=16)


def _chain(depth: int, n: int, seed: int):
    """A chain code of ``depth`` (lengths 1, 2, ..., depth, depth) and
    ``n`` symbols drawn so that every length occurs."""
    lengths = np.zeros(256, np.int32)
    if depth == 1:
        lengths[:2] = 1
    else:
        lengths[:depth] = np.arange(1, depth + 1)
        lengths[depth] = depth
    used = np.flatnonzero(lengths)
    p = 2.0 ** -lengths[used].astype(np.float64) + 0.02
    rng = np.random.default_rng(seed)
    data = rng.choice(used, size=n, p=p / p.sum()).astype(np.uint8)
    return data, lengths, huffman.canonical_codes_from_lengths(lengths)


@pytest.mark.parametrize("kind", sorted(corpus.GENERATORS))
@pytest.mark.parametrize("subblock", [64, S])
def test_plain_finds_the_port_k2_gaps(kind, subblock):
    data = np.frombuffer(corpus.GENERATORS[kind](30_011, 2**31 + 5), np.uint8)
    _hold(data, *_fast_book(data), subblock)


@pytest.mark.parametrize("kind", ["english", "binary", "radiograph"])
def test_plain_finds_the_jax_k2_gaps(kind):
    data = np.frombuffer(corpus.GENERATORS[kind](20_011, 2**31 + 6), np.uint8)
    _hold(data, *_fast_book(data), 256, _jax_k2)


@pytest.mark.parametrize("depth", range(1, 17))
def test_plain_on_chain_codes(depth):
    data, lengths, codes = _chain(depth, 9_001 + depth, depth)
    _hold(data, lengths, codes, 64)


@pytest.mark.parametrize("width", [5, 8])
def test_plain_on_fixed_length_codes(width):
    """Every length is ``width``: the gcd of the lengths in use is above 1."""
    lengths = np.zeros(256, np.int32)
    lengths[: 1 << width] = width
    data = np.random.default_rng(width).integers(0, 1 << width, 20_000).astype(np.uint8)
    _hold(data, lengths, huffman.canonical_codes_from_lengths(lengths), 96)


@pytest.mark.parametrize("n", [1, 100, S - 1, S, 3 * S + 17])
def test_plain_on_one_symbol_and_short_rows(n):
    data = np.full(n, 77, np.uint8)
    _hold(data, *huffman.build_codebook(np.bincount(data, minlength=256)))
    text = np.frombuffer(corpus.GENERATORS["logs"](n, 2**31 + n), np.uint8)
    _hold(text, *_fast_book(text))


def test_plain_batch_of_ragged_rows():
    """Rows of 17, 0 and 50,000 bytes in one call, each equal to its own call
    and its stored gaps; the empty row has no gaps and ends at bit 0."""
    datas = [np.frombuffer(corpus.GENERATORS[k](n, 2**31 + n), np.uint8)[:n]
             for k, n in (("xml", 17), ("xml", 1), ("source", 50_000))]
    datas[1] = datas[1][:0]
    book = _fast_book(np.concatenate(datas))  # a code for every row's bytes
    streams = [_k2(d, *book, S) for d in datas]
    rows = [_row(p, book[0]) for p, _, _ in streams]
    words = torch.cat([w for w, _ in rows])
    offsets = np.cumsum([0] + [w.numel() for w, _ in rows]).tolist()
    tables = tuple(torch.cat([t[k] for _, t in rows]) for k in range(3))
    n_outs = [d.size for d in datas]
    gaps, ends = ops.find_gaps(words, offsets, *tables, S, n_outs)
    assert ops.gap_offsets(n_outs, S) == [0, 1, 1, 14]
    assert np.array_equal(gaps.view(torch.int32).numpy().view(np.uint32),
                          np.concatenate([g for _, g, _ in streams]).astype(np.uint32))
    assert ends.tolist() == [tb for _, _, tb in streams] and ends[1] == 0


def _walk(words: np.ndarray, limits: np.ndarray, subblock: int, n_out: int):
    """The decoder's parse of ``words`` from bit 0, a symbol a step, zeros
    past the words: the bits of symbols 0, subblock, ... and of n_out."""
    bits = "".join(f"{int(w):032b}" for w in words)
    gaps, p = [], 0
    for k in range(n_out + 1):
        if k % subblock == 0 and k < n_out:
            gaps.append(p)
        if k == n_out:
            return np.array(gaps, np.uint32), p
        win = int((bits[p : p + 16] + "0" * 16)[:16], 2)
        p += min(1 + int((limits <= win).sum()), ops.TABLE_BITS)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plain_on_garbage_is_the_decoders_walk(seed):
    """Random words under a code that is not complete: the gaps and the end
    follow the walk, also where the symbols run past the stream."""
    rng = np.random.default_rng(seed)
    lengths = np.zeros(256, np.int32)
    lengths[:5] = (2, 3, 3, 4, 6)  # Kraft sum 37/64: some windows are no codeword
    limits = ops.build_decode_tables(lengths)[0]
    words = rng.integers(0, 2**32, 40, dtype=np.uint64).astype(np.uint32)
    n_out = 1_000 + seed  # about 3 bits a symbol: about twice the 1,280 bits
    wt = _t(words.view(np.int32)).view(torch.uint32)
    tables = tuple(_t(t.astype(np.int32)).view(1, -1) for t in ops.build_decode_tables(lengths))
    gaps, ends = ops.find_gaps(wt, [0, wt.numel()], *tables, 32, [n_out])
    want, end = _walk(words, limits, 32, n_out)
    assert end > 32 * words.size
    assert np.array_equal(gaps.view(torch.int32).numpy().view(np.uint32), want)
    assert int(ends[0]) == end


def test_find_gaps_checks_its_rows():
    words, tables = _row(b"\x12\x34", np.array([1, 1] + [0] * 254, np.int32))
    with pytest.raises(ValueError, match="subblock"):
        ops.find_gaps(words, [0, words.numel()], *tables, 0, [3])
    with pytest.raises(ValueError, match="offsets"):
        ops.find_gaps(words, [0, 1], *tables, S, [3])
    with pytest.raises(ValueError, match="uint32"):
        ops.find_gaps(words, [0, words.numel()], *tables, S, [1 << 28])


def test_routing_by_format_depth_and_size():
    """K5 takes a coded v1 chunk of codes up to 16 bits whose bits fit its
    uint32 gaps; format 2, deeper codes and larger chunks go elsewhere."""
    from types import SimpleNamespace

    def meta(depth, n):
        lengths = np.zeros(256, np.int32)
        lengths[:2] = depth
        return SimpleNamespace(code_lengths=lengths, original_size=n, compressed_size=n,
                               gap_bits=None)

    v1, v2 = (SimpleNamespace(version=v, subblock_symbols=4096) for v in (1, 2))

    def on(m, header):  # a v1 chunk on the device: K5, then K3
        return gpu_service.decode_route(m, header) == "device"
    assert on(meta(16, 16 << 20), v1) and on(meta(1, 1), v1)
    assert not on(meta(16, 16 << 20), v2)
    assert not on(meta(17, 16 << 20), v1) and not on(meta(0, 0), v1)
    assert on(meta(8, 150 << 20), v1) and not on(meta(8, 200 << 20), v1)


# -- format 1 through the GPU service on the plain versions -------------------

CHUNK_MB = 1


def _shallow_input(seed: int) -> np.ndarray:
    """A chunk and a short second, codes 16 bits deep or less in every mode."""
    data = np.random.default_rng(seed).geometric(0.05, (1 << 20) + 12_345) % 64
    return data.astype(np.uint8)


@pytest.fixture(scope="module")
def shallow(tmp_path_factory):
    d = tmp_path_factory.mktemp("k5")
    src = d / "in.bin"
    src.write_bytes(_shallow_input(2**31 + 24).tobytes())
    return d, str(src)


def _counts() -> dict:
    return {"finder": ops.COUNTERS["find_gaps"][1].value,
            "k3": ops.COUNTERS["decode_batch"][1].value,
            "k3_one": ops.COUNTERS["decode"][1].value,
            "routes": gpu_service.host_decode_routes.value}


@pytest.mark.parametrize("mode", ["java", "fast", "device"])
@pytest.mark.parametrize("batch", [1, 4])
def test_format1_restores_through_the_gap_finder(shallow, mode, batch):
    d, src = shallow
    cfg = load_config(compression={"chunk_size_mb": CHUNK_MB, "format_version": 1,
                                   "codebook_mode": mode}, device={"batch_chunks": batch})
    dcz, out = str(d / f"{mode}{batch}.dcz"), str(d / f"{mode}{batch}.out")
    with GpuCompressionService(cfg, device="cpu") as svc:
        svc.compress(src, dcz)
        header, _ = read_container(dcz)
        depths = [ops.max_code_len(c.code_lengths) for c in header.chunks]
        assert header.version == 1 and len(depths) == 2 and max(depths) <= ops.TABLE_BITS
        before = _counts()
        svc.decompress(dcz, out)
        after = _counts()
    with open(src, "rb") as f, open(out, "rb") as g:
        assert f.read() == g.read()
    groups = 2 if batch == 1 else 1
    assert {k: after[k] - before[k] for k in before} == {
        "finder": groups, "k3": groups, "k3_one": 0, "routes": 0}
    if mode != "device":  # the host codec writes the same file
        with CpuCompressionService(cfg) as svc:
            svc.compress(src, dcz + ".cpu")
        with open(dcz, "rb") as f, open(dcz + ".cpu", "rb") as g:
            assert f.read() == g.read()


def test_format1_on_the_mesh_route_takes_the_gap_finder(shallow):
    """``decompress_multihost`` over a local mesh of two CPU entries: a v1
    file goes through the codec's ``decode_chunk_batch`` in groups of
    ``batch_chunks``, so its two chunks through one launch of the gap
    finder and of K3, as on one device; the restore is the input."""
    from datacomp_tpu_torch import parallel

    d, src = shallow
    cfg = load_config(compression={"chunk_size_mb": CHUNK_MB, "format_version": 1,
                                   "codebook_mode": "java"},
                      device={"platform": "cpu", "batch_chunks": 4})
    dcz, out = str(d / "mesh.dcz"), str(d / "mesh.out")
    with GpuCompressionService(cfg, device="cpu") as svc:
        svc.compress(src, dcz)
    before = _counts()
    parallel.decompress_multihost(dcz, out, cfg, backend="gpu",
                                  mesh=parallel.make_mesh(devices=["cpu", "cpu"]))
    after = _counts()
    with open(src, "rb") as f, open(out, "rb") as g:
        assert f.read() == g.read()
    assert {k: after[k] - before[k] for k in before} == {
        "finder": 1, "k3": 1, "k3_one": 0, "routes": 0}


def _zipf(seed: int, n: int) -> np.ndarray:
    """``tests/test_torch_cli.py``'s input: optimal codes 17 bits deep."""
    p = 1.0 / np.arange(1, 257) ** 2.0
    return np.random.default_rng(seed).choice(256, size=n, p=p / p.sum()).astype(np.uint8)


def test_deep_format1_chunk_takes_the_host_route(tmp_path):
    data = _zipf(13, (1 << 20) + (200 << 10))
    src, dcz, out = (str(tmp_path / f) for f in ("in.bin", "in.dcz", "in.out"))
    data.tofile(src)
    cfg = load_config(compression={"chunk_size_mb": CHUNK_MB, "format_version": 1,
                                   "codebook_mode": "java"}, device={"batch_chunks": 4})
    with GpuCompressionService(cfg, device="cpu") as svc:
        svc.compress(src, dcz)
        depths = [ops.max_code_len(c.code_lengths) for c in read_container(dcz)[0].chunks]
        assert min(depths) > ops.TABLE_BITS
        before = _counts()
        stage_metrics.clear_spans()
        try:
            with profile(activities=[ProfilerActivity.CPU]):
                svc.decompress(dcz, out)
            spans = stage_metrics.spans()
        finally:
            stage_metrics.clear_spans()
        after = _counts()
    assert np.array_equal(np.fromfile(out, np.uint8), data)
    assert after["routes"] - before["routes"] == 2
    assert after["finder"] == before["finder"]
    routed = [s for s in spans if s.name == "host_decode"]
    assert sorted(s.nbytes for s in routed) == sorted([1 << 20, 200 << 10])


def _payloads(dcz: str):
    header, start = read_container(dcz)
    with open(dcz, "rb") as f:
        blob = f.read()
    return header, [blob[start + c.compressed_offset:][: c.compressed_size]
                    for c in header.chunks]


def _java_v1(batch: int = 1):
    return load_config(compression={"chunk_size_mb": CHUNK_MB, "format_version": 1,
                                    "codebook_mode": "java"}, device={"batch_chunks": batch})


@pytest.fixture(scope="module")
def small_file(tmp_path_factory):
    """A format-1 file of one chunk of 200,003 bytes and its input."""
    d = tmp_path_factory.mktemp("k5_small")
    src, dcz = str(d / "small.bin"), str(d / "small.dcz")
    _shallow_input(2**31 + 25)[:200_003].tofile(src)
    with GpuCompressionService(_java_v1(), device="cpu") as svc:
        svc.compress(src, dcz)
    return d, src, dcz


def test_flipped_digest_is_refused(small_file):
    d, _, dcz = small_file
    bad = str(d / "digest_bad.dcz")
    header, _ = read_container(dcz)
    with open(dcz, "rb") as f:
        blob = bytearray(f.read())
    blob[blob.index(header.chunks[0].sha256)] ^= 1
    with open(bad, "wb") as f:
        f.write(blob)
    with GpuCompressionService(_java_v1(), device="cpu") as svc:
        assert svc.verify_integrity(dcz, deep=True)
        assert not svc.verify_integrity(bad, deep=True)
        with pytest.raises(IOError, match="Checksum mismatch in chunk 0"):
            svc.decompress(bad, str(d / "digest_bad.out"))


@pytest.mark.parametrize("batch,bad", [(1, "cut"), (4, "ones")])
def test_stream_past_its_payload_is_corrupt(small_file, batch, bad):
    """A payload cut short, or one of all ones (the longest codes), ends
    past its bytes: ``CorruptChunkError``, for one chunk and for a group
    beside a sound member."""
    _, _, dcz = small_file
    header, (payload,) = _payloads(dcz)
    (meta,) = header.chunks
    corrupt = payload[: len(payload) // 2] if bad == "cut" else b"\xff" * len(payload)
    codec = gpu_service.GpuChunkCodec(_java_v1(batch), torch.device("cpu"))
    try:
        with pytest.raises(CorruptChunkError, match="chunk 0: its 200003 symbols end at bit"):
            if batch == 1:
                codec.decode_chunk(corrupt, meta, header, StageMetrics())
            else:
                codec.decode_chunk_batch([payload, corrupt], [meta, meta], header,
                                         StageMetrics())
    finally:
        codec.close()
