"""The port's CUDA kernels against their plain PyTorch versions, on the card,
at small edge-case shapes (ragged lengths, ``valid_len`` masks, one-symbol,
16-bit and 32-bit codebooks, dropped writes, short last sub-blocks), and the
GPU service's output against the host codec's.  Exact equality throughout.

Also K4 (the codebook, lengths and codes, on corpus chunks, Fibonacci
counts, ties, fuzz and totals up to 2^32 - 2) and K1's A/B variants against
their plain versions (K1s at every ``groups`` and counter width, K1p at
uneven stripe counts, on four kinds and the ``valid_len`` edges, and both
replayed from a CUDA graph), K1 on five input kinds with every ``valid_len`` edge
and past 2^24 bytes and counts, K2 on a codebook deeper than 32 bits, and
one 16 MiB chunk through the device-codebook mode (K1 → K4 → K2). K3's
warp-per-sub-block schedule at every code depth from 1 to 16, on a
fixed-length code (no sync round), on the periodic ``compressible`` text, at
sub-blocks of 32 and 65 536 symbols (the second beyond the per-warp
buffers), with a 1-symbol last sub-block, and on random streams (no fault,
``n_out`` bytes back); K2's single pass with tiles that start and end
mid-word and ``out_words`` cut inside a tile.  K5, the gap finder, on 16 MiB
rows of every ``dczbench.corpus`` generator against K2's gap arrays and its
plain version, one row a launch and batched at 4 and 16 rows, on a stream
that resynchronises late and on random words, and K5 → K3 against the host
decoder.  The sharded compress step of
``datacomp_tpu_torch.parallel`` at world size 1, its all-gather on NCCL,
against the batched kernels and the plain versions (1, 4, 16 and 17 rows),
and ``pick_device`` with ``LOCAL_RANK`` past the device count.  The local
level of the mesh on one card twice (``[cuda:0, cuda:0]``): the sharded
compress step against the batched kernels, the decompress step's round
trip, and the file path's ``.dcz`` against the single-card service's.  The
benchmark module on the card: the kernel bench's rows exact with positive
times and bounds, the batch benches, the suite's GPU row named after the
card, the corpus bench's ``gpu`` sizes equal to its ``cpu`` ones, and
``resume`` equal to a one-shot compress.  The golden fixtures through K2 and
K3 (``tests/test_torch_golden.py`` on the card), and the headline's ``gpu``
leg with its link probe.

Marked ``gpu``: every test skips without a CUDA device.  On a machine with
one (and no jax, which ``tests/conftest.py`` imports):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import hashlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import datacomp_tpu.config  # noqa: E402
from datacomp_tpu.core.huffman import build_codebook, canonical_codes_from_lengths  # noqa: E402
from datacomp_tpu.services.cpu_service import CpuCompressionService  # noqa: E402
from datacomp_tpu.utils.testdata import generate_bytes  # noqa: E402
import datacomp_tpu_torch.config  # noqa: E402
from datacomp_tpu_torch import ops  # noqa: E402
from datacomp_tpu_torch.core import read_container  # noqa: E402
from datacomp_tpu_torch.services import CpuCompressionService as PortCpuService  # noqa: E402
from datacomp_tpu_torch.services import GpuCompressionService  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _codebook(kind: str):
    """(data, lengths, codes) for a named case."""
    if kind.startswith("depth"):  # a complete chain code of that depth
        depth = int(kind[5:])
        lengths = np.zeros(256, np.int32)
        lengths[: depth - 1] = np.arange(1, depth)
        lengths[depth - 1 : depth + 1] = depth
        data = np.random.default_rng(depth).integers(0, depth + 1, 7000).astype(np.uint8)
        return data, lengths, canonical_codes_from_lengths(lengths)
    data = (np.full(7000, 42, np.uint8) if kind == "one_symbol"
            else np.frombuffer(generate_bytes(kind, 7000), np.uint8))
    lengths, codes = build_codebook(np.bincount(data, minlength=256), mode="fast", max_len=16)
    return data, lengths, codes


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("n,valid_len", [
    (16, 16), (17, 17), (1000, 999), (65_536 + 3, 65_536 + 3), (1 << 20, 12_345),
])
@pytest.mark.parametrize("kind", ["random", "zeros"])
def test_histogram_kernel_matches_plain(cuda, n, valid_len, kind):
    host = (np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
            if kind == "random" else np.zeros(n, np.uint8))
    x = torch.from_numpy(host).to(cuda)
    got = ops.histogram(x, valid_len)
    assert _same(got, ops.histogram_reference(x, valid_len))
    assert np.array_equal(got.cpu().numpy(), np.bincount(host[:valid_len], minlength=256))


@pytest.mark.parametrize("valid_len", [0, 1, 15, 16, 17, 99_999])
@pytest.mark.parametrize("kind", ["random", "text", "skewed", "compressible", "zeros"])
def test_histogram_kernel_kinds_and_valid_len_edges(cuda, kind, valid_len):
    host = np.frombuffer(generate_bytes(kind, 100_000), np.uint8)
    got = ops.histogram(torch.from_numpy(host.copy()).to(cuda), valid_len)
    assert np.array_equal(got.cpu().numpy(), np.bincount(host[:valid_len], minlength=256))


@pytest.mark.parametrize("kind", ["random", "one_byte"])
def test_histogram_kernel_beyond_2_24_bytes(cuda, kind):
    """Counts past 2^24 in one bin (16 MiB of one byte: every lane's copy of
    the bin in every block counts it), and a chunk longer than 2^24 bytes."""
    if kind == "one_byte":
        host = np.full(16 << 20, 200, np.uint8)
    else:
        host = np.random.default_rng(24).integers(0, 256, (1 << 24) + 4099).astype(np.uint8)
    x = torch.from_numpy(host).to(cuda)
    for valid_len in (host.size, host.size - 12_345):
        got = ops.histogram(x, valid_len)
        assert np.array_equal(got.cpu().numpy(), np.bincount(host[:valid_len], minlength=256))


@pytest.mark.parametrize("kind", ["text", "skewed", "one_symbol", "depth16", "depth32"])
@pytest.mark.parametrize("subblock", [0, 64])
def test_encode_kernel_matches_plain(cuda, kind, subblock):
    data, lengths, codes = _codebook(kind)
    padded = np.zeros(8192, np.uint8)
    padded[: data.size] = data
    x = torch.from_numpy(padded).to(cuda)
    tables = ops.codebook_to_torch(lengths, codes, cuda)
    out_words = 8192 + 2
    kw, ktb, kg = ops.encode(x, data.size, *tables, out_words, subblock)
    rw, rtb, rg = ops.encode_reference(x, data.size, *tables, out_words, subblock)
    assert int(ktb) == int(rtb) == int(lengths.astype(np.int64)[data].sum())
    assert _same(kw, rw)
    assert (kg is None) == (rg is None) and (kg is None or _same(kg, rg))


def test_encode_kernel_drops_writes_past_out_words(cuda):
    data, lengths, codes = _codebook("text")
    x = torch.from_numpy(data[:4096].copy()).to(cuda)
    tables = ops.codebook_to_torch(lengths, codes, cuda)
    kw, ktb, _ = ops.encode(x, 4096, *tables, 100)
    rw, rtb, _ = ops.encode_reference(x, 4096, *tables, 100)
    assert int(ktb) == int(rtb) > 100 * 32
    assert _same(kw, rw)


@pytest.mark.parametrize("kind", ["text", "skewed", "one_symbol", "depth16"])
def test_decode_kernel_matches_plain(cuda, kind):
    data, lengths, codes = _codebook(kind)
    S = 64
    padded = np.zeros(7008, np.uint8)
    padded[: data.size] = data
    words, tb, gaps = ops.encode(torch.from_numpy(padded).to(cuda), data.size,
                                 *ops.codebook_to_torch(lengths, codes, cuda), 7010, S)
    payload = ops.words_to_bytes(words.cpu().numpy(), int(tb))
    w = torch.from_numpy(ops.payload_to_words(payload)).to(cuda)
    g = gaps[: (data.size + S - 1) // S].contiguous()
    tables = ops.decode_tables_to_torch(*ops.build_decode_tables(lengths), cuda)
    got = ops.decode(w, g, *tables, S, data.size)
    assert _same(got, ops.decode_reference(w, g, *tables, S, data.size))
    assert np.array_equal(got.cpu().numpy(), data)


def _fixed_length_codebook(n: int):
    """64 symbols at 6 bits: every codeword starts a multiple of 6 bits in."""
    lengths = np.zeros(256, np.int32)
    lengths[:64] = 6
    data = np.random.default_rng(6).integers(0, 64, n).astype(np.uint8)
    return data, lengths, canonical_codes_from_lengths(lengths)


def _decode_both(cuda, data, lengths, codes, subblock, stats=None):
    """K2 then K3 on the card, each held to its plain version; returns the
    kernel's decoded bytes (as numpy)."""
    n_pad = -(-data.size // 32) * 32
    padded = np.zeros(n_pad, np.uint8)
    padded[: data.size] = data
    x = torch.from_numpy(padded).to(cuda)
    tables = ops.codebook_to_torch(lengths, codes, cuda)
    kw, ktb, kg = ops.encode(x, data.size, *tables, n_pad + 2, subblock)
    rw, rtb, rg = ops.encode_reference(x, data.size, *tables, n_pad + 2, subblock)
    assert int(ktb) == int(rtb) and _same(kw, rw) and _same(kg, rg)
    payload = ops.words_to_bytes(kw.cpu().numpy(), int(ktb))
    w = torch.from_numpy(ops.payload_to_words(payload)).to(cuda)
    g = kg[: -(-data.size // subblock)].contiguous()
    dt = ops.decode_tables_to_torch(*ops.build_decode_tables(lengths), cuda)
    got = ops.decode(w, g, *dt, subblock, data.size, stats)
    assert _same(got, ops.decode_reference(w, g, *dt, subblock, data.size))
    assert np.array_equal(got.cpu().numpy(), data)
    return got


@pytest.mark.parametrize("depth", range(1, 17))
def test_decode_kernel_at_every_depth(cuda, depth):
    _decode_both(cuda, *_codebook(f"depth{depth}"), 4032)


def test_decode_kernel_fixed_length_code_takes_no_round(cuda):
    data, lengths, codes = _fixed_length_codebook(50_000)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    _decode_both(cuda, data, lengths, codes, 4032, stats)
    assert stats.tolist() == [-(-data.size // 4032), 0]


def test_decode_kernel_periodic_compressible_text(cuda):
    data = np.frombuffer(generate_bytes("compressible", 300_000), np.uint8)
    lengths, codes = build_codebook(np.bincount(data, minlength=256), mode="fast", max_len=16)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    _decode_both(cuda, data, lengths, codes, 4032, stats)
    nsub = -(-data.size // 4032)
    assert stats[0].item() == nsub and 0 <= stats[1].item() <= 31 * nsub


@pytest.mark.parametrize("subblock", [32, 65_536])
@pytest.mark.parametrize("kind", ["text", "skewed"])
def test_decode_kernel_small_and_large_subblocks(cuda, kind, subblock):
    """65 536 symbols of a few bits each exceed a warp's shared-memory
    buffers: the direct route in the same kernel."""
    data = np.frombuffer(generate_bytes(kind, 200_000), np.uint8)
    lengths, codes = build_codebook(np.bincount(data, minlength=256), mode="fast", max_len=16)
    _decode_both(cuda, data, lengths, codes, subblock)


@pytest.mark.parametrize("subblock", [32, 4032])
def test_decode_kernel_one_symbol_last_subblock(cuda, subblock):
    data = np.frombuffer(generate_bytes("text", 3 * subblock + 1), np.uint8)
    lengths, codes = build_codebook(np.bincount(data, minlength=256), mode="fast", max_len=16)
    _decode_both(cuda, data, lengths, codes, subblock)


@pytest.mark.parametrize("gaps_kind", ["monotone", "non-monotone"])
def test_decode_kernel_survives_random_streams(cuda, gaps_kind):
    """Random words: no fault, and n_out bytes back (their values are
    garbage, which the chunk's SHA-256 would catch)."""
    rng = np.random.default_rng(7)
    _, lengths, _ = _codebook("skewed")
    nwords, nsub, subblock = 20_000, 150, 4032
    words = torch.from_numpy(rng.integers(0, 1 << 32, nwords, dtype=np.uint64)
                             .astype(np.uint32)).to(cuda)
    gaps = rng.integers(0, 32 * nwords + 1000, nsub)
    if gaps_kind == "monotone":
        gaps = np.sort(gaps)
    gaps = torch.from_numpy(gaps.astype(np.uint32)).to(cuda)
    dt = ops.decode_tables_to_torch(*ops.build_decode_tables(lengths), cuda)
    n_out = nsub * subblock - 17
    out = ops.decode(words, gaps, *dt, subblock, n_out)
    torch.cuda.synchronize()
    assert out.shape == (n_out,) and out.dtype == torch.uint8


_K5_S = 4032  # the format-1 sub-block of the GPU service
_K5_ROW = 16 << 20


def _k5_tables(lengths, cuda):
    return tuple(t.view(1, -1) for t in ops.decode_tables_to_torch(
        *ops.build_decode_tables(lengths), cuda))


def _late_codebook():
    """254 codes of 8 bits and one of 7: a parse that starts off the true
    phase keeps decoding 8-bit codewords and stays off it for about a
    thousand codewords, twice K5's 512-bit margin and more."""
    lengths = np.full(256, 8, np.int32)
    lengths[0], lengths[255] = 7, 0
    return lengths, canonical_codes_from_lengths(lengths)


@pytest.fixture(scope="module")
def k5_rows():
    """Per kind: a 16 MiB row through K2 on the card (fast codes capped at
    16 bits; for ``late``, :func:`_late_codebook`), its stream and tables on
    the card, K2's gap array and total bits, and the plain K5's gaps and
    end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dczbench import corpus

    cuda = torch.device("cuda")
    rows = {}
    for kind in [*sorted(corpus.GENERATORS), "late"]:
        if kind == "late":
            data = np.random.default_rng(5).integers(0, 255, _K5_ROW - 4321).astype(np.uint8)
            lengths, codes = _late_codebook()
        else:
            # a 4 MiB sample four times over: the generators are Python loops
            sample = np.frombuffer(corpus.GENERATORS[kind](_K5_ROW // 4, 2**31 + 24), np.uint8)
            data = np.tile(sample, 4)[: _K5_ROW - 4321]
            lengths, codes = build_codebook(np.bincount(data, minlength=256), mode="fast",
                                            max_len=16)
        padded = np.zeros(_K5_ROW, np.uint8)
        padded[: data.size] = data
        kw, ktb, kg = ops.encode(torch.from_numpy(padded).to(cuda), data.size,
                                 *ops.codebook_to_torch(lengths, codes, cuda),
                                 (16 * _K5_ROW + 31) // 32 + 2, _K5_S)
        tb = int(ktb)
        payload = ops.words_to_bytes(kw[: (tb + 31) // 32].cpu().numpy(), tb)
        words = torch.from_numpy(ops.payload_to_words(payload).view(np.int32)).view(torch.uint32)
        tables = _k5_tables(lengths, cuda)
        plain = ops.find_gaps(words, [0, words.numel()], *(t.cpu() for t in tables), _K5_S,
                              [data.size])
        rows[kind] = {"words": words.to(cuda), "tables": tables, "n": data.size,
                      "k2_gaps": kg[: -(-data.size // _K5_S)].cpu(), "bits": tb,
                      "plain": plain, "payload": payload, "lengths": lengths, "data": data}
    return rows


def test_gap_finder_plain_is_k2s_gap_array(k5_rows):
    for kind, r in k5_rows.items():
        gaps, ends = r["plain"]
        assert _same(gaps, r["k2_gaps"]), kind
        assert int(ends[0]) == r["bits"], kind


@pytest.mark.parametrize("rows", [1, 4, 16])
def test_gap_finder_kernel_matches_plain(k5_rows, rows):
    """``rows`` rows of the kinds in turn in one launch, each the plain
    version's gaps and end."""
    kinds = sorted(k5_rows)
    pick = [k5_rows[kinds[b % len(kinds)]] for b in range(rows)]
    words = torch.cat([r["words"] for r in pick])
    offsets = np.cumsum([0] + [r["words"].numel() for r in pick]).tolist()
    tables = tuple(torch.cat([r["tables"][k] for r in pick]) for k in range(3))
    launches = ops.COUNTERS["find_gaps"][0].value
    gaps, ends = ops.find_gaps(words, offsets, *tables, _K5_S, [r["n"] for r in pick])
    assert ops.COUNTERS["find_gaps"][0].value == launches + 1
    assert _same(gaps, torch.cat([r["plain"][0] for r in pick]))
    assert ends.cpu().tolist() == [int(r["plain"][1][0]) for r in pick]


def test_gap_finder_kernel_then_k3_is_the_host_decoder(k5_rows, cuda):
    from datacomp_tpu_torch import native

    for kind in ("english", "late", "radiograph"):
        r = k5_rows[kind]
        words, n = r["words"], r["n"]
        gaps, _ = ops.find_gaps(words, [0, words.numel()], *r["tables"], _K5_S, [n])
        out = ops.decode_batch(words, [0, words.numel()], gaps, ops.gap_offsets([n], _K5_S),
                               *r["tables"], _K5_S, [n])
        host = native.decode(r["payload"], n, r["lengths"])
        assert np.array_equal(out.cpu().numpy(), host), kind
        assert np.array_equal(host, r["data"]), kind


@pytest.mark.parametrize("n_out", [1_000_003, 9_000_000])
def test_gap_finder_kernel_on_random_words(cuda, n_out):
    """Garbage: the kernel follows the same parse as the plain version, past
    the stream's end too, and finishes."""
    rng = np.random.default_rng(n_out)
    words = torch.from_numpy(rng.integers(0, 1 << 32, 300_000, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).view(torch.uint32)
    lengths, _ = _late_codebook()
    for lengths in (lengths, _codebook("skewed")[1]):
        tables = _k5_tables(lengths, cuda)
        gaps, ends = ops.find_gaps(words.to(cuda), [0, words.numel()], *tables, _K5_S, [n_out])
        want, want_end = ops.find_gaps(words, [0, words.numel()], *(t.cpu() for t in tables),
                                       _K5_S, [n_out])
        assert _same(gaps, want) and int(ends[0]) == int(want_end[0])


def test_gap_finder_kernel_on_short_and_empty_rows(cuda):
    """Rows of 0, 1, 17 and 5,000 bytes: one launch, each row its own."""
    datas = [np.frombuffer(generate_bytes("text", n, seed=n), np.uint8)[:n]
             for n in (0, 1, 17, 5000)]
    lengths, codes = build_codebook(np.bincount(np.concatenate(datas), minlength=256),
                                    mode="fast", max_len=16)
    parts = []
    for d in datas:
        padded = np.zeros(-(-max(d.size, 1) // 32) * 32, np.uint8)
        padded[: d.size] = d
        kw, ktb, kg = ops.encode(torch.from_numpy(padded).to(cuda), d.size,
                                 *ops.codebook_to_torch(lengths, codes, cuda),
                                 (16 * padded.size + 31) // 32 + 2, 32)
        payload = ops.words_to_bytes(kw[: (int(ktb) + 31) // 32].cpu().numpy(), int(ktb))
        parts.append((torch.from_numpy(ops.payload_to_words(payload).view(np.int32))
                      .view(torch.uint32), kg[: -(-d.size // 32)].cpu(), int(ktb)))
    words = torch.cat([p[0] for p in parts]).to(cuda)
    offsets = np.cumsum([0] + [p[0].numel() for p in parts]).tolist()
    tables = tuple(t.expand(len(datas), -1).contiguous() for t in _k5_tables(lengths, cuda))
    gaps, ends = ops.find_gaps(words, offsets, *tables, 32, [d.size for d in datas])
    assert _same(gaps, torch.cat([p[1] for p in parts]))
    assert ends.cpu().tolist() == [p[2] for p in parts]


def test_encode_kernel_tiles_start_and_end_mid_word(cuda):
    """Three full K2 tiles and a partial one of 3- to 10-bit codes, every tile
    boundary inside a word (tiles share their boundary words), and out_words
    cut inside the second tile."""
    from datacomp_tpu_torch.ops import _build

    tile = _build.library().dcz_encode_tile_symbols()
    data = np.frombuffer(generate_bytes("text", 3 * tile + 1000), np.uint8).copy()
    lengths, codes = build_codebook(np.bincount(data, minlength=256), mode="fast", max_len=16)
    # move a boundary that falls on a word edge: give its tile's last symbol
    # a code of another length
    other = {int(lengths[s]): s for s in np.flatnonzero(lengths)}
    for t in range(1, 4):
        if int(lengths.astype(np.int64)[data[: t * tile]].sum()) % 32 == 0:
            last = data[t * tile - 1]
            data[t * tile - 1] = next(s for l, s in other.items() if l != lengths[last])
    ends = np.cumsum(lengths.astype(np.int64)[data])
    tile_ends = ends[[tile - 1, 2 * tile - 1, 3 * tile - 1]]
    assert (tile_ends % 32).all()  # every tile boundary falls inside a word
    padded = np.zeros(-(-data.size // 32) * 32, np.uint8)
    padded[: data.size] = data
    x = torch.from_numpy(padded).to(cuda)
    tables = ops.codebook_to_torch(lengths, codes, cuda)
    cut = int(tile_ends[0] + tile_ends[1]) // 64  # a word inside the second tile
    assert tile_ends[0] // 32 < cut < tile_ends[1] // 32
    for out_words in (int(ends[-1]) // 32 + 400, cut):
        kw, ktb, kg = ops.encode(x, data.size, *tables, out_words, 64)
        rw, rtb, rg = ops.encode_reference(x, data.size, *tables, out_words, 64)
        assert int(ktb) == int(rtb) == int(ends[-1])
        assert _same(kw, rw) and _same(kg, rg)


def test_encode_kernel_stays_in_bounds_on_codes_deeper_than_32_bits(cuda):
    """A K4 codebook of depth 40, which the codec refuses after the encode:
    K2 must not fault, and its bit count is still the sum of the lengths."""
    lengths, codes = ops.codebook_reference(torch.from_numpy(_codebook_histogram("fib40")))
    data = np.random.default_rng(40).integers(0, 41, 8192).astype(np.uint8)
    x = torch.from_numpy(data).to(cuda)
    kw, ktb, kg = ops.encode(x, data.size, lengths.to(cuda), codes.to(cuda), 300, 64)
    torch.cuda.synchronize()
    assert int(ktb) == int(lengths.numpy().astype(np.int64)[data].sum()) > 300 * 32
    assert kw.shape == (300,) and kg.shape == (128,)


def test_kernels_reject_misaligned_data(cuda):
    x = torch.zeros(64, dtype=torch.uint8, device=cuda)[1:33]
    with pytest.raises(ValueError, match="aligned"):
        ops.histogram(x, 32)


def test_service_matches_host_codec(cuda, tmp_path):
    data = (generate_bytes("text", 1 << 20) + generate_bytes("skewed", 700_000)
            + generate_bytes("random", 1 << 20))
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    comp = {"chunk_size_mb": 1, "format_version": 2, "codebook_mode": "fast"}
    with CpuCompressionService(datacomp_tpu.config.load_config(compression=comp)) as svc:
        svc.compress(str(src), str(tmp_path / "c.dcz"))
    cfg = datacomp_tpu_torch.config.load_config(compression=comp)
    with GpuCompressionService(cfg, device="cuda") as svc:
        assert svc.is_available()
        svc.compress(str(src), str(tmp_path / "g.dcz"))
        svc.decompress(str(tmp_path / "g.dcz"), str(tmp_path / "g.out"))
    assert (tmp_path / "g.dcz").read_bytes() == (tmp_path / "c.dcz").read_bytes()
    assert (tmp_path / "g.out").read_bytes() == data


_CODEBOOK_CASES = ["empty", "all_equal", "one", "two", "fib20", "fib32", "fib40",
                   *(f"random{i}" for i in range(8)), "text", "skewed", "compressible",
                   "text16", "skewed16", "compressible16", "total31", "total31fib",
                   "total32"]


def _codebook_histogram(name: str) -> np.ndarray:
    """The int32[256] histogram of a named K4 case."""
    hist = np.zeros(256, np.int32)
    if name == "all_equal":
        hist[:] = 7
    elif name == "one":
        hist[9] = 3
    elif name == "two":
        hist[[0, 255]] = [1, 1 << 20]
    elif name.startswith("fib"):  # Fibonacci counts: an optimal code that deep
        a, b = 1, 1
        for s in range(int(name[3:]) + 1):
            hist[s] = a
            a, b = b, a + b
    elif name.startswith("random"):
        i = int(name[6:])
        rng = np.random.default_rng(i)
        k = int(rng.integers(1, 257))
        hist[rng.choice(256, k, replace=False)] = rng.integers(1, 1 << (2 + 3 * i), k)
    elif name.startswith("total"):  # a 2^31 - 1 byte chunk's totals, and 2^32 - 2
        top = (1 << 31) - 1
        if name == "total31":
            hist[:] = top // 256
        elif name == "total31fib":
            fib = _codebook_histogram("fib40").astype(np.int64)
            hist[:] = fib * (top // int(fib.sum()))
        else:
            hist[[0, 1, 2]] = [top, top - 2, 2]
    elif name != "empty":
        size = 16 << 20 if name.endswith("16") else 1 << 20
        data = np.frombuffer(generate_bytes(name.removesuffix("16"), size), np.uint8)
        hist = np.bincount(data, minlength=256).astype(np.int32)
    return hist


@pytest.mark.parametrize("name", _CODEBOOK_CASES)
def test_codebook_kernel_matches_plain(cuda, name):
    h = torch.from_numpy(_codebook_histogram(name)).to(cuda)
    kl, kc = ops.codebook(h)
    rl, rc = ops.codebook_reference(h)
    assert _same(kl, rl)
    assert _same(kc, rc)  # at any depth: past 32 bits the meaningless codes agree too
    if int(rl.max()) <= 32 and rl.any():
        assert np.array_equal(kc.cpu().numpy(), canonical_codes_from_lengths(kl.cpu().numpy()))


@pytest.mark.parametrize("seed", range(6))
def test_codebook_kernel_fuzz(cuda, seed):
    """Random symbol subsets, many with heavy ties, counts up to 2^26."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(20):
        k = int(rng.integers(0, 257))
        top = max(1, min(int(rng.choice([1, 2, 3, 17, 1000, 1 << 16, 1 << 26])),
                         ((1 << 30) - 1) // max(k, 1)))
        vals = rng.integers(1, top + 1, k)
        if k and rng.random() < 0.4:
            vals = rng.choice(vals[: max(1, k // 8)], k)
        hist = np.zeros(256, np.int32)
        hist[rng.choice(256, k, replace=False)] = vals
        h = torch.from_numpy(hist).to(cuda)
        kl, kc = ops.codebook(h)
        rl, rc = ops.codebook_reference(h)
        assert _same(kl, rl) and _same(kc, rc)


#: name -> (op, its arguments after valid_len): K1s in r3's configurations
#: and at every other (groups, counter_bits), and K1p at every k checked on
#: the card (3, 5 and 64 leave the stripes uneven)
_VARIANTS = {name: (ops.histogram_stacked, config) for name, config in ops.STACKED.items()}
_VARIANTS.update({f"groups{g}-bits{b}": (ops.histogram_stacked, (g, b))
                  for b in (8, 16) for g in range(1, 17) if (g, b) not in ops.STACKED.values()})
_VARIANTS.update({f"partial-k{k}": (ops.histogram_partial, (k,)) for k in (1, 2, 3, 4, 5, 8, 64)})
_VARIANT_DATA: dict = {}


def _run_variant(name: str, x: torch.Tensor, valid_len: int) -> torch.Tensor:
    op, args = _VARIANTS[name]
    return op(x, valid_len, *args)


def _variant_data(kind: str, n: int) -> np.ndarray:
    if (kind, n) not in _VARIANT_DATA:
        if kind == "random":
            host = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
        elif kind == "zeros":  # one symbol: every 8-bit counter fills up
            host = np.zeros(n, np.uint8)
        else:
            host = np.frombuffer(generate_bytes(kind, n), np.uint8).copy()
        _VARIANT_DATA[kind, n] = host
    return _VARIANT_DATA[kind, n]


@pytest.mark.parametrize("n,valid_len", [
    (16, 16), (1000, 999), (65_536 + 3, 65_536 + 3), (1 << 20, (1 << 20) - 12_345),
    (1000, 0), (1000, 1), (1000, 15), (1000, 16), (1000, 17)])
@pytest.mark.parametrize("kind", ["random", "zeros", "skewed", "compressible"])
@pytest.mark.parametrize("variant", _VARIANTS)
def test_histogram_variants_match_plain(cuda, variant, kind, n, valid_len):
    host = _variant_data(kind, n)
    x = torch.from_numpy(host).to(cuda)
    got = _run_variant(variant, x, valid_len)
    assert _same(got, ops.histogram_reference(x, valid_len))
    assert np.array_equal(got.cpu().numpy(), np.bincount(host[:valid_len], minlength=256))


@pytest.mark.parametrize("variant", ["stacked", "stacked8", "stacked-i16", "groups3-bits8",
                                     "partial-k1", "partial-k3", "partial-k4", "partial-k64"])
def test_histogram_variants_replay_from_a_cuda_graph(cuda, variant):
    """Both variants capture into a CUDA graph (the counting launch and the
    programmatically dependent sum) and replay to the same result, reading
    what the input buffer holds at replay."""
    n = 1 << 20
    valid = n - 12_345
    x = torch.from_numpy(_variant_data("skewed", n)).to(cuda)
    want = _run_variant(variant, x, valid)  # outside the graph: the build and first-use work
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = _run_variant(variant, x, valid)
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert _same(out, want)
    other = _variant_data("random", n)
    x.copy_(torch.from_numpy(other))
    graph.replay()
    torch.cuda.synchronize()
    assert np.array_equal(out.cpu().numpy(), np.bincount(other[:valid], minlength=256))


def test_device_codebook_mode_16mib_round_trip(cuda, tmp_path):
    """One 16 MiB text chunk in device mode v2: the lengths in the container
    are K4's plain version on the chunk's histogram, and it round-trips."""
    data = generate_bytes("text", 16 << 20)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    cfg = datacomp_tpu_torch.config.load_config(compression={
        "chunk_size_mb": 16, "format_version": 2, "codebook_mode": "device"})
    launches = ops.COUNTERS["codebook_batch"][0].value
    with GpuCompressionService(cfg, device="cuda") as svc:
        svc.compress(str(src), str(tmp_path / "g.dcz"))
        svc.decompress(str(tmp_path / "g.dcz"), str(tmp_path / "g.out"))
    assert (tmp_path / "g.out").read_bytes() == data
    assert ops.COUNTERS["codebook_batch"][0].value == launches + 1
    header, _ = read_container(str(tmp_path / "g.dcz"))
    hist = np.bincount(np.frombuffer(data, np.uint8), minlength=256).astype(np.int32)
    want, _ = ops.codebook_reference(torch.from_numpy(hist))
    assert np.array_equal(header.chunks[0].code_lengths, want.numpy())


_BATCH_KINDS = ("text", "skewed", "compressible", "zeros", "random")


def _batch_rows(rows: int, n: int = 1 << 16):
    """``rows`` chunks of ``n`` bytes (the kinds in turn) with ragged valid
    lengths: n, n - 12345, 17, 0, then 1, 15, 16, and n again."""
    edges = (n, n - 12_345, 17, 0, 1, 15, 16)
    data = np.stack([np.frombuffer(generate_bytes(_BATCH_KINDS[b % 5], n, seed=b), np.uint8)
                     for b in range(rows)])
    return data, [edges[b % len(edges)] for b in range(rows)]


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 16])
def test_batched_kernels_match_unbatched_and_plain(cuda, rows):
    """K1 → K4, K2 (host codebooks, capped at 16 bits) and K3 through their
    batched entry points equal the unbatched kernels row by row and the
    plain batched versions, and the decode returns each row's input."""
    data, valid = _batch_rows(rows)
    n, S = data.shape[1], 512
    x = torch.from_numpy(data).to(cuda)
    hist = ops.histogram_batch(x, valid)
    assert _same(hist, ops.histogram_batch_reference(x, valid))
    lens, codes = ops.codebook_batch(hist)
    rl, rc = ops.codebook_batch_reference(hist)
    assert _same(lens, rl) and _same(codes, rc)
    for b in range(rows):
        assert np.array_equal(hist[b].cpu().numpy(), np.bincount(data[b, : valid[b]], minlength=256))
        assert _same(hist[b], ops.histogram(x[b], valid[b]))
        kl, kc = ops.codebook(hist[b].contiguous())
        assert _same(kl, lens[b]) and _same(kc, codes[b])

    books = [build_codebook(np.bincount(data[b, : valid[b]], minlength=256), mode="fast",
                            max_len=16) for b in range(rows)]
    lt = torch.from_numpy(np.stack([bk[0] for bk in books]).astype(np.int32)).to(cuda)
    ct = torch.from_numpy(np.stack([bk[1] for bk in books]).astype(np.uint32)).to(cuda)
    out_words = (9 * n + 31) // 32 + 2
    words, totals, gaps = ops.encode_batch(x, valid, lt, ct, out_words, S)
    rw, rt, rg = ops.encode_batch_reference(x, valid, lt, ct, out_words, S)
    assert _same(words, rw) and _same(totals, rt) and _same(gaps, rg)
    streams, gap_rows, tables = [], [], []
    for b in range(rows):
        kw, ktb, kg = ops.encode(x[b], valid[b], lt[b], ct[b], out_words, S)
        assert _same(kw, words[b]) and int(ktb) == int(totals[b]) and _same(kg, gaps[b])
        tb = int(totals[b])
        payload = ops.words_to_bytes(words[b, : (tb + 31) // 32].cpu().numpy(), tb)
        streams.append(ops.payload_to_words(payload))
        gap_rows.append(gaps[b, : -(-valid[b] // S)].cpu().numpy())
        tables.append(ops.build_decode_tables(books[b][0]))

    word_off = np.cumsum([0] + [w.size for w in streams]).tolist()
    gap_off = np.cumsum([0] + [g.size for g in gap_rows]).tolist()
    w = torch.from_numpy(np.concatenate(streams)).to(cuda)
    g = torch.from_numpy(np.concatenate(gap_rows).astype(np.uint32)).to(cuda)
    lim, adj, sym = (torch.from_numpy(np.stack([t[k] for t in tables])).to(cuda)
                     for k in range(3))
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    out = ops.decode_batch(w, word_off, g, gap_off, lim, adj, sym, S, valid, stats)
    want = np.concatenate([data[b, : valid[b]] for b in range(rows)])
    assert np.array_equal(out.cpu().numpy(), want)
    assert _same(out, ops.decode_batch_reference(w, word_off, g, gap_off, lim, adj, sym, S,
                                                 valid))
    assert int(stats[0]) == gap_off[-1]  # every sub-block of every row
    at = 0
    for b in range(rows):
        one = ops.decode(w[word_off[b] : word_off[b + 1]], g[gap_off[b] : gap_off[b + 1]],
                         lim[b], adj[b], sym[b], S, valid[b])
        assert _same(one, out[at : at + valid[b]])
        at += valid[b]


def test_batched_decode_keeps_a_short_row_to_its_own_words(cuda):
    """A row whose stream is cut short decodes as it does alone (zeros past
    its end), not from the next row's words."""
    data, _ = _batch_rows(2, 1 << 14)
    S = 256
    streams, gap_rows, tables = [], [], []
    for row in data:
        lengths, codes = build_codebook(np.bincount(row, minlength=256), mode="fast",
                                        max_len=16)
        x = torch.from_numpy(row.copy()).to(cuda)
        kw, ktb, kg = ops.encode(x, row.size, *ops.codebook_to_torch(lengths, codes, cuda),
                                 row.size, S)
        tb = int(ktb)
        streams.append(ops.payload_to_words(ops.words_to_bytes(kw[: (tb + 31) // 32].cpu().numpy(), tb)))
        gap_rows.append(kg.cpu().numpy())
        tables.append(ops.build_decode_tables(lengths))
    streams[0] = streams[0][: streams[0].size // 2]  # row 0 loses half its words
    word_off = [0, streams[0].size, streams[0].size + streams[1].size]
    w = torch.from_numpy(np.concatenate(streams)).to(cuda)
    g = torch.from_numpy(np.concatenate(gap_rows)).to(cuda)
    lim, adj, sym = (torch.from_numpy(np.stack([t[k] for t in tables])).to(cuda)
                     for k in range(3))
    n = data.shape[1]
    out = ops.decode_batch(w, word_off, g, [0, n // S, 2 * n // S], lim, adj, sym, S, [n, n])
    alone = ops.decode(w[: word_off[1]], g[: n // S], lim[0], adj[0], sym[0], S, n)
    assert _same(out[:n], alone)
    assert np.array_equal(out[n:].cpu().numpy(), data[1])


@pytest.mark.parametrize("version,mode", [(1, "java"), (2, "fast"), (2, "device"), (1, "device")])
def test_batched_service_matches_unbatched(cuda, tmp_path, version, mode):
    """Six 1 MiB chunks (a group of four, then two): the ``.dcz`` at
    ``batch_chunks`` 4 equals the one at 1, and each batched kernel launched
    once a device group."""
    data = generate_bytes("text", 5 * (1 << 20) + 321)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    comp = {"chunk_size_mb": 1, "format_version": version, "codebook_mode": mode}
    outs = {}
    for bc in (1, 4):
        cfg = datacomp_tpu_torch.config.load_config(compression=comp,
                                                    device={"batch_chunks": bc})
        ops.reset_counters()
        with GpuCompressionService(cfg, device="cuda") as svc:
            svc.compress(str(src), str(tmp_path / f"{bc}.dcz"))
            svc.decompress(str(tmp_path / f"{bc}.dcz"), str(tmp_path / f"{bc}.out"))
        assert (tmp_path / f"{bc}.out").read_bytes() == data
        outs[bc] = (tmp_path / f"{bc}.dcz").read_bytes()
        launches = {k: c[0].value for k, c in ops.COUNTERS.items()}
        assert not any(c[1].value for c in ops.COUNTERS.values())  # no plain version
    assert outs[1] == outs[4]
    assert launches["encode_batch"] == 2 and launches["encode"] == 0
    device = mode == "device"
    assert launches["histogram_batch"] == launches["codebook_batch"] == 2 * device
    # every chunk is at most 16 bits deep: v1 groups find their gaps on the card too
    header, _ = read_container(str(tmp_path / "4.dcz"))
    assert max(ops.max_code_len(c.code_lengths) for c in header.chunks) <= ops.TABLE_BITS
    assert launches["decode_batch"] == 2 and launches["decode"] == 0
    assert launches["find_gaps"] == 2 * (version == 1)


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A process group of this process alone on ``cpu:gloo,cuda:nccl`` (the
    backend a rank on a CUDA device gets), and its mesh; destroyed after the
    module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from datacomp_tpu_torch import parallel

    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        yield parallel.make_mesh(1, device="cuda:0")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("rows", [1, 4, 16, 17])
def test_sharded_step_on_nccl_matches_batched_kernels_and_plain(nccl_mesh, rows):
    """The world-size-1 sharded compress step (its all-gather on NCCL) equals
    K1 → K4 → K2 through their batched entry points and the plain versions
    row by row, its offsets the host's exclusive cumsum of the sizes; 17
    rows run each kernel in two launches.  The decompress step restores
    every row."""
    from datacomp_tpu_torch import parallel

    data, valid = _batch_rows(rows)
    n, S = data.shape[1], 512
    x = torch.from_numpy(data).cuda()
    step = parallel.make_sharded_compress_step(nccl_mesh, n, S)
    ops.reset_counters()
    got = step(x, valid, rows)
    launches = {k: c[0].value for k, c in ops.COUNTERS.items()}
    spans = -(-rows // ops.MAX_ROWS)
    assert all(launches[f"{k}_batch"] == spans for k in ("histogram", "codebook", "encode"))
    assert not any(c[1].value for c in ops.COUNTERS.values())  # no plain version
    hist, lens, codes, words, totals, gaps, comp_bytes, offsets = got
    out_words = (9 * n + 31) // 32 + 2
    for s in range(0, rows, ops.MAX_ROWS):
        r, v = slice(s, s + ops.MAX_ROWS), valid[s : s + ops.MAX_ROWS]
        kh = ops.histogram_batch(x[r], v)
        kl, kc = ops.codebook_batch(kh)
        kernel = (kh, kl, kc, *ops.encode_batch(x[r], v, kl, kc, out_words, S))
        ph = ops.histogram_batch_reference(x[r], v)
        pl, pc = ops.codebook_batch_reference(ph)
        plain = (ph, pl, pc, *ops.encode_batch_reference(x[r], v, pl, pc, out_words, S))
        for mine, k, p in zip(got[:6], kernel, plain):
            assert _same(mine[r], k) and _same(mine[r], p)
    sizes = (totals.cpu().numpy() + 7) // 8
    assert comp_bytes.cpu().tolist() == sizes.tolist()
    assert offsets.cpu().tolist() == (np.cumsum(sizes) - sizes).tolist()

    lengths = lens.cpu().numpy()
    keep = [b for b in range(rows) if 0 < ops.max_code_len(lengths[b]) <= ops.TABLE_BITS]
    words_h, totals_h, gaps_h = words.cpu().numpy(), totals.cpu().numpy(), gaps.cpu().numpy()
    streams = [ops.payload_to_words(ops.words_to_bytes(words_h[b], int(totals_h[b])))
               for b in keep]
    restored = parallel.sharded_decompress_arrays(
        nccl_mesh, streams, gaps_h[keep], lengths[keep], S, [valid[b] for b in keep])
    for b, row in zip(keep, restored):
        assert np.array_equal(row.cpu().numpy(), data[b, : valid[b]])


@pytest.mark.parametrize("rows", [2, 8, 34])  # 17 rows a device: two launches each
def test_local_step_on_one_card_twice_matches_batched_kernels(cuda, rows):
    """The sharded compress step over the local mesh ``[cuda:0, cuda:0]``
    (half the rows each) equals K1 → K4 → K2 through their batched entry
    points on all the rows, its offsets the host's cumsum of the sizes, and
    the decompress step over the same mesh restores the rows it can."""
    from datacomp_tpu_torch import parallel

    data, valid = _batch_rows(rows)
    n, S, half = data.shape[1], 512, rows // 2
    x = torch.from_numpy(data).to(cuda)
    mesh = parallel.make_mesh(devices=["cuda:0", "cuda:0"])
    ops.reset_counters()
    outs = parallel.make_sharded_compress_step(mesh, n, S)([x[:half], x[half:]], valid, rows)
    launches = {k: c[0].value for k, c in ops.COUNTERS.items()}
    spans = 2 * -(-half // ops.MAX_ROWS)
    assert all(launches[f"{k}_batch"] == spans for k in ("histogram", "codebook", "encode"))
    assert not any(c[1].value for c in ops.COUNTERS.values())  # no plain version
    got = [torch.cat([o[k] for o in outs]) for k in range(8)]
    out_words = (9 * n + 31) // 32 + 2
    for s in range(0, rows, ops.MAX_ROWS):
        r, v = slice(s, s + ops.MAX_ROWS), valid[s : s + ops.MAX_ROWS]
        kh = ops.histogram_batch(x[r], v)
        kl, kc = ops.codebook_batch(kh)
        kernel = (kh, kl, kc, *ops.encode_batch(x[r], v, kl, kc, out_words, S))
        for mine, k in zip(got[:6], kernel):
            assert _same(mine[r], k)
    sizes = (got[4].cpu().numpy() + 7) // 8
    assert got[6].cpu().tolist() == sizes.tolist()
    assert got[7].cpu().tolist() == (np.cumsum(sizes) - sizes).tolist()

    lengths = got[1].cpu().numpy()
    keep = [b for b in range(rows) if 0 < ops.max_code_len(lengths[b]) <= ops.TABLE_BITS]
    keep = keep[: len(keep) // 2 * 2]  # the rows share the two devices evenly
    words_h, totals_h, gaps_h = (t.cpu().numpy() for t in got[3:6])
    streams = [ops.payload_to_words(ops.words_to_bytes(words_h[b], int(totals_h[b])))
               for b in keep]
    restored = parallel.sharded_decompress_arrays(
        mesh, streams, gaps_h[keep], lengths[keep], S, [valid[b] for b in keep])
    for b, row in zip(keep, restored):
        assert row.device.type == "cuda" and np.array_equal(row.cpu().numpy(), data[b, : valid[b]])


@pytest.mark.parametrize("mode", ["device", "fast"])
def test_local_file_path_on_one_card_twice(cuda, tmp_path, mode):
    """``compress_multihost`` / ``decompress_multihost`` over ``[cuda:0,
    cuda:0]``: the single-card service's ``.dcz`` (device v2 through the
    sharded step, fast v2 through the codec), and the input restored through
    the local decompress path."""
    from datacomp_tpu_torch import parallel

    src = tmp_path / "in.bin"
    src.write_bytes(generate_bytes("text", 1 << 20) + generate_bytes("random", 1 << 20)
                    + generate_bytes("skewed", 1 << 20) + generate_bytes("compressible", 12345))
    cfg = datacomp_tpu_torch.config.load_config(compression={
        "chunk_size_mb": 1, "format_version": 2, "codebook_mode": mode})
    with GpuCompressionService(cfg) as svc:
        svc.compress(str(src), str(tmp_path / "one.dcz"))
    mesh = parallel.make_mesh(devices=["cuda:0", "cuda:0"])
    parallel.compress_multihost(str(src), str(tmp_path / "two.dcz"), cfg, mesh=mesh)
    assert (tmp_path / "two.dcz").read_bytes() == (tmp_path / "one.dcz").read_bytes()
    ops.reset_counters()
    parallel.decompress_multihost(str(tmp_path / "two.dcz"), str(tmp_path / "two.out"), cfg,
                                  mesh=mesh)
    assert (tmp_path / "two.out").read_bytes() == src.read_bytes()
    header, _ = read_container(str(tmp_path / "two.dcz"))
    on_k3 = sum(1 for c in header.chunks if 0 < ops.max_code_len(c.code_lengths) <= 16)
    assert ops.COUNTERS["decode_batch"][0].value == on_k3
    assert not any(c[1].value for c in ops.COUNTERS.values())


def test_pick_device_local_rank_past_the_count_raises(cuda, monkeypatch):
    from datacomp_tpu_torch.services import pick_device

    count = torch.cuda.device_count()
    monkeypatch.setenv("LOCAL_RANK", str(count))
    with pytest.raises(RuntimeError, match=f"LOCAL_RANK {count} names no CUDA device"):
        pick_device("any", -1)
    assert pick_device("any", 0) == torch.device("cuda", 0)  # an explicit index wins
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert pick_device("any", -1) == torch.device("cuda", 0)


def test_kernel_bench_rows(cuda):
    """``bench --kernels`` at 1 MiB: every row exact, with positive times and
    bounds; the primitives all read; the card named."""
    from datacomp_tpu_torch.benchmark.kernels import run_kernel_bench

    res = run_kernel_bench(1, "text")
    rows = {k: v for k, v in res.items() if not k.startswith("_")}
    assert {"histogram", "histogram-library", "codebook", "encode", "decode"} <= set(rows)
    for name, r in rows.items():
        assert r["exact"], name
        assert r["ms_per_chunk"] > 0 and r["call_ms"] > 0 and r["bound_ms"] > 0, name
        assert 0 < r["efficiency"], name
    assert rows["codebook"]["bound_kind"] == "launch floor"
    prim = res["_primitives"]
    assert "suspect" not in prim and all(v > 0 for v in prim.values()), prim
    assert res["_device"]["name"] == torch.cuda.get_device_name()
    assert res["_device"]["power_limit"].endswith(" W"), res["_device"]


@pytest.mark.parametrize("bench", ["run_pipeline_batch_bench", "run_decode_batch_bench"])
def test_batch_benches(cuda, bench):
    from datacomp_tpu_torch.benchmark import kernels

    rows = getattr(kernels, bench)(1, "text", (1, 3))
    assert [r["batch"] for r in rows.values()] == [1, 3]
    assert all(r["compute_ms_per_chunk"] > 0 and r["call_ms"] > 0 for r in rows.values())


def test_batch_benches_share_their_chunks(cuda):
    """``bench --batched`` makes the chunks once and gives both benches the
    same ones; too few rows, or rows of another size, raise."""
    from datacomp_tpu_torch.benchmark import kernels

    blob = kernels.batch_chunks(1, "text", 3)
    for bench in (kernels.run_pipeline_batch_bench, kernels.run_decode_batch_bench):
        rows = bench(1, "text", (1, 3), blob=blob)
        assert [r["batch"] for r in rows.values()] == [1, 3]
        with pytest.raises(ValueError, match="need at least 4 rows"):
            bench(1, "text", (1, 4), blob=blob)
        with pytest.raises(ValueError, match="of 2 MiB"):
            bench(2, "text", (1, 3), blob=blob)


def test_suite_gpu_row_names_the_card(cuda, monkeypatch):
    from datacomp_tpu_torch.benchmark import BenchmarkSuite

    monkeypatch.delenv("DATACOMP_DEVICE_PLATFORM", raising=False)
    cfg = datacomp_tpu_torch.config.load_config(
        compression={"chunk_size_mb": 1},
        benchmark={"warmup_iterations": 0, "measurement_iterations": 1})
    res = BenchmarkSuite(cfg).run_full_suite(size_mb=1)
    gpu = f"GPU ({torch.cuda.get_device_name()})"
    assert [r.service_name for r in res] == ["CPU", "CPU", gpu, gpu]
    assert res[0].compressed_size == res[2].compressed_size


def test_corpus_bench_gpu_gives_the_cpu_sizes(cuda, tmp_path, monkeypatch):
    from datacomp_tpu_torch.benchmark.corpus import run_corpus_bench
    from datacomp_tpu_torch.utils.testdata import generate_corpus

    monkeypatch.delenv("DATACOMP_DEVICE_PLATFORM", raising=False)
    generate_corpus(str(tmp_path), scale=1 / 64)
    reports = {b: run_corpus_bench(str(tmp_path), backend=b) for b in ("gpu", "cpu")}
    sizes = {b: {r["file"]: r["compressed_bytes"] for r in rep["files"]}
             for b, rep in reports.items()}
    assert len(sizes["gpu"]) == 7 and sizes["gpu"] == sizes["cpu"]


def test_resume_on_the_card_equals_one_shot(cuda, tmp_path, monkeypatch):
    from datacomp_tpu_torch import cli
    from datacomp_tpu_torch.services import pipeline

    monkeypatch.delenv("DATACOMP_DEVICE_PLATFORM", raising=False)
    src = tmp_path / "r.bin"
    src.write_bytes(generate_bytes("text", 4 << 20))
    one = str(tmp_path / "one.dcz")
    assert cli.main(["compress", str(src), one, "1", "--format", "2", "--codebook-mode", "fast",
                     "--no-verify"]) == 0
    with open(one, "rb") as f:
        full = f.read()
    header, _ = read_container(one)
    dcz = str(tmp_path / "cut.dcz")
    with open(dcz + pipeline.PARTIAL_SUFFIX, "wb") as f:
        pipeline._write_partial_header(f, header)
        for c in header.chunks[:2]:
            pipeline._append_partial_chunk(f, c)
    with open(dcz, "wb") as f:
        f.write(full[: header.chunks[1].compressed_offset + header.chunks[1].compressed_size])
    monkeypatch.setenv("DATACOMP_COMPRESSION_FORMAT_VERSION", "2")
    monkeypatch.setenv("DATACOMP_COMPRESSION_CODEBOOK_MODE", "fast")
    ops.reset_counters()
    assert cli.main(["resume", str(src), dcz, "1", "--last-chunk", "1"]) == 0
    launches = ops.COUNTERS["encode_batch"][0].value
    assert launches >= 1 and not any(c[1].value for c in ops.COUNTERS.values())
    with open(dcz, "rb") as f:
        assert f.read() == full


_GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
with open(os.path.join(_GOLDEN_DIR, "hashes.json")) as _f:
    _GOLDEN = json.load(_f)


@pytest.mark.parametrize("name", sorted(_GOLDEN))
def test_golden_fixtures_on_the_card(cuda, tmp_path, name):
    """``tests/test_torch_golden.py`` on the card: the input in java v1
    through K2 to its pinned size and SHA-256 (and checked-in archive); in
    fast v2 through K2 and K3 back to itself, the ``.dcz`` equal to the host
    codec's; the checked-in archive (v1: the gap finder and K3, or the host
    decode route past 16 bits) decoded and deep-verified.  One chunk a
    launch, no plain version."""
    from datacomp_tpu_torch.services import gpu_service

    spec = _GOLDEN[name]
    data = generate_bytes(spec["input_kind"], spec["input_size"])
    src = tmp_path / name
    src.write_bytes(data)
    os.utime(src, (1_700_000_000, 1_700_000_000))  # tests/test_golden.py's mtime
    archive = os.path.join(_GOLDEN_DIR, name + ".dcz")
    for version, mode in ((1, "java"), (2, "fast")):
        comp = {"chunk_size_mb": spec["chunk_mb"], "format_version": version,
                "codebook_mode": mode}
        cfg = datacomp_tpu_torch.config.load_config(compression=comp, device={"batch_chunks": 1})
        dcz, out = str(tmp_path / f"v{version}.dcz"), str(tmp_path / f"v{version}.out")
        ops.reset_counters()
        with GpuCompressionService(cfg, device="cuda") as svc:
            svc.compress(str(src), dcz)
            svc.decompress(dcz, out)
        blob = open(dcz, "rb").read()
        assert open(out, "rb").read() == data
        assert not any(c[1].value for c in ops.COUNTERS.values())
        header, _ = read_container(dcz)
        coded = [ops.max_code_len(c.code_lengths) for c in header.chunks
                 if c.code_lengths.any()]
        assert ops.COUNTERS["encode_batch"][0].value == len(coded)
        if version == 1:
            assert len(blob) == spec["dcz_size"]
            assert hashlib.sha256(blob).hexdigest() == spec["dcz_sha256"]
            if os.path.exists(archive):
                assert blob == open(archive, "rb").read()
        else:
            host = str(tmp_path / "host.dcz")
            with PortCpuService(cfg) as svc:
                svc.compress(str(src), host)
            assert blob == open(host, "rb").read()
            assert ops.COUNTERS["decode_batch"][0].value == sum(
                0 < d <= ops.TABLE_BITS for d in coded)
    if os.path.exists(archive):
        gpu_service.host_decode_routes.reset()
        ops.reset_counters()
        cfg = datacomp_tpu_torch.config.load_config(device={"batch_chunks": 1})
        with GpuCompressionService(cfg, device="cuda") as svc:
            assert svc.verify_integrity(archive, deep=True)
            svc.decompress(archive, str(tmp_path / "archive.out"))
        assert (tmp_path / "archive.out").read_bytes() == data
        depths = [ops.max_code_len(c.code_lengths) for c in read_container(archive)[0].chunks]
        shallow = sum(1 for d in depths if 0 < d <= ops.TABLE_BITS)
        assert gpu_service.host_decode_routes.value == 2 * (len(depths) - shallow)
        assert ops.COUNTERS["find_gaps"][0].value == 2 * shallow
        assert not any(c[1].value for c in ops.COUNTERS.values())


def test_bench_gpu_leg_on_the_card(cuda, tmp_path, monkeypatch):
    """The headline's ``gpu`` leg at 4 MB in 1 MiB chunks: its ``.dcz`` is the
    plain versions', every link field is a positive number, and the device
    is the card."""
    from datacomp_tpu_torch import bench

    monkeypatch.delenv("DATACOMP_DEVICE_PLATFORM", raising=False)
    src = str(tmp_path / "bench.bin")
    bench.write_corpus(src, 4)
    ops.reset_counters()
    result, link, device = bench.gpu_leg(src, str(tmp_path), 1, 1)
    assert device.type == "cuda"
    assert ops.COUNTERS["encode_batch"][0].value and ops.COUNTERS["decode_batch"][0].value
    assert not any(c[1].value for c in ops.COUNTERS.values())
    assert set(link) == set(bench.LINK_KEYS) and all(v >= 0 for v in link.values())
    assert all(link[k] > 0 for k in bench.LINK_KEYS if "mbps" in k or "ceiling" in k)
    with GpuCompressionService(bench.gpu_config(1), device="cpu") as svc:
        svc.compress(src, str(tmp_path / "plain.dcz"))
    assert (tmp_path / "g.dcz").read_bytes() == (tmp_path / "plain.dcz").read_bytes()
    assert result["ratio"] == round(os.path.getsize(tmp_path / "g.dcz") / (4 << 20), 4)
    assert bench.device_fields(device)["name"] == torch.cuda.get_device_name(device)
