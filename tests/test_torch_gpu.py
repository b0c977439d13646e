"""The port's CUDA kernels against their plain PyTorch versions, on the card,
at small edge-case shapes (ragged lengths, ``valid_len`` masks, one-symbol,
16-bit and 32-bit codebooks, dropped writes, short last sub-blocks), and the
GPU service's output against the host codec's.  Exact equality throughout.

Also K4 (the codebook) and K1's A/B variants against their plain versions,
K2 on a codebook deeper than 32 bits, and one 16 MiB chunk through the
device-codebook mode.

Marked ``gpu``: every test skips without a CUDA device.  On a machine with
one (and no jax, which ``tests/conftest.py`` imports):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

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
                   *(f"random{i}" for i in range(8)), "text", "skewed", "compressible"]


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
    elif name != "empty":
        data = np.frombuffer(generate_bytes(name, 1 << 20), np.uint8)
        hist = np.bincount(data, minlength=256).astype(np.int32)
    return hist


@pytest.mark.parametrize("name", _CODEBOOK_CASES)
def test_codebook_kernel_matches_plain(cuda, name):
    h = torch.from_numpy(_codebook_histogram(name)).to(cuda)
    kl, kc = ops.codebook(h)
    rl, rc = ops.codebook_reference(h)
    assert _same(kl, rl)
    if int(rl.max()) <= 32:
        assert _same(kc, rc)
        if rl.any():
            assert np.array_equal(kc.cpu().numpy(),
                                  canonical_codes_from_lengths(kl.cpu().numpy()))


@pytest.mark.parametrize("n,valid_len", [
    (16, 16), (1000, 999), (65_536 + 3, 65_536 + 3), (1 << 20, (1 << 20) - 12_345)])
@pytest.mark.parametrize("kind", ["random", "zeros", "skewed"])
@pytest.mark.parametrize("variant", ["stacked", "stacked8", "stacked-i16",
                                     "partial-k1", "partial-k2", "partial-k4", "partial-k8"])
def test_histogram_variants_match_plain(cuda, variant, kind, n, valid_len):
    if kind == "random":
        host = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    elif kind == "zeros":  # one symbol: every 8-bit counter fills up
        host = np.zeros(n, np.uint8)
    else:
        host = np.frombuffer(generate_bytes("skewed", n), np.uint8).copy()
    x = torch.from_numpy(host).to(cuda)
    if variant.startswith("partial"):
        got = ops.histogram_partial(x, valid_len, int(variant.rsplit("k", 1)[1]))
    else:
        got = ops.histogram_stacked(x, valid_len, *ops.STACKED[variant])
    assert _same(got, ops.histogram_reference(x, valid_len))
    assert np.array_equal(got.cpu().numpy(), np.bincount(host[:valid_len], minlength=256))


def test_device_codebook_mode_16mib_round_trip(cuda, tmp_path):
    """One 16 MiB text chunk in device mode v2: the lengths in the container
    are K4's plain version on the chunk's histogram, and it round-trips."""
    data = generate_bytes("text", 16 << 20)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    cfg = datacomp_tpu_torch.config.load_config(compression={
        "chunk_size_mb": 16, "format_version": 2, "codebook_mode": "device"})
    launches = ops.COUNTERS["codebook"][0].value
    with GpuCompressionService(cfg, device="cuda") as svc:
        svc.compress(str(src), str(tmp_path / "g.dcz"))
        svc.decompress(str(tmp_path / "g.dcz"), str(tmp_path / "g.out"))
    assert (tmp_path / "g.out").read_bytes() == data
    assert ops.COUNTERS["codebook"][0].value == launches + 1
    header, _ = read_container(str(tmp_path / "g.dcz"))
    hist = np.bincount(np.frombuffer(data, np.uint8), minlength=256).astype(np.int32)
    want, _ = ops.codebook_reference(torch.from_numpy(hist))
    assert np.array_equal(header.chunks[0].code_lengths, want.numpy())
