"""The port's ``parallel/`` on the CPU, in one process (a mesh of one rank,
or a mesh object of two for the checks that raise before any collective):
the numpy host helpers against the JAX package's, the sharded compress and
decompress steps against the JAX package's on its virtual 8-device mesh,
their checks, ``pick_device``'s choice of device, and the CLI's ``--sharded``
verbs at world size 1 against the unsharded ones.  The processes of a real
two-rank job are in ``tests/test_torch_multihost.py``.  Inputs are made from
seeds; everything compared is integers or bytes, so every comparison is
exact (tolerance 0).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import datacomp_tpu.core as jax_core  # noqa: E402
import datacomp_tpu.parallel as jax_parallel  # noqa: E402
import datacomp_tpu_torch.core as port_core  # noqa: E402
from datacomp_tpu.ops import payload_to_words, words_to_bytes  # noqa: E402
from datacomp_tpu.utils.testdata import generate_bytes  # noqa: E402
from datacomp_tpu_torch import cli, ops, parallel  # noqa: E402
from datacomp_tpu_torch.services import gpu_service, pick_device  # noqa: E402

CH = 16384  # tests/test_parallel.py's rows: 16 KiB, sub-blocks of 512
SUB = 512


@pytest.fixture(scope="module")
def mesh1():
    return parallel.make_mesh(device="cpu")


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return jax_parallel.make_mesh(8)


def _batch(rows: int):
    """``tests/test_parallel.py``'s batch: ``rows`` 16 KiB rows of text, the
    last one ragged (777 bytes)."""
    batch = np.frombuffer(generate_bytes("text", rows * CH), np.uint8).reshape(rows, CH).copy()
    valid = np.full(rows, CH, np.int32)
    valid[-1] = 777
    return batch, valid


def _metas(core, rng, n: int, v2: bool) -> list:
    return [core.ChunkMeta(i, i * 1000, 1000 - i, int(rng.integers(0, 1 << 20)),
                           int(rng.integers(1, 900)), rng.bytes(32),
                           rng.integers(0, 17, 256).astype(np.int32),
                           rng.integers(0, 1 << 20, 3).astype(np.uint32) if v2 else None)
            for i in range(n)]


@pytest.mark.parametrize("helper", ["assignment", "offsets", "interleave", "header", "footer"])
def test_host_helpers_equal_jax(helper, tmp_path):
    rng = np.random.default_rng(7)
    if helper == "assignment":
        for hosts, chunks in ((1, 5), (2, 5), (3, 11), (4, 2), (2, 0)):
            for h in range(hosts):
                got = parallel.ChunkAssignment(h, hosts, chunks)
                want = jax_parallel.ChunkAssignment(h, hosts, chunks)
                assert got.local_chunks() == want.local_chunks()
            assert all(parallel.ChunkAssignment.owner_of(ci, hosts)
                       == jax_parallel.ChunkAssignment.owner_of(ci, hosts) for ci in range(chunks))
    elif helper == "offsets":
        sizes = rng.integers(0, 1 << 30, 37)
        assert np.array_equal(parallel.global_offsets(sizes), jax_parallel.global_offsets(sizes))
    elif helper == "interleave":
        per_host = [list(rng.integers(0, 1 << 20, 4)), list(rng.integers(0, 1 << 20, 4)),
                    list(rng.integers(0, 1 << 20, 3)) + [0]]
        assert np.array_equal(parallel.interleave_gathered(per_host, 11),
                              jax_parallel.interleave_gathered(per_host, 11))
    else:
        for version, v2 in ((1, False), (2, True)):
            seed = int(rng.integers(1 << 30))
            got = parallel.assemble_header("in.bin", 123_456, 1_700_000_000_123, 1 << 20,
                                           _metas(port_core, np.random.default_rng(seed), 5, v2),
                                           version=version, subblock=SUB if v2 else 0)
            want = jax_parallel.assemble_header("in.bin", 123_456, 1_700_000_000_123, 1 << 20,
                                                _metas(jax_core, np.random.default_rng(seed), 5, v2),
                                                version=version, subblock=SUB if v2 else 0)
            if helper == "header":
                assert port_core.serialize_footer(got) == jax_core.serialize_footer(want)
                continue
            files = []
            for name, write, header in (("port", parallel.write_footer_host0, got),
                                        ("jax", jax_parallel.write_footer_host0, want)):
                path = tmp_path / f"{name}{version}.dcz"
                path.write_bytes(rng.bytes(4000))  # payloads, and a tail that the footer cuts
                write(str(path), header, 3000)
                files.append(path.read_bytes())
            assert files[0][3000:] == files[1][3000:] and len(files[0]) == len(files[1])


@pytest.mark.parametrize("rows", [16, 24])  # one launch of each kernel; then two (16 + 8)
def test_sharded_compress_arrays_equals_jax(mesh1, mesh8, rows):
    batch, valid = _batch(rows)
    before = ops.COUNTERS["encode_batch"][1].value
    got = parallel.sharded_compress_arrays(mesh1, batch, valid, subblock=SUB)
    assert ops.COUNTERS["encode_batch"][1].value == before + -(-rows // ops.MAX_ROWS)
    want = jax_parallel.sharded_compress_arrays(mesh8, batch, valid, subblock=SUB)
    names = ("hists", "lengths", "codes", "words", "total_bits", "gaps", "comp_bytes", "offsets")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert np.array_equal(g.numpy().astype(np.int64), w.astype(np.int64)), name
    sizes = [len(words_to_bytes(got[3][b].numpy(), int(got[4][b]))) for b in range(rows)]
    assert got[6].tolist() == sizes and got[7].tolist() == np.cumsum([0] + sizes[:-1]).tolist()


def _two_ranks(rank: int) -> parallel.Mesh:
    """Rank ``rank`` of a job of two, with no process group: enough for the
    checks that raise before the step's collective."""
    return parallel.Mesh(rank, 2, torch.device("cpu"))


@pytest.mark.parametrize("case", ["uneven batch", "rows against global rows", "valid length"])
def test_sharded_compress_rejects_before_the_collective(case):
    batch, valid = _batch(4)
    mesh = _two_ranks(1)
    with pytest.raises(ValueError):
        if case == "uneven batch":  # tests/test_parallel.py::test_uneven_batch_rejected
            parallel.sharded_compress_arrays(mesh, batch[:3], valid[:3], subblock=SUB)
        step = parallel.make_sharded_compress_step(mesh, CH, SUB)
        x = torch.from_numpy(batch[:2])
        if case == "rows against global rows":  # the other rank holds 3
            step(x, valid[:2], 5)
        else:
            step(x, [CH, CH + 1], 4)


def _encoded(mesh1, rows: int):
    """``rows`` rows through the port's sharded step: (batch, valid, streams
    as ``payload_to_words`` padded to one width, gap arrays, lengths)."""
    batch, valid = _batch(rows)
    _, lengths, _, words, total_bits, gaps, _, _ = (
        t.numpy() for t in parallel.sharded_compress_arrays(mesh1, batch, valid, subblock=SUB))
    streams = [payload_to_words(words_to_bytes(words[b], int(total_bits[b]))) for b in range(rows)]
    wbatch = np.zeros((rows, max(w.size for w in streams)), np.uint32)
    for b, w in enumerate(streams):
        wbatch[b, : w.size] = w
    return batch, valid, wbatch, gaps, [lengths[b] for b in range(rows)]


def test_sharded_decompress_arrays_equals_jax(mesh1, mesh8):
    batch, valid, wbatch, gaps, lengths = _encoded(mesh1, 8)
    got = parallel.sharded_decompress_arrays(mesh1, wbatch, gaps, lengths, SUB, valid)
    want = np.asarray(jax_parallel.sharded_decompress_arrays(mesh8, wbatch, gaps, lengths, SUB))
    for b, v in enumerate(valid):
        assert got[b].numel() == v
        assert np.array_equal(got[b].numpy(), want[b, :v])
        assert np.array_equal(got[b].numpy(), batch[b, :v])


def test_sharded_decompress_splits_launches_and_rows(mesh1):
    """24 rows decode in two launches (16 + 8); rank 1 of 2 takes the second
    half of the rows."""
    batch, valid, wbatch, gaps, lengths = _encoded(mesh1, 24)
    before = ops.COUNTERS["decode_batch"][1].value
    got = parallel.sharded_decompress_arrays(mesh1, wbatch, gaps, lengths, SUB, valid)
    assert ops.COUNTERS["decode_batch"][1].value == before + 2
    assert all(np.array_equal(g.numpy(), batch[b, :v]) for b, (g, v) in enumerate(zip(got, valid)))
    half = parallel.sharded_decompress_arrays(_two_ranks(1), wbatch, gaps, lengths, SUB, valid)
    assert all(np.array_equal(g.numpy(), batch[12 + b, : valid[12 + b]])
               for b, g in enumerate(half))


def test_deep_codebook_is_refused(mesh1):
    shallow, deep = np.zeros(256, np.int32), np.zeros(256, np.int32)
    shallow[:4] = 2
    deep[:2] = 17
    parallel.check_decompress_step_params([shallow], SUB)
    with pytest.raises(ValueError, match="16"):
        parallel.check_decompress_step_params([shallow, deep], SUB)
    words = np.zeros((2, 4), np.uint32)
    before = ops.COUNTERS["decode_batch"][1].value
    with pytest.raises(ValueError, match="17-bit"):
        parallel.sharded_decompress_arrays(mesh1, words, np.zeros((2, 1), np.uint32),
                                           [shallow, deep], SUB, [8, 8])
    assert ops.COUNTERS["decode_batch"][1].value == before


def test_mesh_of_one():
    mesh = parallel.make_mesh(1, device="cpu")
    assert (mesh.rank, mesh.size, mesh.device, mesh.group, mesh.host_group) == (
        0, 1, torch.device("cpu"), None, None)
    with pytest.raises(ValueError, match="requested 2 ranks"):
        parallel.make_mesh(2, device="cpu")
    parallel.initialize_distributed()  # world size 1: nothing to initialise
    assert not torch.distributed.is_initialized()


@pytest.fixture
def one_gpu(monkeypatch):
    """``torch.cuda`` reporting one device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_RANK", raising=False)


@pytest.mark.parametrize("local_rank,index,want", [
    (None, -1, 0), ("0", -1, 0), (None, 0, 0), ("3", 0, 0),  # an explicit index wins
    (None, 1, "device.device_index 1"), ("1", -1, "LOCAL_RANK 1"), (None, -2, "index -2"),
])
def test_pick_device(one_gpu, monkeypatch, local_rank, index, want):
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    if isinstance(want, int):
        assert pick_device("any", index) == torch.device("cuda", want)
    else:
        with pytest.raises(RuntimeError, match=f"{want} names no CUDA device: this process sees 1"):
            pick_device("any", index)
    assert pick_device("cpu", index) == torch.device("cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three 1 MiB chunks and a tail: text, random (stored raw in v2),
    skewed, compressible."""
    d = tmp_path_factory.mktemp("sharded_cli")
    src = d / "in.bin"
    src.write_bytes(generate_bytes("text", 1 << 20) + generate_bytes("random", 1 << 20)
                    + generate_bytes("skewed", 1 << 20) + generate_bytes("compressible", 12345))
    return d, str(src)


@pytest.mark.parametrize("args", [["--format", "2", "--codebook-mode", "device"],
                                  ["--format", "2", "--codebook-mode", "fast"],
                                  ["--format", "1"]])
def test_cli_sharded_equals_unsharded(corpus, monkeypatch, capsys, args):
    d, src = corpus
    monkeypatch.setenv("DATACOMP_DEVICE_PLATFORM", "cpu")
    tag = "-".join(args).replace("-", "")
    plain, sharded = str(d / f"{tag}.dcz"), str(d / f"{tag}-sharded.dcz")
    assert cli.main(["compress", src, plain, "1", *args, "--no-verify"]) == 0
    assert cli.main(["compress", src, sharded, "1", *args, "--sharded"]) == 0
    out = capsys.readouterr().out
    assert "sharded compress degrades" in out and "Verify:     OK" in out
    with open(plain, "rb") as f, open(sharded, "rb") as g:
        assert f.read() == g.read()
    restored = [str(d / f"{tag}.out"), str(d / f"{tag}-sharded.out")]
    assert cli.main(["decompress", sharded, restored[0], "1"]) == 0
    assert cli.main(["decompress", sharded, restored[1], "1", "--sharded"]) == 0
    with open(src, "rb") as f:
        data = f.read()
    for path in restored:
        with open(path, "rb") as f:
            assert f.read() == data


def test_cli_sharded_decompress_honours_force_cpu(corpus, monkeypatch, capsys):
    """``DATACOMP_DEVICE_FORCE_CPU`` selects the host codec: no device is
    picked (there is none here to pick) and no op of the port runs."""
    d, src = corpus
    dcz, out = str(d / "force.dcz"), str(d / "force.out")
    monkeypatch.setenv("DATACOMP_DEVICE_FORCE_CPU", "1")
    assert cli.main(["compress", src, dcz, "1", "--format", "2", "--sharded", "--no-verify"]) == 0
    calls = [c.value for pair in ops.COUNTERS.values() for c in pair]
    routes = gpu_service.host_decode_routes.value
    assert cli.main(["decompress", dcz, out, "1", "--sharded", "--stages"]) == 0
    with open(src, "rb") as f, open(out, "rb") as g:
        assert f.read() == g.read()
    assert [c.value for pair in ops.COUNTERS.values() for c in pair] == calls
    assert gpu_service.host_decode_routes.value == routes
    assert '"host_decode_routes": 0' in capsys.readouterr().out
