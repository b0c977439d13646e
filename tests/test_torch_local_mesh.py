"""The local level of the port's mesh on the CPU: a process that drives
several devices (``parallel.make_mesh(devices=...)``, here several ``cpu``
entries, so the kernels' plain versions run).  The sharded compress and
decompress steps over 2 and 3 local devices against a mesh of one and the
JAX package's steps over a JAX CPU mesh of as many devices (the suite's
``tests/conftest.py`` gives 8 virtual ones); ``compress_multihost`` /
``decompress_multihost`` through the local path against the JAX package's
mesh path, the port's single-device service and the host codec; the CLI's
``--sharded`` over two local devices; the step's checks; and the rules by
which a process picks its local devices (on a monkeypatched device count).
Inputs are made from seeds; everything compared is integers or bytes, so
every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import datacomp_tpu.config  # noqa: E402
import datacomp_tpu.parallel as jax_parallel  # noqa: E402
import datacomp_tpu_torch.config  # noqa: E402
from datacomp_tpu.parallel.multihost import compress_multihost as jax_compress_multihost  # noqa: E402
from datacomp_tpu.utils.testdata import generate_bytes  # noqa: E402
from datacomp_tpu_torch import cli, ops, parallel  # noqa: E402
from datacomp_tpu_torch.core import read_container  # noqa: E402
from datacomp_tpu_torch.ops import TABLE_BITS, max_code_len, payload_to_words, words_to_bytes  # noqa: E402
from datacomp_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from datacomp_tpu_torch.services import (  # noqa: E402
    CpuCompressionService, GpuCompressionService, gpu_service,
)

CH, SUB = 16384, 512  # tests/test_parallel.py's rows: 16 KiB, sub-blocks of 512
S = 256  # sub-block symbols of the files here
CPU = torch.device("cpu")
NAMES = ("hists", "lengths", "codes", "words", "total_bits", "gaps", "comp_bytes", "offsets")


def _local(n: int) -> parallel.Mesh:
    return parallel.make_mesh(devices=["cpu"] * n)


def _batch(rows: int, empty: bool = True):
    """``rows`` 16 KiB rows of text, the last ragged (777 bytes) and, with
    ``empty``, the second empty (the local file path's idle devices)."""
    batch = np.frombuffer(generate_bytes("text", rows * CH, seed=3), np.uint8)
    batch = batch.reshape(rows, CH).copy()
    valid = np.full(rows, CH, np.int32)
    valid[-1] = 777
    if empty:
        valid[1] = 0
    return batch, valid


@pytest.fixture(scope="module")
def jax_meshes():
    if len(jax.devices()) < 3:
        pytest.skip("needs 3 (virtual) devices")
    return {n: jax_parallel.make_mesh(n) for n in (2, 3)}


def _plain_calls() -> dict:
    return {name: r.value for name, (_, r) in ops.COUNTERS.items()}


@pytest.mark.parametrize("n", [2, 3])
def test_local_compress_step_equals_mesh_of_one_and_jax(jax_meshes, n):
    batch, valid = _batch(6)
    before = _plain_calls()
    got = parallel.sharded_compress_arrays(_local(n), batch, valid, subblock=SUB)
    calls = {k: v - before[k] for k, v in _plain_calls().items() if v - before[k]}
    assert calls == {k: n for k in ("histogram_batch", "codebook_batch", "encode_batch")}
    one = parallel.sharded_compress_arrays(_local(1), batch, valid, subblock=SUB)
    want = jax_parallel.sharded_compress_arrays(jax_meshes[n], batch, valid, subblock=SUB)
    for name, g, o, w in zip(NAMES, got, one, want):
        w = np.asarray(w)
        assert g.shape == o.shape == w.shape, name
        assert torch.equal(g, o), name
        assert np.array_equal(g.numpy().astype(np.int64), w.astype(np.int64)), name


def test_local_compress_step_returns_each_device_its_rows():
    """The step's sequence form: one output tuple for each local device, its
    rows in order, offsets global over the devices."""
    batch, valid = _batch(4)
    mesh = _local(2)
    step = parallel.make_sharded_compress_step(mesh, CH, SUB)
    outs = step([torch.from_numpy(batch[:2]), torch.from_numpy(batch[2:])], valid, 4)
    whole = parallel.sharded_compress_arrays(_local(1), batch, valid, subblock=SUB)
    assert len(outs) == 2
    for k, name in enumerate(NAMES):
        assert torch.equal(torch.cat([outs[0][k], outs[1][k]]), whole[k]), name


@pytest.mark.parametrize("case", ["rows over devices", "shards", "shard shape", "valid length"])
def test_local_compress_step_rejects_before_any_launch(case):
    batch, valid = _batch(4)
    step = parallel.make_sharded_compress_step(_local(3 if case == "rows over devices" else 2),
                                               CH, SUB)
    x = [torch.from_numpy(batch[:2]), torch.from_numpy(batch[2:])]
    before = _plain_calls()
    with pytest.raises(ValueError):
        if case == "rows over devices":
            step(x + [torch.from_numpy(batch[:0])], valid, 4)
        elif case == "shards":
            step(x[:1], valid[:2], 2)
        elif case == "shard shape":
            step([x[0], x[1][:1]], valid, 4)
        else:
            step(x, [CH, CH, 5, CH + 1], 4)
    assert _plain_calls() == before
    with pytest.raises(ValueError, match="do not divide over 1 ranks of 3 local devices"):
        parallel.sharded_compress_arrays(_local(3), batch, valid, subblock=SUB)


def _encoded(rows: int):
    """``rows`` rows through the one-device step: (batch, valid, streams as
    ``payload_to_words`` padded to one width, gap arrays, lengths)."""
    batch, valid = _batch(rows, empty=False)
    _, lengths, _, words, total_bits, gaps, _, _ = (
        t.numpy() for t in parallel.sharded_compress_arrays(_local(1), batch, valid, SUB))
    streams = [payload_to_words(words_to_bytes(words[b], int(total_bits[b]))) for b in range(rows)]
    wbatch = np.zeros((rows, max(w.size for w in streams)), np.uint32)
    for b, w in enumerate(streams):
        wbatch[b, : w.size] = w
    return batch, valid, wbatch, gaps, [lengths[b] for b in range(rows)]


@pytest.mark.parametrize("n", [2, 3])
def test_local_decompress_step_equals_mesh_of_one_and_jax(jax_meshes, n):
    batch, valid, wbatch, gaps, lengths = _encoded(6)
    before = _plain_calls()["decode_batch"]
    got = parallel.sharded_decompress_arrays(_local(n), wbatch, gaps, lengths, SUB, valid)
    assert _plain_calls()["decode_batch"] == before + n  # one launch a device
    one = parallel.sharded_decompress_arrays(_local(1), wbatch, gaps, lengths, SUB, valid)
    want = np.asarray(jax_parallel.sharded_decompress_arrays(jax_meshes[n], wbatch, gaps,
                                                             lengths, SUB))
    for b, v in enumerate(valid):
        assert got[b].numel() == v and torch.equal(got[b], one[b])
        assert np.array_equal(got[b].numpy(), want[b, :v])
        assert np.array_equal(got[b].numpy(), batch[b, :v])


def test_local_decompress_step_leaves_devices_past_its_rows_idle():
    """Rows for the first device alone: the second launches nothing."""
    batch, valid, wbatch, gaps, lengths = _encoded(2)
    mesh = _local(2)
    tables = [ops.build_decode_tables(lens) for lens in lengths]
    limits, adj, sym = ops.decode_tables_to_torch(
        *(np.stack([t[k] for t in tables]) for k in range(3)), CPU)
    nsubs = [-(-int(v) // SUB) for v in valid]
    before = _plain_calls()["decode_batch"]
    outs = parallel.make_sharded_decompress_step(mesh, SUB)(
        [torch.from_numpy(wbatch.reshape(-1))], [[0, wbatch.shape[1], wbatch.size]],
        [torch.from_numpy(np.concatenate([gaps[b, :k] for b, k in enumerate(nsubs)]))],
        [np.cumsum([0] + nsubs)], [limits], [adj], [sym], [[int(v) for v in valid]])
    assert _plain_calls()["decode_batch"] == before + 1 and len(outs) == 1
    assert np.array_equal(outs[0].numpy(), np.concatenate([batch[b, :v] for b, v in
                                                           enumerate(valid)]))


def _mixed() -> bytes:
    """``tests/test_multihost.py``'s file: text, random (stored raw in v2),
    skewed (deeper than 16 bits uncapped) and a ragged tail."""
    return (generate_bytes("text", 1 << 20) + generate_bytes("random", 1 << 20)
            + generate_bytes("skewed", 1 << 20) + generate_bytes("compressible", 12345))


def _cfg(batch: int = 0, **comp):
    return datacomp_tpu_torch.config.load_config(
        compression={"chunk_size_mb": 1, "subblock_symbols": S, **comp},
        device={"platform": "cpu", "batch_chunks": batch})


DEV2 = {"format_version": 2, "codebook_mode": "device"}
FAST2 = {"format_version": 2, "codebook_mode": "fast"}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The mixed file, and its device v2 and fast v2 ``.dcz`` through a local
    mesh of two, with the plain calls and host routes of each compress."""
    d = tmp_path_factory.mktemp("local_mesh")
    (d / "mixed.bin").write_bytes(_mixed())
    counts = {}
    for name, comp in (("dev2", DEV2), ("fast2", FAST2)):
        before = _plain_calls()
        parallel.compress_multihost(str(d / "mixed.bin"), str(d / f"{name}.dcz"), _cfg(**comp),
                                    backend="gpu", mesh=_local(2))
        counts[name] = {k: v - before[k] for k, v in _plain_calls().items() if v - before[k]}
    return d, counts


@pytest.mark.parametrize("reference", ["jax mesh of 2", "port service"])
def test_local_device_v2_file(files, reference):
    """The local path (one chunk a device, groups of two) writes the JAX
    package's mesh file and the port's single-device file; each group with a
    member on the device ran each kernel once a device."""
    d, counts = files
    ref = str(d / f"ref-{reference.replace(' ', '-')}.dcz")
    if reference == "jax mesh of 2":
        jcfg = datacomp_tpu.config.load_config(
            compression={"chunk_size_mb": 1, "subblock_symbols": S, **DEV2})
        jax_compress_multihost(str(d / "mixed.bin"), ref, jcfg, backend="tpu",
                               mesh=jax_parallel.make_mesh(2))
    else:
        with GpuCompressionService(_cfg(1, **DEV2), device="cpu") as svc:
            svc.compress(str(d / "mixed.bin"), ref)
    assert (d / "dev2.dcz").read_bytes() == open(ref, "rb").read()
    # groups [text, random (raw)] and [skewed, tail]: both reach the device
    assert counts["dev2"] == {k: 4 for k in ("histogram_batch", "codebook_batch", "encode_batch")}


def test_local_fast_v2_file_is_the_host_codecs(files):
    """Host codebooks take the single-device path (the step builds device
    codebooks only): the host codec's file."""
    d, counts = files
    with CpuCompressionService(_cfg(**FAST2)) as svc:
        svc.compress(str(d / "mixed.bin"), str(d / "ref-fast2.dcz"))
    assert (d / "fast2.dcz").read_bytes() == (d / "ref-fast2.dcz").read_bytes()
    assert set(counts["fast2"]) == {"encode"}  # batch 1 on the CPU: a launch a chunk


def test_local_encode_raises_on_a_wrong_total(files, monkeypatch):
    """A device total other than the prepass's optimal bits raises, as on
    one device, even one that reaches the chunk's raw size: the local path
    has no raw store of its own that would write a different file."""
    d, _ = files
    real = ops.encode_batch

    def raw_sized(x, valid, *args):
        words, total_bits, gaps = real(x, valid, *args)
        return words, torch.tensor(valid, dtype=total_bits.dtype) * 8, gaps

    monkeypatch.setattr(ops, "encode_batch", raw_sized)
    with pytest.raises(RuntimeError, match=f"wrote {8 << 20} bits; the codebook predicts"):
        parallel.compress_multihost(str(d / "mixed.bin"), str(d / "wrong.dcz"), _cfg(**DEV2),
                                    backend="gpu", mesh=_local(2))


@pytest.mark.parametrize("name", ["dev2", "fast2"])
def test_local_decompress_restores(files, name):
    """Through the local path: raw chunks pass through, chunks deeper than
    16 bits take the counted host route, the rest one device each."""
    d, _ = files
    header, _ = read_container(str(d / f"{name}.dcz"))
    depths = [max_code_len(c.code_lengths) for c in header.chunks]
    before, routes = _plain_calls(), gpu_service.host_decode_routes.value
    parallel.decompress_multihost(str(d / f"{name}.dcz"), str(d / f"{name}.out"), _cfg(),
                                  backend="gpu", mesh=_local(2))
    assert (d / f"{name}.out").read_bytes() == (d / "mixed.bin").read_bytes()
    calls = {k: v - before[k] for k, v in _plain_calls().items() if v - before[k]}
    assert calls == {"decode_batch": sum(1 for dep in depths if 0 < dep <= TABLE_BITS)}
    assert gpu_service.host_decode_routes.value - routes == sum(
        1 for dep in depths if dep > TABLE_BITS)


def test_cli_sharded_over_two_local_devices(files, monkeypatch, capsys):
    """``--sharded`` in a lone process that sees two devices: no one-device
    note, the single-device file, and the input restored."""
    d, _ = files
    monkeypatch.setenv("DATACOMP_DEVICE_PLATFORM", "cpu")
    monkeypatch.setattr(parallel, "local_devices", lambda config=None: (CPU, CPU))
    src, dcz, out, ref = (str(d / f) for f in ("mixed.bin", "cli.dcz", "cli.out", "cli-ref.dcz"))
    args = ["1", "--format", "2", "--codebook-mode", "device"]
    assert cli.main(["compress", src, ref, *args, "--no-verify"]) == 0
    assert cli.main(["compress", src, dcz, *args, "--sharded"]) == 0
    assert cli.main(["decompress", dcz, out, "1", "--sharded", "--stages"]) == 0
    text = capsys.readouterr().out
    assert "one local device" not in text and "Verify:     OK" in text
    assert open(dcz, "rb").read() == open(ref, "rb").read()
    assert open(out, "rb").read() == (d / "mixed.bin").read_bytes()


@pytest.fixture
def three_gpus(monkeypatch):
    """``torch.cuda`` reporting three devices, and no ``torchrun``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    for var in ("LOCAL_RANK", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("env,device,want", [
    ({}, {}, [0, 1, 2]),  # a lone process: every card
    ({}, {"device_index": 1}, [1]),  # an explicit index keeps one card
    ({"WORLD_SIZE": "2", "LOCAL_RANK": "1"}, {}, [1]),  # a torchrun rank: its own card
    ({"WORLD_SIZE": "1", "LOCAL_RANK": "0"}, {}, [0, 1, 2]),  # a job of one rank is alone
    ({}, {"platform": "cpu"}, "cpu"),
    ({}, {"force_cpu": True}, "cpu"),
])
def test_local_devices(three_gpus, monkeypatch, env, device, want):
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    got = parallel.local_devices(datacomp_tpu_torch.config.load_config(device=device))
    assert got == ((CPU,) if want == "cpu" else tuple(torch.device("cuda", i) for i in want))


def test_local_devices_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.local_devices(datacomp_tpu_torch.config.load_config())


def test_mesh_levels(three_gpus, monkeypatch):
    """A mesh of every card sets only the first as the current device; a job
    of several ranks that asks for several local devices raises."""
    current = []
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    mesh = parallel.make_mesh()
    assert mesh.local_devices == tuple(torch.device("cuda", i) for i in range(3))
    assert (mesh.rank, mesh.size, mesh.device) == (0, 1, torch.device("cuda", 0))
    assert current == [torch.device("cuda", 0)]
    assert parallel.Mesh(0, 1, CPU).local_devices == (CPU,)
    monkeypatch.setattr(mesh_mod.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh_mod.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(mesh_mod.dist, "get_rank", lambda: 0)
    with pytest.raises(ValueError, match="a job of 2 ranks drives one device a rank, not 2"):
        parallel.make_mesh(devices=["cpu", "cpu"])
