"""Real two-rank jobs of the port on the CPU: two processes on a gloo
process group (``file://`` store in the test's directory, so that parallel
test workers never share a port), started with ``subprocess``.

One job compresses ``tests/test_multihost.py``'s mixed corpus with
``compress_multihost`` in device v2 (``batch_chunks`` 4: each rank's stripe
is one batched group), fast v2, v1 and v1 on the host codec; decompresses
the device v2 file and a file with a Fibonacci chunk deeper than 16 bits
(``tests/test_multihost.py``'s) with ``decompress_multihost``; and runs the
sharded compress step at world size 2.  The tests hold its files to the
JAX package's mesh ``compress_multihost`` and the port's services, its
restored files to the inputs, and its step to the JAX step.  Another job
makes one rank's encode raise; others run the CLI's ``--sharded`` verbs
and ``tools.sharded_step`` under ``torchrun``.  A job that outlives its
timeout fails its test.
Everything compared is bytes or integers: exact (tolerance 0).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import datacomp_tpu.config  # noqa: E402
import datacomp_tpu.parallel as jax_parallel  # noqa: E402
import datacomp_tpu_torch.config  # noqa: E402
from datacomp_tpu.parallel.multihost import compress_multihost as jax_compress_multihost  # noqa: E402
from datacomp_tpu.utils.testdata import generate_bytes  # noqa: E402
from datacomp_tpu_torch import cli  # noqa: E402
from datacomp_tpu_torch.core import read_container  # noqa: E402
from datacomp_tpu_torch.ops import TABLE_BITS, max_code_len  # noqa: E402
from datacomp_tpu_torch.services import CpuCompressionService, GpuCompressionService  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds a job may take before its test fails
S = 256  # sub-block symbols of every file here
CH, STEP_SUB = 16384, 512  # the sharded step's rows (tests/test_parallel.py's)

#: compress_multihost's configurations: name -> (compression settings,
#: backend, batch_chunks)
FILES = {
    "dev2": ({"format_version": 2, "codebook_mode": "device"}, "gpu", 4),
    "fast2": ({"format_version": 2, "codebook_mode": "fast"}, "gpu", 0),
    "v1": ({"format_version": 1, "codebook_mode": "java"}, "gpu", 0),
    "v1-host": ({"format_version": 1, "codebook_mode": "java"}, "cpu", 0),
}

WORKER = r"""
import json, os, sys
import numpy as np
from datacomp_tpu_torch import parallel
from datacomp_tpu_torch.config import load_config
from datacomp_tpu_torch.services import gpu_service
from datacomp_tpu_torch.services.gpu_service import GpuChunkCodec

rank, store, d, job = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
files = json.loads(sys.argv[5])
parallel.initialize_distributed(f"file://{store}", 2, rank, device="cpu")
mesh = parallel.make_mesh(2, device="cpu")

def cfg(comp, batch):
    return load_config(compression={"chunk_size_mb": 1, "subblock_symbols": %(S)d, **comp},
                       device={"platform": "cpu", "batch_chunks": batch})

if job == "fail":
    def fail(self, datas, metrics):
        raise RuntimeError("injected encode failure")
    if rank == 1:
        GpuChunkCodec.encode_chunk_batch = fail
    comp, backend, batch = files["dev2"]
    parallel.compress_multihost(f"{d}/mixed.bin", f"{d}/fail.dcz", cfg(comp, batch), mesh=mesh)
else:
    for name, (comp, backend, batch) in files.items():
        parallel.compress_multihost(f"{d}/mixed.bin", f"{d}/{name}.dcz", cfg(comp, batch),
                                    backend=backend, mesh=mesh)
    routes = {}
    for name, batch in (("deep", 0), ("dev2", 4)):
        before = gpu_service.host_decode_routes.value
        parallel.decompress_multihost(f"{d}/{name}.dcz", f"{d}/{name}.out", cfg({}, batch),
                                      mesh=mesh)
        routes[name] = gpu_service.host_decode_routes.value - before
    data = np.load(f"{d}/step_in.npz")
    out = parallel.sharded_compress_arrays(mesh, data["batch"], data["valid"], %(STEP_SUB)d)
    np.savez(f"{d}/step{rank}.npz", *[t.numpy() for t in out])
    with open(f"{d}/rank{rank}.json", "w") as f:
        json.dump({"routes": routes}, f)
import torch.distributed as dist
dist.destroy_process_group()
""" % {"S": S, "STEP_SUB": STEP_SUB}


def _run_job(d, job: str) -> list:
    """Both ranks of ``job`` to their end: [(returncode, stderr)], rank by
    rank.  A rank still running after ``TIMEOUT`` fails the test."""
    script = d / "worker.py"
    script.write_text(WORKER)
    store = d / f"{job}.store"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, str(script), str(rank), str(store), str(d), job,
                               json.dumps(FILES)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for rank in (0, 1)]
    results = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            results.append((p.returncode, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the two-rank job {job!r} ran past {TIMEOUT} s")
    return results


def _mixed() -> bytes:
    """``tests/test_multihost.py:238-243``: three 1 MiB chunks and a ragged
    tail; the random chunk is stored raw in v2."""
    return (generate_bytes("text", 1 << 20) + generate_bytes("random", 1 << 20)
            + generate_bytes("skewed", 1 << 20) + generate_bytes("compressible", 12345))


def _deep() -> bytes:
    """``tests/test_multihost.py:297-307``: a Fibonacci-skewed chunk whose
    uncapped code is deeper than 16 bits among text, random and a tail."""
    fib = [1, 1]
    while len(fib) < 24:
        fib.append(fib[-1] + fib[-2])
    deep = b"".join(bytes([s]) * c for s, c in enumerate(fib))
    deep = (deep * ((1 << 20) // len(deep) + 1))[: 1 << 20]
    return (generate_bytes("text", 1 << 20) + generate_bytes("random", 1 << 20) + deep
            + generate_bytes("compressible", 54321))


def _port_cfg(batch: int = 0, **comp):
    return datacomp_tpu_torch.config.load_config(
        compression={"chunk_size_mb": 1, "subblock_symbols": S, **comp},
        device={"batch_chunks": batch})


def _step_input():
    batch = np.frombuffer(generate_bytes("text", 16 * CH), np.uint8).reshape(16, CH).copy()
    valid = np.full(16, CH, np.int32)
    valid[-1] = 777
    return batch, valid


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The main two-rank job's directory, after both ranks exited 0."""
    d = tmp_path_factory.mktemp("two_ranks")
    (d / "mixed.bin").write_bytes(_mixed())
    (d / "deep.bin").write_bytes(_deep())
    with CpuCompressionService(_port_cfg(format_version=2, max_code_len=32)) as svc:
        svc.compress(str(d / "deep.bin"), str(d / "deep.dcz"))
    batch, valid = _step_input()
    np.savez(d / "step_in.npz", batch=batch, valid=valid)
    for rank, (rc, err) in enumerate(_run_job(d, "main")):
        assert rc == 0, f"rank {rank} failed:\n{err[-3000:]}"
    return d


@pytest.mark.parametrize("reference", ["jax mesh", "service batch 1", "service batch 4"])
def test_two_rank_device_v2_file(job, reference):
    comp = FILES["dev2"][0]
    ref = str(job / f"ref-{reference.replace(' ', '-')}.dcz")
    if reference == "jax mesh":
        jcfg = datacomp_tpu.config.load_config(
            compression={"chunk_size_mb": 1, "subblock_symbols": S, **comp})
        jax_compress_multihost(str(job / "mixed.bin"), ref, jcfg, backend="tpu",
                               mesh=jax_parallel.make_mesh(8))
    else:
        with GpuCompressionService(_port_cfg(int(reference[-1]), **comp), device="cpu") as svc:
            svc.compress(str(job / "mixed.bin"), ref)
    assert (job / "dev2.dcz").read_bytes() == open(ref, "rb").read()


@pytest.mark.parametrize("name", ["fast2", "v1", "v1-host"])
def test_two_rank_host_codebook_file_equals_host_codec(job, name):
    ref = str(job / f"ref-{name}.dcz")
    with CpuCompressionService(_port_cfg(**FILES[name][0])) as svc:
        svc.compress(str(job / "mixed.bin"), ref)
    assert (job / f"{name}.dcz").read_bytes() == open(ref, "rb").read()


@pytest.mark.parametrize("name,source", [("deep", "deep.bin"), ("dev2", "mixed.bin")])
def test_two_rank_decompress_restores(job, name, source):
    """The restored file equals the input, and each chunk deeper than 16 bits
    took the counted host route on the rank that owns it."""
    assert (job / f"{name}.out").read_bytes() == (job / source).read_bytes()
    header, _ = read_container(str(job / f"{name}.dcz"))
    deep = sum(1 for c in header.chunks if max_code_len(c.code_lengths) > TABLE_BITS)
    routes = sum(json.loads((job / f"rank{r}.json").read_text())["routes"][name] for r in (0, 1))
    assert routes == deep and (deep > 0 or name == "dev2")


def test_two_rank_sharded_step_equals_jax(job):
    """Each rank's eight outputs are the JAX step's rows of that rank; the
    offsets are global (the gloo all-gather of the sizes)."""
    batch, valid = _step_input()
    want = [np.asarray(w) for w in jax_parallel.sharded_compress_arrays(
        jax_parallel.make_mesh(8), batch, valid, subblock=STEP_SUB)]
    ranks = [np.load(job / f"step{r}.npz") for r in (0, 1)]
    for k, w in enumerate(want):
        got = np.concatenate([r[f"arr_{k}"] for r in ranks])
        assert got.shape == w.shape and np.array_equal(got.astype(np.int64), w.astype(np.int64)), k


def test_failed_rank_leaves_no_spill(tmp_path):
    """Rank 1's encode raises: it exits with its error, rank 0's all-gather
    fails with it, and neither leaves its spill file behind."""
    (tmp_path / "mixed.bin").write_bytes(_mixed())
    (rc0, err0), (rc1, err1) = _run_job(tmp_path, "fail")
    assert rc1 != 0 and "injected encode failure" in err1
    assert rc0 != 0
    assert not list(tmp_path.glob("*.spill*"))


def test_torchrun_cli_sharded_two_ranks(tmp_path, capsys, monkeypatch):
    """``torchrun --nproc_per_node 2`` of the CLI's ``--sharded`` verbs on
    the plain versions: the ``.dcz`` equals the unsharded CLI's, and the
    restored file the input."""
    src = tmp_path / "in.bin"
    src.write_bytes(_mixed())
    args = ["1", "--format", "2", "--codebook-mode", "device", "--no-verify"]
    monkeypatch.setenv("DATACOMP_DEVICE_PLATFORM", "cpu")
    assert cli.main(["compress", str(src), str(tmp_path / "one.dcz"), *args]) == 0
    env = dict(os.environ, PYTHONPATH=REPO, DATACOMP_DEVICE_PLATFORM="cpu")
    for verb, paths, extra in (("compress", ("in.bin", "two.dcz"), args),
                               ("decompress", ("two.dcz", "two.out"), ["1", "--stages"])):
        res = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             "2", "-m", "datacomp_tpu_torch.cli", verb, *(str(tmp_path / p) for p in paths),
             "--sharded", *extra], env=env, capture_output=True, text=True, timeout=TIMEOUT)
        assert res.returncode == 0, res.stderr[-3000:]
    assert (tmp_path / "two.dcz").read_bytes() == (tmp_path / "one.dcz").read_bytes()
    assert (tmp_path / "two.out").read_bytes() == src.read_bytes()
    # rank 0 prints both ranks' stages and their counts, summed
    assert "rank 1 of 2:" in res.stdout
    counts = json.loads(res.stdout.split("counts: ")[1].splitlines()[0])
    depths = [max_code_len(c.code_lengths)
              for c in read_container(str(tmp_path / "two.dcz"))[0].chunks]
    assert counts["plain"]["decode_batch"] == sum(1 for dep in depths if 0 < dep <= TABLE_BITS)
    assert counts["host_decode_routes"] == sum(1 for dep in depths if dep > TABLE_BITS)


def test_sharded_step_tool_two_ranks():
    """``tools.sharded_step`` under ``torchrun`` at 2 ranks on the plain
    versions: every rank's outputs equal the batched plain versions on its
    rows, and its offsets the cumsum of every rank's sizes."""
    env = dict(os.environ, PYTHONPATH=REPO, DATACOMP_DEVICE_PLATFORM="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "datacomp_tpu_torch.tools.sharded_step", "3", "1"],
        env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["ranks"] == 2 and [r["rank"] for r in out["records"]] == [0, 1]
