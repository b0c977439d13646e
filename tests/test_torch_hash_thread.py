"""Each chunk's SHA-256 on the codec's helper threads: ``GpuChunkCodec`` and
``GpuCompressionService`` with ``device="cpu"`` (the kernels' plain
versions), 1 MiB chunks.  The chunks and ``.dcz`` files are those of the
inline hash (every chunk under ``INLINE_HASH_BYTES``) and, with a host
codebook, of the host codec; an encode that raises leaves no hash running
and the service serving; ``close()`` shuts the hash pool down, and so do
``compress_multihost`` and ``decompress_multihost``."""

import hashlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from datacomp_tpu_torch.config import load_config  # noqa: E402
from datacomp_tpu_torch.services import CpuCompressionService, GpuCompressionService  # noqa: E402
from datacomp_tpu_torch.services import gpu_service  # noqa: E402
from datacomp_tpu_torch.services.cpu_service import CpuChunkCodec  # noqa: E402
from datacomp_tpu_torch.utils.testdata import generate_bytes  # noqa: E402

MiB = 1 << 20
#: (format_version, codebook_mode)
MODES = [(1, "fast"), (2, "fast"), (1, "device"), (2, "device")]


def cfg(version, mode, batch):
    return load_config(compression={"chunk_size_mb": 1, "format_version": version,
                                    "codebook_mode": mode},
                       device={"batch_chunks": batch})


def chunks():
    """Two coded 1 MiB chunks (text, skewed), a random one (raw-stored in
    format 2) and a tail of half the inline size."""
    return [np.frombuffer(generate_bytes(kind, n), np.uint8)
            for kind, n in (("text", MiB), ("skewed", MiB), ("random", MiB),
                            ("text", gpu_service.INLINE_HASH_BYTES // 2))]


def same(a, b):
    assert bytes(a.payload) == bytes(b.payload)
    assert a.sha256 == b.sha256
    assert np.array_equal(a.code_lengths, b.code_lengths)
    assert (a.gap_bits is None) == (b.gap_bits is None)
    if a.gap_bits is not None:
        assert np.array_equal(a.gap_bits, b.gap_bits)


@pytest.fixture
def inline(monkeypatch):
    """Every chunk hashed on its worker."""
    def on():
        monkeypatch.setattr(gpu_service, "INLINE_HASH_BYTES", 1 << 62)
    return on


def encode(version, mode, batch, datas):
    codec = gpu_service.GpuChunkCodec(cfg(version, mode, batch), torch.device("cpu"))
    try:
        m = gpu_service.StageMetrics()
        encs = codec.encode_chunk_batch(datas, m)
        return encs, m.as_dict()["CHECKSUM_COMPUTE"]
    finally:
        codec.close()


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("version,mode", MODES)
def test_chunks_equal_the_inline_hash_and_the_host_codec(version, mode, batch, inline):
    datas = chunks()
    if batch == 1:  # one chunk a call, as the pipeline hands them at batch 1
        helper = [e for d in datas for e in encode(version, mode, 1, [d])[0]]
    else:
        helper, stage = encode(version, mode, 4, datas)
        assert stage["count"] == 4 and stage["bytes"] == sum(d.size for d in datas)
    for enc, d in zip(helper, datas):
        assert enc.sha256 == hashlib.sha256(d.tobytes()).digest()
    assert (not helper[2].code_lengths.any()) == (version == 2)  # raw-stored in format 2
    inline()
    for a, b in zip(helper, encode(version, mode, batch, datas)[0]):
        same(a, b)
    if mode != "device":  # device codes are uncapped, the host codec's capped
        host = CpuChunkCodec(cfg(version, mode, batch))
        for a, d in zip(helper, datas):
            same(a, host.encode_chunk(d, gpu_service.StageMetrics()))


def test_only_chunks_under_the_inline_size_hash_on_their_worker():
    codec = gpu_service.GpuChunkCodec(cfg(2, "fast", 4), torch.device("cpu"))
    try:
        datas = chunks()
        got = [codec._start_hash(d, gpu_service.StageMetrics()) for d in datas]
        assert [type(g) for g in got] == [gpu_service.Future] * 3 + [bytes]
        assert [g if isinstance(g, bytes) else g.result() for g in got] == [
            hashlib.sha256(d.tobytes()).digest() for d in datas]
    finally:
        codec.close()


def test_empty_chunk():
    enc = encode(2, "fast", 1, [np.zeros(0, np.uint8)])[0][0]
    assert enc.payload == b"" and enc.sha256 == hashlib.sha256(b"").digest()


def _compress(svc, src, out):
    svc.compress(str(src), str(out))
    return out.read_bytes()


@pytest.mark.parametrize("version,mode", MODES)
def test_dcz_equal_the_inline_hash_and_the_host_codec(tmp_path, version, mode, inline):
    src = tmp_path / "in.bin"
    src.write_bytes(b"".join(d.tobytes() for d in chunks()))
    empty = tmp_path / "empty.bin"
    empty.write_bytes(b"")
    got = {}
    with GpuCompressionService(cfg(version, mode, 4), device="cpu") as svc:
        got["helper"] = [_compress(svc, f, tmp_path / f"h{i}.dcz")
                         for i, f in enumerate((src, empty))]
    inline()
    with GpuCompressionService(cfg(version, mode, 4), device="cpu") as svc:
        got["inline"] = [_compress(svc, f, tmp_path / f"i{i}.dcz")
                         for i, f in enumerate((src, empty))]
    assert got["helper"] == got["inline"]
    if mode != "device":
        with CpuCompressionService(cfg(version, mode, 4)) as svc:
            host = [_compress(svc, f, tmp_path / f"c{i}.dcz") for i, f in enumerate((src, empty))]
        assert got["helper"] == host


def _slow_sha256(data):
    time.sleep(0.2)
    return hashlib.sha256(data).digest()


#: (batch_chunks, chunks of the file, the member whose check raises): one job
#: in each case, so the compress raises when that job does
FAILURES = [(1, 1, 1), (4, 2, 2)]


@pytest.mark.parametrize("batch,n_chunks,failing", FAILURES)
def test_a_failed_encode_leaves_no_hash_running(tmp_path, monkeypatch, batch, n_chunks,
                                                failing):
    src = tmp_path / "in.bin"
    src.write_bytes(b"".join(d.tobytes() for d in chunks()[:n_chunks]))
    with GpuCompressionService(cfg(2, "fast", batch), device="cpu") as svc:
        good = _compress(svc, src, tmp_path / "good.dcz")
    svc = GpuCompressionService(cfg(2, "fast", batch), device="cpu")
    codec = svc._codec
    started = []
    start = codec._start_hash
    check = codec._check_total
    calls = []

    def record(data, metrics):
        started.append(start(data, metrics))
        return started[-1]

    def one_fails(tb, opt_bits):
        calls.append(tb)
        if len(calls) == failing:
            raise RuntimeError("the member's encode failed")
        check(tb, opt_bits)

    monkeypatch.setattr(gpu_service, "compute_sha256", _slow_sha256)
    monkeypatch.setattr(codec, "_start_hash", record)
    monkeypatch.setattr(codec, "_check_total", one_fails)
    try:
        with pytest.raises(RuntimeError, match="the member's encode failed"):
            svc.compress(str(src), str(tmp_path / "bad.dcz"))
        assert len(started) == n_chunks
        assert all(isinstance(f, gpu_service.Future) and f.done() for f in started)
        monkeypatch.setattr(codec, "_check_total", check)
        assert _compress(svc, src, tmp_path / "next.dcz") == good
    finally:
        svc.close()
    with pytest.raises(RuntimeError):
        codec._hashes.submit(hashlib.sha256)


def test_a_failed_hash_raises_at_the_join(tmp_path, monkeypatch):
    src = tmp_path / "in.bin"
    src.write_bytes(b"".join(d.tobytes() for d in chunks()))

    def failing(data):
        if threading.current_thread().name.startswith("dcz-sha256"):
            raise OSError("hash failed")
        return hashlib.sha256(data).digest()

    monkeypatch.setattr(gpu_service, "compute_sha256", failing)
    with GpuCompressionService(cfg(2, "fast", 4), device="cpu") as svc:
        with pytest.raises(OSError, match="hash failed"):
            svc.compress(str(src), str(tmp_path / "o.dcz"))


def test_close_shuts_the_hash_pool_down():
    svc = GpuCompressionService(cfg(2, "fast", 4), device="cpu")
    pool = svc._codec._hashes
    assert pool._max_workers == 1
    svc.close()
    with pytest.raises(RuntimeError):
        pool.submit(hashlib.sha256)


@pytest.mark.parametrize("mode", ["device", "fast"])
def test_multihost_on_one_device_hashes_on_the_pool_and_closes_it(tmp_path, monkeypatch, mode):
    """``compress_multihost`` on one local device encodes through the codec's
    groups, so its chunks are hashed on the pool; it writes the service's
    file, and it and ``decompress_multihost`` shut their codec's pool."""
    from datacomp_tpu_torch import parallel
    from datacomp_tpu_torch.parallel import multihost

    src = tmp_path / "in.bin"
    src.write_bytes(b"".join(d.tobytes() for d in chunks()))
    c = cfg(2, mode, 4)
    with GpuCompressionService(c, device="cpu") as svc:
        one = _compress(svc, src, tmp_path / "one.dcz")
    codecs, threads = [], []
    make = multihost._codec
    monkeypatch.setattr(multihost, "_codec", lambda *a: codecs.append(make(*a)) or codecs[-1])

    def sha(data):
        threads.append(threading.current_thread().name)
        return hashlib.sha256(data).digest()

    monkeypatch.setattr(gpu_service, "compute_sha256", sha)
    mesh = parallel.make_mesh(devices=("cpu",))
    parallel.compress_multihost(str(src), str(tmp_path / "two.dcz"), c, mesh=mesh)
    assert (tmp_path / "two.dcz").read_bytes() == one
    assert sum(t.startswith("dcz-sha256") for t in threads) == 3  # the tail on the worker
    parallel.decompress_multihost(str(tmp_path / "two.dcz"), str(tmp_path / "two.out"), c,
                                  mesh=mesh)
    assert (tmp_path / "two.out").read_bytes() == src.read_bytes()
    assert len(codecs) == 2
    for codec in codecs:
        with pytest.raises(RuntimeError):
            codec._hashes.submit(hashlib.sha256)
