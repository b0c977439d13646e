"""The port's defaults, format 1 with the ``java`` codebook, through
``GpuCompressionService(device="cpu")`` (the kernels' plain versions) with
the compression block of ``dczbench/configs/java-v1.json``, cut to 1 MiB
chunks, at ``batch_chunks`` 4.  Each ``.dcz`` is held to the benchmark's
plain reference as its judge holds it, the restore to the input, every
coded chunk deeper than 16 bits to the counted host decode route and its one
``host_decode`` span, and every other coded chunk to the gap finder and K3
under a ``decode`` span; format 2 with the ``fast`` codebook opens no
``host_decode`` span."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from datacomp_tpu_torch import ops  # noqa: E402
from datacomp_tpu_torch.config import load_config  # noqa: E402
from datacomp_tpu_torch.models import stage_metrics  # noqa: E402
from datacomp_tpu_torch.services import GpuCompressionService, gpu_service  # noqa: E402
from dczbench import judge  # noqa: E402
from dczbench.reference import expected_file  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK_MB = 1
CHUNK_BYTES = CHUNK_MB << 20


def _java_v1_block() -> dict:
    with open(os.path.join(ROOT, "dczbench", "configs", "java-v1.json")) as f:
        block = json.load(f)["compression"]
    return dict(block, chunk_size_mb=CHUNK_MB)


def _multi_chunk(rng) -> np.ndarray:
    """Four chunks, the last short: one group of four host-routed members."""
    return (rng.geometric(0.04, (3 << 20) + 77_777) % 256).astype(np.uint8)


def _tied(rng) -> np.ndarray:
    """48 symbols whose counts take three values: the heap's ties decide."""
    syms = rng.choice(256, 48, replace=False)
    counts = rng.choice([1000, 2000, 3000], 48)
    return rng.permutation(np.repeat(syms, counts)).astype(np.uint8)


def _one_symbol(rng) -> np.ndarray:
    return np.full(200_003, rng.integers(256), np.uint8)


INPUTS = {"multi_chunk": (_multi_chunk, 2**31 + 11), "tied": (_tied, 2**31 + 12),
          "one_symbol": (_one_symbol, 2**31 + 13)}

#: the span names of a fast-v2 (format 2, ``fast``) compress and restore of
#: each input at batch 4, as the program recorded them before the host route
#: had a span of its own
FAST_V2_NAMES = {"compress", "decompress", "job", "wait", "open", "read", "write", "sidecar",
                 "footer", "sha256", "histogram", "codebook", "encode", "upload", "launch",
                 "fetch", "unpack", "pread", "pwrite", "decode", "decode_tables", "verify"}


def _served(path, dcz, back, compression):
    """Compress and restore ``path`` under the profiler: the spans recorded
    and the host decode routes the restore took, then its calls of the gap
    finder's plain version."""
    cfg = load_config(compression=compression, device={"batch_chunks": 4})
    svc = GpuCompressionService(cfg, device="cpu")
    stage_metrics.clear_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            svc.compress(path, dcz)
            gpu_service.host_decode_routes.reset()
            finder = ops.COUNTERS["find_gaps"][1].value
            svc.decompress(dcz, back)
            routes = (gpu_service.host_decode_routes.value,
                      ops.COUNTERS["find_gaps"][1].value - finder)
        spans = stage_metrics.spans()
    finally:
        stage_metrics.clear_spans()
        svc.close()
    return spans, routes


@pytest.fixture(scope="module", params=sorted(INPUTS))
def case(request, tmp_path_factory):
    make, seed = INPUTS[request.param]
    data = make(np.random.default_rng(seed))
    d = tmp_path_factory.mktemp(request.param)
    path = str(d / request.param)
    with open(path, "wb") as f:
        f.write(data.tobytes())
    dcz, back = str(d / "out.dcz"), str(d / "back.bin")
    spans, routes = _served(path, dcz, back, _java_v1_block())
    got = judge.capture(dcz, back)
    with open(back, "rb") as f:
        restored = f.read()
    fast_spans, _ = _served(path, str(d / "fast.dcz"), str(d / "fast.bin"),
                            {"chunk_size_mb": CHUNK_MB, "format_version": 2,
                             "codebook_mode": "fast"})
    return {"name": request.param, "data": data, "path": path, "got": got,
            "restored": restored, "spans": spans, "routes": routes,
            "fast_spans": fast_spans,
            "want": expected_file(data, CHUNK_BYTES, "java", 0, version=1)}


def _coded(case) -> list:
    return [c for c in case["want"]["chunks"] if not c["raw"]]


def _deep(case) -> list:
    """The coded chunks whose codes are deeper than the device decoder's."""
    return [c for c in _coded(case) if c["depth"] > ops.TABLE_BITS]


def test_container_is_the_references(case):
    mtime_ms = int(os.path.getmtime(case["path"]) * 1000)
    faults = judge.judge_request(case["got"], case["want"], case["name"], mtime_ms, 1)
    assert not any(faults.values()), faults
    assert len(case["want"]["chunks"]) == (4 if case["name"] == "multi_chunk" else 1)


def test_restore_is_the_input(case):
    assert case["restored"] == case["data"].tobytes()


def test_every_coded_chunk_takes_the_host_route(case):
    """Every chunk is coded; those deeper than 16 bits take the host route,
    and the others, in the job's one group, the gap finder."""
    assert _coded(case) and len(_coded(case)) == len(case["want"]["chunks"])
    routes, finder = case["routes"]
    assert routes == len(_deep(case))
    assert finder == (1 if len(_deep(case)) < len(_coded(case)) else 0)


def test_one_host_decode_leaf_a_coded_chunk(case):
    spans = case["spans"]
    by_id = {s.span_id: s for s in spans}
    (req,) = [s for s in spans if s.name == "decompress"]
    routed = [s for s in spans if s.name == "host_decode"]
    assert sorted(s.nbytes for s in routed) == sorted(c["n"] for c in _deep(case))
    parents = {s.parent for s in spans}
    for s in routed:
        assert s.stage == "DECODING" and s.span_id not in parents  # a leaf
        assert s.request == req.request
        assert req.start_ns <= s.start_ns <= s.end_ns <= req.end_ns
        up = s
        while up.parent is not None:
            up = by_id[up.parent]
        assert up is req
    # each DECODING span is a host_decode, but the one `decode` of the group
    # the gap finder took
    decoding = [s for s in spans if s.request == req.request and s.stage == "DECODING"]
    on_device = [s for s in decoding if s.name == "decode"]
    assert [s for s in decoding if s.name != "decode"] == routed
    assert [s.nbytes for s in on_device] == (
        [sum(c["n"] for c in _coded(case) if c not in _deep(case))]
        if len(_deep(case)) < len(_coded(case)) else [])


def test_fast_v2_opens_no_host_decode_span(case):
    names = {s.name for s in case["fast_spans"]}
    assert "host_decode" not in names
    assert names == FAST_V2_NAMES
