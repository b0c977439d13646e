"""The port's spans on the CPU: ``GpuCompressionService(device="cpu")``, 1 MB
chunks, a file of three chunks, under ``torch.profiler`` (CPU activity) and
without it.  Each request, pipeline job and stage is a span with the ids,
thread and clock that the benchmark's readers need; with no profiler
recording, nothing is kept and no ``record_function`` is entered."""

import json
import threading

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from datacomp_tpu_torch.config import load_config  # noqa: E402
from datacomp_tpu_torch.models import Stage, StageMetrics, stage_metrics  # noqa: E402
from datacomp_tpu_torch.services import GpuCompressionService, gpu_service  # noqa: E402
from datacomp_tpu_torch.utils.testdata import generate_bytes  # noqa: E402

REQUESTS = ("compress", "decompress")
#: (batch_chunks, codebook_mode): per-chunk and batched paths, host and
#: device codebooks
PATHS = [(1, "fast"), (4, "fast"), (4, "device")]


def _service(batch: int, mode: str) -> GpuCompressionService:
    cfg = load_config(compression={"chunk_size_mb": 1, "format_version": 2,
                                   "codebook_mode": mode},
                      device={"batch_chunks": batch})
    return GpuCompressionService(cfg, device="cpu")


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    path = tmp_path_factory.mktemp("spans") / "in.bin"
    path.write_bytes(generate_bytes("text", (2 << 20) + 300_000))
    return str(path)


@pytest.fixture(scope="module", params=PATHS, ids=lambda p: f"batch{p[0]}-{p[1]}")
def traced(request, src, tmp_path_factory):
    """One compress and one decompress under the profiler, after a warm-up
    that starts the pipeline's pool before the profiler does."""
    svc = _service(*request.param)
    d = tmp_path_factory.mktemp("traced")
    dcz, back = str(d / "o.dcz"), str(d / "back.bin")
    svc.compress(src, dcz)
    svc.decompress(dcz, back)
    stage_metrics.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        svc.compress(src, dcz)
        sums = {"compress": svc.get_last_stage_metrics().as_dict()}
        svc.decompress(dcz, back)
        sums["decompress"] = svc.get_last_stage_metrics().as_dict()
    spans = stage_metrics.spans()
    stage_metrics.clear_spans()
    trace_path = str(d / "trace.json")
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        chrome = json.load(f)
    svc.close()
    with open(back, "rb") as a, open(src, "rb") as b:
        assert a.read() == b.read()
    return {"spans": spans, "sums": sums, "chrome": chrome}


def _requests(spans):
    return {s.name: s for s in spans if s.name in REQUESTS}


def test_one_request_span_each(traced):
    names = [s.name for s in traced["spans"] if s.name in REQUESTS]
    assert sorted(names) == sorted(REQUESTS)
    reqs = _requests(traced["spans"])
    assert reqs["compress"].request != reqs["decompress"].request
    assert all(r.parent is None and r.request is not None for r in reqs.values())
    assert reqs["compress"].nbytes == (2 << 20) + 300_000


def test_jobs_carry_their_request(traced):
    reqs = _requests(traced["spans"])
    by_id = {s.span_id: s for s in traced["spans"]}
    jobs = [s for s in traced["spans"] if s.name == "job"]
    assert jobs and all(j.job is not None for j in jobs)
    for j in jobs:
        parent = by_id[j.parent]
        assert parent.name in REQUESTS and j.request == parent.request
        assert j.request in {r.request for r in reqs.values()}
    # every chunk of each request in exactly one job
    for r in reqs.values():
        chunks = sorted(c for j in jobs if j.request == r.request for c in j.chunks)
        assert chunks == [0, 1, 2]


def test_stage_spans_nest_in_their_request(traced):
    by_id = {s.span_id: s for s in traced["spans"]}
    staged = [s for s in traced["spans"] if s.stage is not None]
    assert {s.stage for s in staged} >= {"FILE_IO", "CHECKSUM_COMPUTE", "ENCODING",
                                         "DECODING", "CHECKSUM_VERIFY", "HEADER_WRITE"}
    for s in staged:
        up, seen = s, set()
        while up.parent is not None and up.span_id not in seen:
            seen.add(up.span_id)
            up = by_id[up.parent]
            assert up.request == s.request
        assert up.name in REQUESTS


def test_children_lie_in_their_parents(traced):
    by_id = {s.span_id: s for s in traced["spans"]}
    children = [s for s in traced["spans"] if s.parent is not None]
    assert children
    for s in children:
        p = by_id[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)


def test_stage_sums_are_their_spans(traced):
    for req, sums in traced["sums"].items():
        rid = _requests(traced["spans"])[req].request
        for stage in Stage:
            mine = [s for s in traced["spans"] if s.request == rid and s.stage == stage.name]
            got = sum(s.end_ns - s.start_ns for s in mine)
            if stage.name not in sums:
                assert not mine
                continue
            assert round(sums[stage.name]["ms"] * 1e6) == got, (req, stage)
            assert sums[stage.name]["count"] == len(mine)


def _compress_spans(traced):
    rid = _requests(traced["spans"])["compress"].request
    return [s for s in traced["spans"] if s.request == rid]


def test_helper_hashes_carry_their_job(traced):
    """A chunk of ``INLINE_HASH_BYTES`` or more (each chunk here, the
    300,000-byte tail too) is hashed on the codec's helper thread, in a
    ``sha256`` span whose parent is its job, with the job's request and job
    ids; a smaller one on its job's thread.  CHECKSUM_COMPUTE sums what its
    spans do, over both threads."""
    mine = _compress_spans(traced)
    by_id = {s.span_id: s for s in mine}
    hashes = [s for s in mine if s.name == "sha256"]
    assert sorted(s.nbytes for s in hashes) == [300_000, 1 << 20, 1 << 20]
    for s in hashes:
        job = by_id[s.parent]
        assert job.name == "job" and (s.request, s.job) == (job.request, job.job)
        assert (s.thread != job.thread) == (s.nbytes >= gpu_service.INLINE_HASH_BYTES)
    assert (round(traced["sums"]["compress"]["CHECKSUM_COMPUTE"]["ms"] * 1e6)
            == sum(s.end_ns - s.start_ns for s in hashes))


def test_hash_joins_wait_under_their_job(traced):
    """Each job that handed a hash over joins it in one ``wait`` span on its
    own thread, whose parent is the job."""
    mine = _compress_spans(traced)
    by_id = {s.span_id: s for s in mine}
    handed = {s.parent for s in mine if s.name == "sha256" and s.thread != by_id[s.parent].thread}
    joins = [s for s in mine if s.name == "wait" and by_id[s.parent].name == "job"]
    assert handed and sorted(w.parent for w in joins) == sorted(handed)
    assert all(w.thread == by_id[w.parent].thread for w in joins)


def test_chrome_events_match_the_spans(traced):
    base_us = traced["chrome"]["baseTimeNanoseconds"] / 1e3
    events = [e for e in traced["chrome"]["traceEvents"]
              if e.get("ph") == "X" and str(e.get("name", "")).startswith("dcz.")]
    names = {e["name"] for e in events}
    assert {"dcz.compress", "dcz.decompress", "dcz.wait", "dcz.open"} <= names
    # a span reads the clock before its record_function enters and after it
    # exits (each can wait for the interpreter lock), so its event lies
    # inside it, on the same clock within 1 ms
    for e in events:
        start_us = e["ts"] + base_us
        near = [s for s in traced["spans"] if "dcz." + s.name == e["name"]
                and s.start_ns / 1e3 - 1000.0 <= start_us
                and start_us + e["dur"] <= s.end_ns / 1e3 + 1000.0]
        assert near, e


def test_pool_threads_record_without_the_profiler_there(traced):
    main = threading.get_native_id()
    pool = [s for s in traced["spans"] if s.thread != main]
    assert {"job", "read", "sha256", "encode", "pread", "verify"} <= {s.name for s in pool}
    assert all(s.name != "job" or s.thread != main for s in traced["spans"])


def test_spans_off_cost_nothing(src, tmp_path, monkeypatch):
    def boom(*_a, **_k):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    svc = _service(4, "fast")
    stage_metrics.clear_spans()
    try:
        svc.compress(src, str(tmp_path / "o.dcz"))
        svc.decompress(str(tmp_path / "o.dcz"), str(tmp_path / "back.bin"))
        assert stage_metrics.spans() == []
        assert stage_metrics.current_span() is None
        assert svc.get_last_stage_metrics().as_dict()["DECODING"]["count"] == 1
    finally:
        svc.close()


def test_span_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(stage_metrics, "MAX_SPANS", 3)
    stage_metrics.clear_spans()
    metrics = StageMetrics()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with metrics.timed(Stage.ENCODING, 10, span="encode"):
                pass
    assert len(stage_metrics.spans()) == 3 and stage_metrics.dropped_spans() == 2
    assert metrics.as_dict()["ENCODING"]["count"] == 5
    stage_metrics.clear_spans()
    assert stage_metrics.spans() == [] and stage_metrics.dropped_spans() == 0


def test_span_nesting_and_explicit_parent():
    stage_metrics.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with stage_metrics.span("compress", request=True) as req:
            with stage_metrics.span("open"):
                pass
            handed = stage_metrics.current_span()
            assert handed is req
            box = []

            def worker():
                with stage_metrics.span("job", parent=handed, job=True, chunks=[3]):
                    with stage_metrics.span("read"):
                        box.append(stage_metrics.current_span().name)

            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive() and box == ["read"]
    got = {s.name: s for s in stage_metrics.spans()}
    stage_metrics.clear_spans()
    assert got["open"].parent == got["compress"].span_id
    assert got["job"].parent == got["compress"].span_id and got["job"].chunks == (3,)
    assert got["read"].parent == got["job"].span_id
    assert got["read"].job == got["job"].job is not None
    assert {s.request for s in got.values()} == {got["compress"].request}


def test_resume_is_one_request(src, tmp_path):
    """A resume is a request span of its own, whose job covers the chunks
    past the sidecar's and whose `open` truncates the output."""
    from datacomp_tpu_torch.core.container import read_container
    from datacomp_tpu_torch.services import pipeline

    svc = _service(4, "fast")
    try:
        one_shot = str(tmp_path / "one.dcz")
        svc.compress(src, one_shot)
        h, _ = read_container(one_shot)
        with open(one_shot, "rb") as f:
            full = f.read()
        dcz = str(tmp_path / "resumed.dcz")
        with open(dcz + pipeline.PARTIAL_SUFFIX, "wb") as f:
            pipeline._write_partial_header(f, h)
            pipeline._append_partial_chunk(f, h.chunks[0])
        with open(dcz, "wb") as f:
            f.write(full)  # longer than the one chunk kept: resume truncates it
        stage_metrics.clear_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            svc.resume_compression(src, dcz, last_completed_chunk=0)
        got = stage_metrics.spans()
        stage_metrics.clear_spans()
    finally:
        svc.close()
    with open(dcz, "rb") as f:
        assert f.read() == full
    (resume,) = [s for s in got if s.name == "resume"]
    assert resume.request is not None and resume.nbytes == (2 << 20) + 300_000
    assert {s.request for s in got} == {resume.request}
    assert sorted(c for s in got if s.name == "job" for c in s.chunks) == [1, 2]
    assert len([s for s in got if s.name == "open"]) == 3  # input, output, the truncate
