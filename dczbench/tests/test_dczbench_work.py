"""Every seed does the same work, and a run refuses to write past its cap."""

import os

import numpy as np
import pytest

from dczbench import corpus, judge, run
from dczbench.reference import expected_file

from .helpers import FORMAT1, cpu_run, small_cell


def _shape(expected: list) -> list:
    """What a seed may not change: per chunk its size, coded size, raw-store
    decision, depth, multiset of code lengths and gap-array size."""
    return [[(c["n"], c["size"], c["raw"], c["depth"], sorted(c["lengths"].tolist()),
              c["gaps"].size) for c in e["chunks"]] for e in expected]


@pytest.mark.parametrize("workload", ["fast-v2.silesia", "device-v2.silesia"])
def test_reference_work_is_equal_for_two_seeds(workload):
    _, _, config_doc, traffic = small_cell(workload, files=12, scale=20)
    chunk, sub = 1 << 20, 4032
    shapes, contents = [], []
    for seed in (3, 2**31 + 5):
        datas = corpus.make_corpus(traffic, seed, chunk, sub)
        contents.append(datas[0][:4096].tobytes())
        shapes.append(_shape([expected_file(d, chunk, config_doc["codebook_rule"], sub)
                              for d in datas]))
    assert shapes[0] == shapes[1]
    assert contents[0] != contents[1]  # the seed does change the bytes


def test_seed_keeps_every_chunk_histogram_up_to_relabelling():
    _, _, _, traffic = small_cell("fast-v2.silesia", files=4, scale=10)
    a = corpus.make_corpus(traffic, 11, 1 << 20, 4032)
    b = corpus.make_corpus(traffic, 12, 1 << 20, 4032)
    for x, y in zip(a, b):
        assert x.size == y.size
        for off in range(0, x.size, 1 << 20):
            hx = np.sort(np.bincount(x[off:off + (1 << 20)], minlength=256))
            hy = np.sort(np.bincount(y[off:off + (1 << 20)], minlength=256))
            assert np.array_equal(hx, hy)


@pytest.mark.parametrize("workload", ["fast-v2.silesia", FORMAT1])
def test_run_fingerprint_is_equal_for_two_seeds(tmp_tmpdir, workload):
    works = [cpu_run(workload, seed=seed)["work"] for seed in (5, 2**31 + 9)]
    assert works[0] == works[1]
    assert works[0]["launches_and_plain_calls"]["encode_batch"][1] > 0  # the batch path ran


def test_seed_only_relabels_bytes():
    """Two seeds give every byte of a file one relabelling, so each code
    length falls where it fell: the device's work does not move."""
    _, _, _, traffic = small_cell("fast-v2.silesia", files=4, scale=10)
    a = corpus.make_corpus(traffic, 11, 1 << 20, 4032)
    b = corpus.make_corpus(traffic, 2**31 + 12, 1 << 20, 4032)
    for x, y in zip(a, b):
        label = np.zeros(256, np.uint8)
        label[x] = y
        assert np.array_equal(label[x], y)
        assert not np.array_equal(x, y)


def test_schedule_is_fixed_by_the_traffic():
    _, _, _, traffic = run.load_cell("fast-v2.silesia")
    requests = run.schedule(traffic)
    assert requests == list(range(12)) * traffic["rounds"]


def test_writes_are_reckoned_and_capped(tmp_tmpdir):
    bench, cell, config_doc, traffic = run.load_cell("fast-v2.silesia")
    datas = corpus.make_corpus(traffic, 1, 16 << 20, 4032)
    sizes = [run.container_sizes(d, f["name"], 16 << 20, 4032, config_doc["codebook_rule"])
             for d, f in zip(datas, traffic["files"])]
    w = run.reckon_writes(traffic, run.schedule(traffic), sizes)
    assert w["total"] <= w["cap"] == 2 << 30
    # a request list long enough to pass the cap is refused before anything is written
    traffic = dict(traffic, rounds=traffic["rounds"] + 1)
    with pytest.raises(SystemExit, match="over its cap"):
        run.run_cell(cell["name"], bench, config_doc, traffic, 1, 60.0, trace=False, device="cpu")
    assert list(tmp_tmpdir.iterdir()) == []


@pytest.mark.parametrize("workload", ["fast-v2.silesia", FORMAT1])
def test_reckoned_sizes_are_the_files_written(tmp_tmpdir, tmp_path, workload):
    from datacomp_tpu_torch.config import load_config
    from datacomp_tpu_torch.services import CpuCompressionService

    _, _, config_doc, traffic = small_cell(workload, files=2, scale=20)
    data = corpus.make_corpus(traffic, 4, 1 << 20, 4032)[1]
    src, dcz = str(tmp_path / "nci"), str(tmp_path / "nci.dcz")
    with open(src, "wb") as f:
        f.write(data.tobytes())
    cfg = load_config(compression=dict(config_doc["compression"], chunk_size_mb=1))
    CpuCompressionService(cfg).compress(src, dcz)
    assert run.container_sizes(data, "nci", 1 << 20, run.container_subblock(cfg.compression),
                               config_doc["codebook_rule"], cfg.compression.format_version)[0] \
        == os.path.getsize(dcz)


def _served(tmp_path, workload: str, data: np.ndarray) -> tuple:
    """``data`` compressed by the program's host codec in the configuration
    of ``workload`` at 1 MiB chunks and restored: (config, codebook rule,
    `.dcz` path, restored path, source mtime ms)."""
    from datacomp_tpu_torch.config import load_config
    from datacomp_tpu_torch.services import CpuCompressionService

    _, _, config_doc, _ = small_cell(workload)
    src, dcz, back = (str(tmp_path / n) for n in ("in", "in.dcz", "in.out"))
    with open(src, "wb") as f:
        f.write(data.tobytes())
    cfg = load_config(compression=dict(config_doc["compression"], chunk_size_mb=1))
    svc = CpuCompressionService(cfg)
    svc.compress(src, dcz)
    svc.decompress(dcz, back)
    return cfg, config_doc["codebook_rule"], dcz, back, int(os.path.getmtime(src) * 1000)


@pytest.mark.parametrize("workload", ["fast-v2.silesia", FORMAT1])
def test_reckoned_sidecar_is_the_one_the_program_writes(tmp_path, workload):
    """The progress sidecar of a container, written by the program's own
    sidecar writer from the container's footer, is the size reckoned."""
    import io

    from datacomp_tpu_torch.core import container as ct
    from datacomp_tpu_torch.services import pipeline

    _, _, _, traffic = small_cell(workload, files=2, scale=20)
    data = corpus.make_corpus(traffic, 4, 1 << 20, 4032)[1]
    cfg, rule, dcz, _, _ = _served(tmp_path, workload, data)
    buf = open(dcz, "rb").read()
    header = ct.parse_footer(buf, int.from_bytes(buf[-8:], "big"))
    sidecar = io.BytesIO()
    pipeline._write_partial_header(sidecar, header)
    for c in header.chunks:
        pipeline._append_partial_chunk(sidecar, c)
    assert run.container_sizes(data, "in", 1 << 20, run.container_subblock(cfg.compression),
                               rule, cfg.compression.format_version) \
        == (len(buf), len(sidecar.getvalue()))


@pytest.mark.parametrize("workload", ["fast-v2.silesia", FORMAT1])
def test_incompressible_chunk_is_raw_in_format_2_only(tmp_path, workload):
    """Format 2 stores a chunk that coding would not shrink raw; format 1 has
    no raw store and codes it: the reckoning and the judge follow the
    format."""
    data = np.random.default_rng(8).integers(0, 256, (1 << 20) + 5000, np.uint8)
    cfg, rule, dcz, back, mtime = _served(tmp_path, workload, data)
    version = cfg.compression.format_version
    subblock = run.container_subblock(cfg.compression)
    want = expected_file(data, 1 << 20, rule, subblock, version=version)
    assert [c["raw"] for c in want["chunks"]] == [version >= 2] * 2
    assert run.container_sizes(data, "in", 1 << 20, subblock, rule, version)[0] \
        == os.path.getsize(dcz)
    faults = judge.judge_request(judge.capture(dcz, back), want, "in", mtime, version)
    assert not any(faults.values()), faults


def test_small_traffic_has_every_file_due_once():
    _, _, _, traffic = small_cell("fast-v2.silesia")
    assert run.schedule(traffic) == [0, 1, 2]
