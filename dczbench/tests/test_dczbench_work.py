"""Every seed does the same work, and a run refuses to write past its cap."""

import numpy as np
import pytest

from dczbench import corpus, run
from dczbench.reference import expected_file

from .helpers import cpu_run, small_cell


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


def test_run_fingerprint_is_equal_for_two_seeds(tmp_tmpdir):
    works = [cpu_run("fast-v2.silesia", seed=seed)["work"] for seed in (5, 2**31 + 9)]
    assert works[0] == works[1]
    assert works[0]["launches_and_plain_calls"]["encode_batch"][1] > 0  # the batch path ran


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


def test_reckoned_sizes_are_the_files_written(tmp_tmpdir, tmp_path):
    from datacomp_tpu_torch.config import load_config
    from datacomp_tpu_torch.services import CpuCompressionService

    _, _, config_doc, traffic = small_cell("fast-v2.silesia", files=2, scale=20)
    data = corpus.make_corpus(traffic, 4, 1 << 20, 4032)[1]
    src, dcz = str(tmp_path / "nci"), str(tmp_path / "nci.dcz")
    with open(src, "wb") as f:
        f.write(data.tobytes())
    CpuCompressionService(load_config(compression=dict(config_doc["compression"],
                                                       chunk_size_mb=1))).compress(src, dcz)
    import os

    assert run.container_sizes(data, "nci", 1 << 20, 4032, config_doc["codebook_rule"])[0] \
        == os.path.getsize(dcz)


def test_small_traffic_has_every_file_due_once():
    _, _, _, traffic = small_cell("fast-v2.silesia")
    assert run.schedule(traffic) == [0, 1, 2]
