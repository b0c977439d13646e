"""The plain reference's codebook rules and containers.

The ``java`` rule is held to the program's own tree build, on histograms
full of ties and on the traffic's chunks; format 2's containers are pinned
to what the reference worked out before it learned format 1."""

import hashlib

import numpy as np
import pytest

from dczbench import corpus, run
from dczbench.reference import code_lengths, expected_file
from datacomp_tpu_torch.core.huffman import build_code_lengths

from .helpers import small_cell


def _tied_histograms(top: int, count: int = 500) -> list:
    """``count`` seeded histograms over 0 to 256 present symbols whose
    counts are drawn from 1..``top``: the smaller ``top``, the more ties."""
    rng = np.random.default_rng(top)
    out = []
    for k in range(count):
        n = k if k < 3 else int(rng.integers(2, 257))  # none, one and two symbols too
        h = np.zeros(256, np.int64)
        h[rng.choice(256, n, replace=False)] = rng.integers(1, top + 1, n)
        out.append(h)
    return out


TOPS = (2, 5, 40, 1 << 20)


@pytest.mark.parametrize("top", TOPS)
def test_java_rule_is_the_programs_on_tied_histograms(top):
    for h in _tied_histograms(top):
        java = code_lengths(h, "java")
        assert np.array_equal(java, build_code_lengths(h, "java", 0)), h
        assert h @ java == h @ code_lengths(h, "optimal")  # equally optimal


def test_java_rule_is_not_the_optimal_rule():
    differ = sum(not np.array_equal(code_lengths(h, "java"), code_lengths(h, "optimal"))
                 for top in TOPS for h in _tied_histograms(top))
    assert differ > 0


def test_java_rule_gives_one_symbol_one_bit_and_none_nothing():
    h = np.zeros(256, np.int64)
    assert not code_lengths(h, "java").any()
    h[77] = 9
    assert code_lengths(h, "java").tolist() == [0] * 77 + [1] + [0] * 178


@pytest.mark.parametrize("chunk_mb, cut", [(1, {"files": 12, "scale": 20}), (16, None)])
def test_java_rule_is_the_programs_on_the_traffic(chunk_mb, cut):
    if cut is None:
        _, _, _, traffic = run.load_cell("fast-v2.silesia")
    else:
        _, _, _, traffic = small_cell("fast-v2.silesia", **cut)
    chunk = chunk_mb << 20
    chunks = 0
    for data in corpus.make_corpus(traffic, 2**31 + 21, chunk, 4032):
        for off in range(0, data.size, chunk):
            h = np.bincount(data[off : off + chunk], minlength=256)
            assert np.array_equal(code_lengths(h, "java"), build_code_lengths(h, "java", 0))
            chunks += 1
    assert chunks == (19 if cut is None else 17)


def _digest(expected: dict) -> str:
    h = hashlib.sha256()
    h.update(repr((expected["size"], expected["chunk_bytes"], expected["subblock"])).encode())
    h.update(expected["global_sha256"])
    h.update(expected["input_sha256"])
    for c in expected["chunks"]:
        h.update(repr((c["n"], c["raw"], c["size"], c["depth"])).encode())
        h.update(c["sha256"])
        h.update(c["payload_sha256"])
        h.update(c["lengths"].astype("<i8").tobytes())
        h.update(c["gaps"].astype("<u4").tobytes())
    return h.hexdigest()


def _pinned_corpus(traffic: dict, seed: int, chunk_bytes: int, subblock: int) -> list:
    """The bytes the pins were worked out on: the corpus as it was made
    before its seed stopped reordering each chunk's sub-blocks."""
    pools = corpus.make_pools(traffic)
    rng = np.random.default_rng(seed)
    out = []
    for i, f in enumerate(traffic["files"]):
        pool = pools[f["generator"]]
        windows = np.lib.stride_tricks.sliding_window_view(pool, subblock)
        label = rng.permutation(256).astype(np.uint8)
        parts = []
        for offsets, tail_at, tail in corpus.base_pieces(traffic, i, chunk_bytes, subblock):
            parts.append(windows[offsets[rng.permutation(offsets.size)]].reshape(-1))
            parts.append(pool[tail_at : tail_at + tail])
        out.append(label[np.concatenate(parts)])
    return out


#: (.dcz bytes, sidecar bytes) of each file and a digest of every expected
#: container, worked out by the harness before it judged format 1
FORMAT2_PINS = {
    "fast-v2.silesia": (
        [(277925, 1127), (2175942, 4323), (288334, 1110), (1058865, 2863), (262579, 927),
         (318482, 1120), (180813, 951), (667057, 2269), (304063, 975), (1128332, 3259),
         (161683, 883), (165120, 1041)],
        "e29fed6aa45e7250e98767008f42284a"),
    "device-v2.silesia": (
        [(277336, 1127), (2175942, 4323), (287762, 1110), (1057319, 2863), (262579, 927),
         (318032, 1120), (180418, 951), (664816, 2269), (304063, 975), (1125877, 3259),
         (161111, 883), (165120, 1041)],
        "f9f9bf77d004db2422cbbeae0d20ec8b"),
}


@pytest.mark.parametrize("workload", sorted(FORMAT2_PINS))
def test_format2_reckoning_and_containers_are_unchanged(workload):
    _, _, config_doc, traffic = small_cell(workload, files=12, scale=20)
    rule = config_doc["codebook_rule"]
    datas = _pinned_corpus(traffic, 2**31 + 77, 1 << 20, 4032)
    sizes = [run.container_sizes(d, f["name"], 1 << 20, 4032, rule, 2)
             for d, f in zip(datas, traffic["files"])]
    digests = "".join(_digest(expected_file(d, 1 << 20, rule, 4032, version=2)) for d in datas)
    assert (sizes, hashlib.sha256(digests.encode()).hexdigest()[:32]) == FORMAT2_PINS[workload]
