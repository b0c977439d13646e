"""A numpy model of K4's schedule (``datacomp_tpu_torch/csrc/codebook.cu``),
held to the plain version ``codebook_reference`` and to the JAX device
builder (``device_code_lengths`` / ``device_canonical_codes``) on the CPU.

The kernel cannot run here, so its algorithm is modelled step for step: the
sort (a bitonic network of shuffles within each warp of 32 (key, symbol)
pairs, absent symbols keyed last, then each thread's rank as the count of
smaller pairs in the 8 sorted runs); the merge in rounds
on one warp, each of which puts the first 32 nodes of the two queues on the
lanes (lane k finds node k by a merge-path search) and pairs at once every
lane that the serial two-queue merge would pop before it pops a node made in
that round (weight up to ``s1``, the sum of the first pair, an even number
of them), with saturating 32-bit sums; the depths by parent-pointer doubling
until every pointer reaches the root; the counts per length from each warp's
groups of equal lengths, the first code of each length by a shift-and-add
scan over 32 lanes, and each symbol's rank among the same-length symbols
below it. The model must return exactly the plain version's lengths and
codes (and the JAX builder's, wherever its int32 sums are exact), each
round's lanes must hold the serial merge's next 32 nodes, and the kernel's
preconditions must hold in every round.

The kernel itself is held to ``codebook_reference`` on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

from fractions import Fraction

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from datacomp_tpu.ops.codebook import device_canonical_codes, device_code_lengths  # noqa: E402
from datacomp_tpu_torch import ops  # noqa: E402
from datacomp_tpu_torch.ops.codebook import _merge_depths  # noqa: E402
from datacomp_tpu_torch.utils.testdata import generate_bytes  # noqa: E402
from test_torch_codebook import _fibonacci, _fuzz_histograms  # noqa: E402

THREADS = 256
LANES = 32
MAX_LEN = 32
ABSENT = 0xFFFFFFFF  # key of an absent symbol
TOP = 0xFFFFFFFE  # sums saturate here
MASK = 0xFFFFFFFF
#: histogram totals up to which the JAX builder's int32 sums are exact
JAX_EXACT_TOTAL = 1 << 30


def bitonic_runs(values: np.ndarray) -> np.ndarray:
    """Each warp's 32 values sorted by the kernel's network of shuffles."""
    v = values.reshape(-1, LANES).copy()
    lane = np.arange(LANES)
    k = 2
    while k <= LANES:
        j = k >> 1
        while j > 0:
            other = v[:, lane ^ j]
            keep_min = ((lane & j) == 0) == ((lane & k) == 0)
            v = np.where(keep_min, np.minimum(v, other), np.maximum(v, other))
            j >>= 1
        k <<= 1
    return v


def serial_merge_order(leaf, intern, li, ii, nsym, ni) -> list:
    """(weight, node) of the nodes left, in the serial merge's pop order."""
    out = []
    while li < nsym or ii < ni:
        if ii >= ni or (li < nsym and leaf[li] <= intern[ii]):
            out.append((int(leaf[li]), li))
            li += 1
        else:
            out.append((int(intern[ii]), THREADS + ii))
            ii += 1
    return out


def model(hist: np.ndarray) -> dict:
    """K4 on one int32[256] histogram: lengths, codes and the rounds of its
    merge and of its depth doubling."""
    t = np.arange(THREADS, dtype=np.int64)
    lane = np.arange(LANES, dtype=np.int64)
    f = np.asarray(hist, np.int64)
    present = f > 0
    nsym = int(present.sum())
    key = np.where(present, f, ABSENT)
    composite = (key << 8) | t
    runs = bitonic_runs(composite)
    assert np.all(np.diff(runs, axis=1) > 0)
    rank = sum(np.searchsorted(run, composite, side="left") for run in runs)
    leaf = np.full(THREADS, ABSENT, np.int64)
    leaf[rank[present]] = key[present]  # leaf slot -> weight; absent ones are never read
    assert np.array_equal(np.sort(rank[present]), np.arange(nsym))
    intern = np.full(THREADS, ABSENT, np.int64)  # internal node m -> weight
    parent = np.full(2 * THREADS, -1, np.int64)  # leaf slot k, internal node 256 + m

    li = ii = ni = 0  # next leaf, next unpaired internal node, internal nodes made
    merge_rounds = 0
    while (nsym - li) + (ni - ii) >= 2:
        na, nb = nsym - li, ni - ii
        lo, hi = np.maximum(lane - nb, 0), np.minimum(lane, na)
        for k in range(LANES):  # merge path: leaves among lane k's first k nodes
            while lo[k] < hi[k]:
                mid = (lo[k] + hi[k] + 1) >> 1
                if leaf[li + mid - 1] <= intern[ii + k - mid]:
                    lo[k] = mid
                else:
                    hi[k] = mid - 1
        j = lane - lo
        valid = lane < na + nb
        lf = np.where(lo < na, leaf[np.minimum(li + lo, THREADS - 1)], ABSENT)
        itf = np.where(j < nb, intern[np.minimum(ii + j, THREADS - 1)], ABSENT)
        is_leaf = valid & (lf <= itf)
        w = np.where(valid, np.where(is_leaf, lf, itf), ABSENT)
        node = np.where(is_leaf, li + lo, THREADS + ii + j)
        want = serial_merge_order(leaf, intern, li, ii, nsym, ni)[:LANES]
        assert list(zip(w[valid].tolist(), node[valid].tolist())) == want
        s1 = min(int(w[0]) + int(w[1]), TOP)
        cand = w <= s1
        count = int(cand.sum())
        assert cand[:count].all()  # a prefix of the lanes
        pairs = count // 2
        assert pairs >= 1
        paired = lane < 2 * pairs
        parent[node[paired]] = ni + lane[paired] // 2
        intern[ni : ni + pairs] = np.minimum(w[0 : 2 * pairs : 2] + w[1 : 2 * pairs : 2], TOP)
        taken = int((paired & is_leaf).sum())
        li, ii, ni = li + taken, ii + 2 * pairs - taken, ni + pairs
        merge_rounds += 1
    assert ni == max(nsym - 1, 0)
    parent_leaf, parent_intern = parent[:THREADS], parent[THREADS:]

    # depths of the internal nodes: doubling until every pointer is the root
    root = ni - 1
    m = np.arange(ni)
    ptr = np.where(m == root, m, parent_intern[:ni])
    depth = np.where(m == root, 0, 1)
    depth_rounds = 0
    while np.any(ptr != root):
        depth, ptr = depth + depth[ptr], ptr[ptr]
        depth_rounds += 1
    if nsym == 1:
        lengths = present.astype(np.int64)
    else:
        lengths = np.where(present, depth[parent_leaf[rank]] + 1 if nsym else 0, 0)

    # canonical codes: counts per length from each warp's groups, the first
    # code of each length by a scan over 32 lanes, ranks within a length
    bucket = np.where(lengths <= MAX_LEN, lengths, MAX_LEN + 1)
    warp, lane = t // LANES, t % LANES
    warp_counts = np.zeros((THREADS // LANES, MAX_LEN + 2), np.int64)
    np.add.at(warp_counts, (warp, bucket), 1)
    count = warp_counts.sum(0)  # count[l], l = 0 .. 33
    v = np.zeros(LANES, np.int64)  # lane i: the first code of length i + 1
    v[1:] = (count[1:LANES] << 1) & MASK
    for d in (1, 2, 4, 8, 16):
        v[d:] = (v[d:] + (v[:-d] << d)) & MASK
    first = np.concatenate([[0], v])
    before = np.array([(bucket[warp == warp[s]][: lane[s]] == bucket[s]).sum()
                       + warp_counts[: warp[s], bucket[s]].sum() for s in range(THREADS)])
    deep = lengths > MAX_LEN  # rare: ranked by a loop over the lower symbols
    before[deep] = [(lengths[:s] == lengths[s]).sum() for s in np.flatnonzero(deep)]
    codes = np.where(lengths > 0, (first[np.minimum(lengths, MAX_LEN)] + before) & MASK, 0)
    return {"lengths": lengths.astype(np.int32), "codes": codes.astype(np.uint32),
            "merge_rounds": merge_rounds, "depth_rounds": depth_rounds}


def _reference(hist: np.ndarray):
    lengths, codes = ops.codebook_reference(torch.from_numpy(hist.astype(np.int32)))
    return lengths.numpy(), codes.numpy()


def _jax(hist: np.ndarray):
    lengths = device_code_lengths(jnp.asarray(hist, dtype=jnp.int32))
    return np.asarray(lengths), np.asarray(device_canonical_codes(lengths))


def _check(hist: np.ndarray, jax_too: bool = True) -> dict:
    got = model(hist)
    want = _reference(hist)
    assert np.array_equal(got["lengths"], want[0])
    assert np.array_equal(got["codes"], want[1])
    if jax_too:
        assert int(hist.astype(np.int64).sum()) < JAX_EXACT_TOTAL
        jl, jc = _jax(hist)
        assert np.array_equal(got["lengths"], jl) and np.array_equal(got["codes"], jc)
    return got


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_matches_plain_and_jax(seed):
    for hist in _fuzz_histograms(seed, 20):
        _check(hist)


@pytest.mark.parametrize("depth", range(1, 41))
def test_fibonacci_one_pair_a_round(depth):
    got = _check(_fibonacci(depth))
    assert got["lengths"].max() == depth
    assert got["merge_rounds"] == depth  # each round can pair only the two lightest


@pytest.mark.parametrize("case", ["none", "one", "two", "all_equal", "pairs"])
def test_edge_cases(case):
    hist = np.zeros(256, np.int32)
    if case == "one":
        hist[77] = 5
    elif case == "two":
        hist[[3, 200]] = [9, 1]
    elif case == "all_equal":
        hist[:] = 4096
    elif case == "pairs":
        hist[:] = np.repeat(np.arange(1, 129), 2)
    got = _check(hist)
    want_rounds = {"none": 0, "one": 0, "two": 1, "all_equal": 19}
    if case in want_rounds:
        assert got["merge_rounds"] == want_rounds[case]


def _large_totals() -> list:
    """Histograms of a chunk of up to 2^31 - 1 bytes, and beyond: totals
    where the JAX builder's int32 sums overflow or pass its 2^30 sentinel."""
    rng = np.random.default_rng(31)
    top = (1 << 31) - 1
    out = []
    even = np.full(256, top // 256, np.int64)
    out.append(even)
    one_big = np.zeros(256, np.int64)
    one_big[5], one_big[[9, 10, 11]] = top - 3, 1
    out.append(one_big)
    for k in (2, 3, 17, 256):
        hist = np.zeros(256, np.int64)
        cuts = np.unique(rng.integers(1, top, k - 1))
        counts = np.diff(np.concatenate([[0], cuts, [top]]))
        hist[rng.choice(256, counts.size, replace=False)] = counts
        out.append(hist)
    fib = _fibonacci(40).astype(np.int64)
    out.append(fib * (top // int(fib.sum())))
    # totals up to 2^32 - 2, where the kernel's 32-bit sums are still exact
    out.append(np.full(256, ((1 << 32) - 2) // 256, np.int64))
    near = np.zeros(256, np.int64)
    near[[0, 1, 2]] = [top, top - 2, 2]  # the root's weight is 2^32 - 2 itself
    out.append(near)
    return out


@pytest.mark.parametrize("i", range(9))
def test_large_totals_match_the_plain_merge(i):
    hist = _large_totals()[i]
    assert int(hist.sum()) <= TOP and hist.max() < 1 << 31
    got = _check(hist.astype(np.int32), jax_too=False)
    present = hist > 0
    keys = np.where(present, hist, 1 << 62)
    order = np.argsort(keys, kind="stable")
    depths = _merge_depths(keys[order].tolist(), int(present.sum()))
    assert np.array_equal(got["lengths"][order[: len(depths)]], depths)


def test_beyond_the_exact_range_still_ends_with_a_complete_code():
    """Totals above 2^32 - 2 saturate the kernel's sums: the merge still
    ends, and the code is still complete (Kraft sum 1)."""
    hist = np.full(256, (1 << 31) - 1, np.int64)
    hist[::3] = 1 << 20
    got = model(hist.astype(np.int32))
    assert got["merge_rounds"] <= 255
    assert sum(Fraction(1, 1 << int(n)) for n in got["lengths"]) == 1


@pytest.fixture(scope="module")
def corpus_histograms():
    return {kind: np.bincount(np.frombuffer(generate_bytes(kind, 16 << 20), np.uint8),
                              minlength=256).astype(np.int32)
            for kind in ("text", "skewed", "compressible", "random")}


#: (merge rounds, depth rounds) on 16 MiB chunks of each kind (PERF.md)
CORPUS_ROUNDS = {"text": (10, 4), "skewed": (24, 5), "compressible": (6, 3),
                 "random": (19, 3)}


@pytest.mark.parametrize("kind", sorted(CORPUS_ROUNDS))
def test_corpus_chunks(corpus_histograms, kind):
    got = _check(corpus_histograms[kind])
    assert (got["merge_rounds"], got["depth_rounds"]) == CORPUS_ROUNDS[kind]
