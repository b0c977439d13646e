"""Canonical Huffman codebook construction.

The port's copy of ``datacomp_tpu/core/huffman.py``, held to the same bytes by
``tests/test_torch_host.py``.

Host-side (numpy) construction of per-chunk canonical Huffman codebooks. Two
modes are provided:

* ``build_code_lengths(freqs, mode="java")`` replicates the reference
  implementation's tree construction *exactly*, including tie-breaking, so the
  emitted bitstreams are bit-identical to the Java reference
  (``core/CanonicalHuffman.java:55-92`` + ``core/HuffmanNode.java:52-57`` in the
  reference repo).  The reference uses ``java.util.PriorityQueue`` — an
  array-based binary heap whose ordering among *equal* elements depends on the
  heap's sift algorithms — so this module implements the same binary-heap
  sift-up/sift-down rules rather than Python's ``heapq`` (which breaks ties
  differently).

* ``mode="fast"`` uses the classic O(n log n) sorted two-queue merge, which
  produces an equally optimal (same total bits ⇒ same compressed size) but not
  necessarily bit-identical code.  Files written with it remain fully readable
  by the reference decoder, because the container stores code *lengths* and
  canonical codes are derived from lengths alone.

Canonical code assignment follows the reference recurrence
(``core/CanonicalHuffman.java:99-132``):
``firstCode[len] = (firstCode[len-1] + count[len-1]) << 1``; within a length,
codes are assigned in increasing symbol order.
"""

from __future__ import annotations

import numpy as np

ALPHABET_SIZE = 256
#: Maximum code length representable by the reference's 32-bit codeword ints.
MAX_CODE_LEN = 32


class CorruptChunkError(ValueError):
    """A chunk's stored data does not decode: a stream that holds no code of
    its codebook, or a code-length table that is no prefix code.  Deep
    verify reads it as a corrupt file; every other error propagates."""


# ---------------------------------------------------------------------------
# Java PriorityQueue replica
# ---------------------------------------------------------------------------


class _JavaHeap:
    """Array-based binary min-heap with java.util.PriorityQueue's exact sift
    semantics.  Elements are ``(freq, symbol, payload)`` where internal tree
    nodes carry ``symbol == -1`` (matching the reference's ``HuffmanNode``
    comparator: order by frequency, then by symbol)."""

    __slots__ = ("_q", "_size")

    def __init__(self) -> None:
        self._q: list = []
        self._size = 0

    @staticmethod
    def _less(a, b) -> bool:
        # compareTo(a, b) < 0
        if a[0] != b[0]:
            return a[0] < b[0]
        return a[1] < b[1]

    def offer(self, e) -> None:
        q = self._q
        k = self._size
        if k == len(q):
            q.append(None)
        self._size = k + 1
        # siftUp
        while k > 0:
            parent = (k - 1) >> 1
            p = q[parent]
            if not self._less(e, p):
                break
            q[k] = p
            k = parent
        q[k] = e

    def poll(self):
        size = self._size - 1
        q = self._q
        result = q[0]
        x = q[size]
        q[size] = None
        self._size = size
        if size != 0:
            # siftDown(0, x)
            k = 0
            half = size >> 1
            while k < half:
                child = 2 * k + 1
                c = q[child]
                right = child + 1
                if right < size and self._less(q[right], c):
                    child = right
                    c = q[child]
                if not self._less(c, x):
                    break
                q[k] = c
                k = child
            q[k] = x
        return result

    def __len__(self) -> int:
        return self._size


def _lengths_java(freqs: np.ndarray) -> np.ndarray:
    """Exact replica of the reference tree build + depth extraction."""
    heap = _JavaHeap()
    for sym in range(ALPHABET_SIZE):
        f = int(freqs[sym])
        if f > 0:
            heap.offer((f, sym, sym))  # leaf payload = symbol
    # Build tree; payload of an internal node is (left_payload, right_payload).
    while len(heap) > 1:
        left = heap.poll()
        right = heap.poll()
        heap.offer((left[0] + right[0], -1, (left[2], right[2])))

    lengths = np.zeros(ALPHABET_SIZE, dtype=np.int32)
    if len(heap) == 0:
        return lengths
    root = heap.poll()[2]
    # Iterative depth extraction (the reference recurses; order is irrelevant
    # for the resulting lengths).
    stack = [(root, 0)]
    while stack:
        node, depth = stack.pop()
        if isinstance(node, tuple):
            stack.append((node[0], depth + 1))
            stack.append((node[1], depth + 1))
        else:
            lengths[node] = depth
    return lengths


def _lengths_fast(freqs: np.ndarray) -> np.ndarray:
    """Two-queue O(n log n) Huffman length construction (not bit-identical to
    the Java reference on frequency ties, but same optimal total length)."""
    syms = np.nonzero(freqs > 0)[0]
    n = len(syms)
    lengths = np.zeros(ALPHABET_SIZE, dtype=np.int32)
    if n == 0:
        return lengths
    if n == 1:
        lengths[syms[0]] = 1
        return lengths
    order = np.argsort(freqs[syms], kind="stable")
    leaf_syms = syms[order]
    leaf_freqs = freqs[leaf_syms].astype(np.int64)

    # parent pointers over 2n-1 node slots: leaves [0,n), internals [n, 2n-1)
    parent = np.full(2 * n - 1, -1, dtype=np.int32)
    node_freq = np.empty(2 * n - 1, dtype=np.int64)
    node_freq[:n] = leaf_freqs
    li = 0  # next leaf
    ii = n  # next unconsumed internal
    nxt = n  # next internal slot to create
    for _ in range(n - 1):
        picks = []
        for _ in range(2):
            if li < n and (ii >= nxt or node_freq[li] <= node_freq[ii]):
                picks.append(li)
                li += 1
            else:
                picks.append(ii)
                ii += 1
        parent[picks[0]] = nxt
        parent[picks[1]] = nxt
        node_freq[nxt] = node_freq[picks[0]] + node_freq[picks[1]]
        nxt += 1
    # depth of each leaf = chain length to root (root = 2n-2)
    depth = np.zeros(2 * n - 1, dtype=np.int32)
    for node in range(2 * n - 3, -1, -1):
        depth[node] = depth[parent[node]] + 1
    lengths[leaf_syms] = depth[:n]
    return lengths


def _lengths_package_merge(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Optimal *length-limited* code lengths via package-merge.

    Classic Larmore–Hirschberg construction: level ``max_len`` holds the items
    only; each shallower level merges the items with pairwise "packages" of
    the level below; the first ``2n - 2`` nodes of level 1 are selected, and a
    leaf's code length is the number of selected (transitively expanded) nodes
    containing it.  Deterministic: merges are stable with leaves preferred on
    weight ties.  The reference has no equivalent (its codes are unbounded up
    to the 32-bit codeword int, ``core/CanonicalHuffman.java``); this exists
    so every chunk can stay on the device decode path, whose comparison
    decoder needs codes ≤ 16 bits (``ops/decode.py``).
    """
    syms = np.nonzero(freqs > 0)[0]
    n = int(syms.size)
    if n > (1 << max_len):
        raise ValueError(f"{n} symbols cannot fit in {max_len}-bit codes")
    order = np.lexsort((syms, freqs[syms]))  # weight, then symbol: determinism
    items = freqs[syms][order].astype(np.int64)

    # levels[l] = list of (weight, is_leaf, a, b); packages reference the two
    # node indices of the level BELOW (l+1); leaves carry the item index.
    levels: list[list] = [None] * (max_len + 1)
    below: list = []
    for level in range(max_len, 0, -1):
        pkgs = [
            (below[2 * i][0] + below[2 * i + 1][0], False, 2 * i, 2 * i + 1)
            for i in range(len(below) // 2)
        ]
        merged, li, pi = [], 0, 0
        while li < n or pi < len(pkgs):
            if pi >= len(pkgs) or (li < n and items[li] <= pkgs[pi][0]):
                merged.append((int(items[li]), True, li, -1))
                li += 1
            else:
                merged.append(pkgs[pi])
                pi += 1
        levels[level] = merged
        below = merged

    counts = np.zeros(n, dtype=np.int32)
    stack = [(1, i) for i in range(2 * n - 2)]
    while stack:
        level, idx = stack.pop()
        _, is_leaf, a, b = levels[level][idx]
        if is_leaf:
            counts[a] += 1
        else:
            stack.append((level + 1, a))
            stack.append((level + 1, b))

    lengths = np.zeros(ALPHABET_SIZE, dtype=np.int32)
    lengths[syms[order]] = counts
    return lengths


#: sentinel for max_len: pick the cheapest cap automatically (see
#: :func:`resolve_auto_cap`)
AUTO_CAP = -1
#: candidate caps, shallowest first.  Each tier raises the device decoder's
#: symbols-per-refill rate (``ops/decode.py syms_per_refill``; at the
#: production 8-word refill: ≤8 bits → 32 sym/refill, ≤10 → 24, ≤16 → 16).
#: 256 symbols always fit in 8 bits, so every tier is feasible for byte data.
AUTO_CAP_TIERS = (8, 10, 16)
#: relative compressed-size budget the auto policy may spend for decode speed
AUTO_CAP_BUDGET = 0.005


def resolve_auto_cap(
    freqs: np.ndarray, lengths_opt: np.ndarray, budget: float = AUTO_CAP_BUDGET
) -> int:
    """Pick the shallowest cap whose bit cost over the optimal code stays
    under ``budget`` (0.5% default); 0 if no tier fits the budget.

    Measured lever (docs/BENCHMARKS.md hot-spot #1): device decode runs
    ``k = 32 / max_len`` symbols per refill, so capping a 14-bit text
    codebook to 8 bits doubles decode throughput for (typically) <0.2% size.
    The histogram is already computed, so each tier costs one package-merge
    over ≤256 symbols — microseconds against a 16 MB chunk encode.
    """
    opt_bits = int(freqs @ lengths_opt.astype(np.int64))
    if opt_bits <= 0:
        return 0
    ml = int(lengths_opt.max())
    for cap in AUTO_CAP_TIERS:
        if ml <= cap:
            return cap  # already within this tier: capping is free
        capped = _lengths_package_merge(freqs, cap)
        cost = int(freqs @ capped.astype(np.int64)) - opt_bits
        if cost <= budget * opt_bits:
            return cap
    return 0


def build_code_lengths(
    freqs: np.ndarray, mode: str = "java", max_len: int = 0
) -> np.ndarray:
    """Per-symbol canonical Huffman code lengths from a 256-bin histogram.

    Edge cases match the reference (``CanonicalHuffman.java:31-45``): an empty
    histogram yields all-zero lengths; a single distinct symbol gets a 1-bit
    code.

    ``max_len > 0`` caps code lengths: when the unconstrained code already
    fits it is returned unchanged (so ``mode="java"`` stays bit-exact), else
    the optimal length-limited code is built with package-merge.
    ``max_len == AUTO_CAP`` picks the shallowest cap costing < 0.5% extra
    bits (:func:`resolve_auto_cap`) — the default for v2 containers, keeping
    decode on-device at the highest symbols-per-refill rate.
    """
    freqs = np.asarray(freqs)
    if freqs.shape != (ALPHABET_SIZE,):
        raise ValueError("frequency array must have 256 elements")
    if max_len < AUTO_CAP or max_len > MAX_CODE_LEN:
        raise ValueError(
            f"max_len must be {AUTO_CAP} (auto), 0 (unlimited) or 1..{MAX_CODE_LEN}"
        )
    nsyms = int(np.count_nonzero(freqs > 0))
    if nsyms == 0:
        return np.zeros(ALPHABET_SIZE, dtype=np.int32)
    if nsyms == 1:
        lengths = np.zeros(ALPHABET_SIZE, dtype=np.int32)
        lengths[int(np.argmax(freqs > 0))] = 1
        return lengths
    lengths = _lengths_java(freqs) if mode == "java" else _lengths_fast(freqs)
    if max_len == AUTO_CAP:
        max_len = resolve_auto_cap(freqs, lengths)
    if max_len and int(lengths.max()) > max_len:
        lengths = _lengths_package_merge(freqs, max_len)
    if int(lengths.max()) > MAX_CODE_LEN:
        raise ValueError(
            f"Huffman code length {int(lengths.max())} exceeds {MAX_CODE_LEN} "
            "bits; chunk too skewed — reduce chunk size"
        )
    return lengths


def canonical_codes_from_lengths(lengths: np.ndarray) -> np.ndarray:
    """Canonical codewords (uint32) for each symbol given code lengths.

    Mirrors the reference's assignment (``CanonicalHuffman.java:99-132``):
    shorter codes numerically smaller, same-length codes consecutive in symbol
    order.  Symbols with length 0 get codeword 0 (unused).
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    if lengths.shape != (ALPHABET_SIZE,):
        raise ValueError("code lengths array must have 256 elements")
    codes = np.zeros(ALPHABET_SIZE, dtype=np.uint32)
    used = lengths > 0
    if not used.any():
        return codes
    max_len = int(lengths.max())
    if max_len > MAX_CODE_LEN:
        raise ValueError(f"code length {max_len} exceeds {MAX_CODE_LEN}")
    counts = np.bincount(lengths[used], minlength=max_len + 1)
    first = np.zeros(max_len + 1, dtype=np.int64)
    code = 0
    for ln in range(1, max_len + 1):
        code = (code + counts[ln - 1]) << 1
        first[ln] = code
    # within each length, rank symbols in increasing symbol order
    order = np.lexsort((np.arange(ALPHABET_SIZE), lengths))  # sort by length, then symbol
    ranks = np.zeros(ALPHABET_SIZE, dtype=np.int64)
    sorted_lens = lengths[order]
    # position within the run of equal lengths
    run_start = np.r_[0, np.nonzero(np.diff(sorted_lens))[0] + 1]
    starts = np.zeros(ALPHABET_SIZE, dtype=np.int64)
    starts[run_start] = run_start
    starts = np.maximum.accumulate(starts)
    ranks[order] = np.arange(ALPHABET_SIZE) - starts
    codes[used] = (first[lengths[used]] + ranks[used]).astype(np.uint32)
    return codes


def build_codebook(freqs: np.ndarray, mode: str = "java", max_len: int = 0):
    """Histogram → (lengths int32[256], codewords uint32[256])."""
    lengths = build_code_lengths(freqs, mode=mode, max_len=max_len)
    return lengths, canonical_codes_from_lengths(lengths)


def validate_lengths(lengths: np.ndarray) -> bool:
    """Kraft-inequality + canonical feasibility check for stored lengths."""
    lengths = np.asarray(lengths, dtype=np.int64)
    used = lengths > 0
    if not used.any():
        return True
    if lengths.min() < 0 or lengths[used].max() > MAX_CODE_LEN:
        return False
    kraft = np.sum(2.0 ** (-lengths[used].astype(np.float64)))
    return kraft <= 1.0 + 1e-12
