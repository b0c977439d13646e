"""The `.dcz` formats 1 and 2 worked out from the input bytes alone.

What a file's container must hold, chunk by chunk: its SHA-256, its code
lengths under the configuration's codebook rule, the raw-store decision, the
canonical-Huffman payload (32-bit words, most significant bit first, cut to
whole bytes) and, in format 2, the gap array (the start bit of every
sub-block).  Written from the format's description
(``docs/FILE_FORMAT.md``) with NumPy, and sharing no code with the program
under test.

Format 1 is the reference's own container: its footer has no sub-block
field, its chunk records no gap count and no gap array, and it has no raw
store: every chunk is coded, even where coding does not shrink it.

Codebook rules (the configuration file names one):

* ``optimal``: Huffman code lengths from a two-queue merge over the present
  symbols sorted by (count, symbol), a leaf taken before an internal node of
  equal weight; one present symbol gets a 1-bit code.
* ``optimal_auto_cap``: the ``optimal`` lengths, then in format 2 the
  shallowest cap of 8, 10 and 16 bits whose optimal length-limited code costs
  at most 0.5 % more bits than the optimal code (none if none does); a cap
  below the optimal depth takes package-merge over (count, symbol), a leaf
  taken before a package of equal weight.
* ``java``: the reference's tree build.  The present symbols are offered in
  symbol order to a binary min-heap that sifts as ``java.util.PriorityQueue``
  does (``siftUp`` on offer; on poll the last element ``siftDown`` from the
  root, to the smaller child, the left one on a tie, while that child is
  strictly smaller), ordered by (count, symbol), where an internal node
  carries the symbol -1, so it comes before a leaf of equal count and ties
  with another internal node.  Two polls make a node of their summed count,
  offered back, until one node is left; the lengths are the leaves' depths.
  One present symbol gets a 1-bit code, none gets all zeros.  Equally
  optimal, but its ties fall otherwise than ``optimal``'s.

In format 2 a chunk whose coded size is at least its size in bits is stored
raw: its bytes, all-zero lengths and no gap array.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

MAGIC = 0x44435A46
ALPHABET = 256
CAP_TIERS = (8, 10, 16)
CAP_BUDGET = 0.005
CODEBOOK_RULES = ("optimal", "optimal_auto_cap", "java")


# -- code lengths --------------------------------------------------------------


def _sorted_present(hist: np.ndarray):
    """Present symbols ordered by (count, symbol), and their counts."""
    syms = np.flatnonzero(hist > 0)
    order = np.lexsort((syms, hist[syms]))
    return syms[order], hist[syms][order].astype(np.int64)


def _huffman_depths(weights: list) -> list:
    """Leaf depths of the two-queue Huffman merge over ascending weights."""
    n = len(weights)
    node_w = list(weights) + [0] * (n - 1)
    parent = [0] * (2 * n - 1)
    leaf, inner, made = 0, n, n
    for _ in range(n - 1):
        pair = []
        for _ in range(2):
            if leaf < n and (inner >= made or node_w[leaf] <= node_w[inner]):
                pair.append(leaf)
                leaf += 1
            else:
                pair.append(inner)
                inner += 1
        node_w[made] = node_w[pair[0]] + node_w[pair[1]]
        parent[pair[0]] = parent[pair[1]] = made
        made += 1
    depth = [0] * (2 * n - 1)
    for k in range(2 * n - 3, -1, -1):
        depth[k] = depth[parent[k]] + 1
    return depth[:n]


def _java_heap_depths(counts: list) -> list:
    """Leaf depths of the reference's tree build over ``counts``, the
    present symbols' counts in symbol order (see the module's ``java``)."""
    n = len(counts)
    parent = [0] * (2 * n - 1)
    heap: list = []  # (count, symbol or -1, node); ordered by the first two

    def less(a, b) -> bool:
        return a[0] < b[0] or (a[0] == b[0] and a[1] < b[1])

    def offer(e) -> None:
        k = len(heap)
        heap.append(e)
        while k > 0 and less(e, heap[(k - 1) // 2]):
            heap[k] = heap[(k - 1) // 2]
            k = (k - 1) // 2
        heap[k] = e

    def poll():
        top, last = heap[0], heap.pop()
        size = len(heap)
        if size:
            k = 0
            while 2 * k + 1 < size:
                child = 2 * k + 1
                if child + 1 < size and less(heap[child + 1], heap[child]):
                    child += 1
                if not less(heap[child], last):
                    break
                heap[k] = heap[child]
                k = child
            heap[k] = last
        return top

    for leaf, count in enumerate(counts):
        offer((count, leaf, leaf))
    for made in range(n, 2 * n - 1):
        a, b = poll(), poll()
        parent[a[2]] = parent[b[2]] = made
        offer((a[0] + b[0], -1, made))
    depth = [0] * (2 * n - 1)
    for k in range(2 * n - 3, -1, -1):
        depth[k] = depth[parent[k]] + 1
    return depth[:n]


def _package_merge_depths(weights: list, cap: int) -> list:
    """Leaf depths of the optimal code of at most ``cap`` bits over ascending
    weights.  Each level merges the leaves with the pairs of the level below,
    a leaf first on equal weight; the first 2n - 2 entries of the top level
    are chosen, and the chosen entries of every level form a prefix, so a
    leaf's depth is the number of levels whose chosen prefix holds it."""
    n = len(weights)
    levels = []  # deepest first: each a list of (weight, is_leaf)
    below: list = []
    for _ in range(cap):
        packs = [below[2 * i][0] + below[2 * i + 1][0] for i in range(len(below) // 2)]
        merged, li, pi = [], 0, 0
        while li < n or pi < len(packs):
            if pi >= len(packs) or (li < n and weights[li] <= packs[pi]):
                merged.append((weights[li], True))
                li += 1
            else:
                merged.append((packs[pi], False))
                pi += 1
        levels.append(merged)
        below = merged
    depths = [0] * n
    take = 2 * n - 2
    for merged in reversed(levels):  # the top level first
        chosen = merged[:take]
        leaves = sum(1 for _, is_leaf in chosen if is_leaf)
        for j in range(leaves):
            depths[j] += 1
        take = 2 * (len(chosen) - leaves)
    return depths


def code_lengths(hist: np.ndarray, rule: str) -> np.ndarray:
    """int64[256] code lengths of a 256-bin histogram under ``rule``."""
    if rule not in CODEBOOK_RULES:
        raise ValueError(f"unknown codebook rule {rule!r}")
    hist = np.asarray(hist, dtype=np.int64)
    lengths = np.zeros(ALPHABET, np.int64)
    syms, weights = _sorted_present(hist)
    if syms.size == 1:
        lengths[syms[0]] = 1
    if syms.size <= 1:
        return lengths
    if rule == "java":
        present = np.flatnonzero(hist > 0)
        lengths[present] = _java_heap_depths(hist[present].tolist())
        return lengths
    w = weights.tolist()
    lengths[syms] = _huffman_depths(w)
    if rule == "optimal_auto_cap":
        best = int(hist @ lengths)
        deepest = int(lengths.max())
        for cap in CAP_TIERS:
            if deepest <= cap:
                break
            capped = np.zeros(ALPHABET, np.int64)
            capped[syms] = _package_merge_depths(w, cap)
            if int(hist @ capped) - best <= CAP_BUDGET * best:
                lengths = capped
                break
    return lengths


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """uint64[256] canonical codewords: shorter codes first, equal lengths in
    symbol order."""
    lengths = np.asarray(lengths, dtype=np.int64)
    codes = np.zeros(ALPHABET, np.uint64)
    code, prev = 0, 0
    for sym in np.lexsort((np.arange(ALPHABET), lengths)):
        ln = int(lengths[sym])
        if ln == 0:
            continue
        code <<= ln - prev
        prev = ln
        codes[sym] = code
        code += 1
    return codes


# -- payload -------------------------------------------------------------------


def encode_payload(x: np.ndarray, lengths: np.ndarray, codes: np.ndarray, subblock: int):
    """(payload bytes, total bits, uint32 gap array) of the symbols ``x``.

    Every symbol's code is placed in a 64-bit window that starts at the word
    holding its first bit; the windows of the symbols that start in one word
    cover disjoint bits, so their sum is their OR."""
    if x.size > 1 << 26:
        raise ValueError("bit offsets of more than 2**26 symbols can pass int32")
    lens = np.asarray(lengths, np.int32)[x]
    starts = np.cumsum(lens, dtype=np.int32)
    total = int(starts[-1]) if starts.size else 0
    starts -= lens
    shift = np.int32(64) - lens
    shift -= starts & 31
    del lens
    val = np.asarray(codes, np.uint64)[x]
    val <<= shift.astype(np.uint8)
    del shift
    word = starts >> 5
    heads = np.flatnonzero(word[1:] != word[:-1])
    heads += 1
    heads = np.concatenate(([0], heads))
    sums = np.add.reduceat(val, heads)
    del val
    at = word[heads]
    del word
    nwords = (total + 31) // 32
    words = np.zeros(nwords + 2, np.uint64)
    words[at] += sums >> np.uint64(32)
    words[at + 1] += sums & np.uint64(0xFFFFFFFF)
    payload = words[:nwords].astype(">u4").tobytes()[: (total + 7) // 8]
    gaps = starts[::subblock].astype(np.uint32) if subblock else np.zeros(0, np.uint32)
    return payload, total, gaps


def expected_chunk(x: np.ndarray, rule: str, subblock: int, version: int = 2) -> dict:
    """What format ``version`` stores for the chunk ``x`` (uint8); format 1
    takes ``subblock`` 0."""
    sha = hashlib.sha256(x).digest()
    hist = np.bincount(x, minlength=ALPHABET).astype(np.int64)
    lengths = code_lengths(hist, rule)
    bits = int(hist @ lengths)
    if version >= 2 and bits >= 8 * x.size:
        return {"sha256": sha, "raw": True, "n": int(x.size),
                "lengths": np.zeros(ALPHABET, np.int64),
                "size": int(x.size), "payload_sha256": sha,
                "gaps": np.zeros(0, np.uint32), "depth": 0}
    payload, total, gaps = encode_payload(x, lengths, canonical_codes(lengths), subblock)
    if total != bits:
        raise AssertionError(f"reference encoder wrote {total} bits, the histogram gives {bits}")
    return {"sha256": sha, "raw": False, "n": int(x.size), "lengths": lengths,
            "size": len(payload),
            "payload_sha256": hashlib.sha256(payload).digest(), "gaps": gaps,
            "depth": int(lengths.max())}


def expected_file(data: np.ndarray, chunk_bytes: int, rule: str, subblock: int,
                  pool=None, version: int = 2) -> dict:
    """The format-``version`` container's expected contents for the file
    ``data``: its size, chunk size, sub-block (0 in format 1), the file's own
    SHA-256 (for the restore), the global SHA-256 (over the chunks' digests
    in order) and each chunk's :func:`expected_chunk`.  ``pool`` (an
    executor) works the chunks out side by side."""
    views = [data[o : o + chunk_bytes] for o in range(0, data.size, chunk_bytes)]
    if pool is None:
        chunks = [expected_chunk(v, rule, subblock, version) for v in views]
    else:
        chunks = list(pool.map(lambda v: expected_chunk(v, rule, subblock, version), views))
    whole = hashlib.sha256()
    for c in chunks:
        whole.update(c["sha256"])
    return {"size": int(data.size), "chunk_bytes": chunk_bytes, "subblock": subblock,
            "global_sha256": whole.digest(), "input_sha256": hashlib.sha256(data).digest(),
            "chunks": chunks}


# -- container -----------------------------------------------------------------


class _Cursor:
    def __init__(self, buf: bytes, at: int):
        self.buf, self.at = buf, at

    def take(self, n: int) -> bytes:
        if n < 0 or self.at + n > len(self.buf):
            raise ValueError("footer runs past the end of the file")
        out = self.buf[self.at : self.at + n]
        self.at += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))


def parse_container(buf: bytes) -> dict:
    """A footer-last `.dcz` file: its header fields, each chunk's table entry
    and payload digest, and the layout facts the judge checks.  Raises
    ValueError on a file that does not parse."""
    if len(buf) < 8:
        raise ValueError("file too short for a footer pointer")
    (footer_at,) = struct.unpack(">q", buf[-8:])
    if not 0 <= footer_at <= len(buf) - 8:
        raise ValueError(f"footer pointer {footer_at} out of range")
    cur = _Cursor(buf, footer_at)
    magic, version, name_len = cur.unpack(">iii")
    if magic != MAGIC:
        raise ValueError("bad magic")
    name = cur.take(name_len).decode("utf-8", "replace")
    size, mtime_ms, chunk_bytes = cur.unpack(">qqi")
    global_sha = cur.take(32)
    subblock = cur.unpack(">i")[0] if version >= 2 else 0
    (count,) = cur.unpack(">i")
    chunks = []
    for _ in range(max(count, 0)):
        index, orig_off, orig_size, comp_off, comp_size = cur.unpack(">iqiqi")
        sha_at = cur.at
        sha = cur.take(32)
        lengths = np.frombuffer(cur.take(512), ">i2").astype(np.int64)
        gaps = np.zeros(0, np.uint32)
        if version >= 2:
            (ngaps,) = cur.unpack(">i")
            gaps = np.frombuffer(cur.take(4 * ngaps), ">u4").astype(np.uint32)
        inside = 0 <= comp_off and comp_off + comp_size <= footer_at and comp_size >= 0
        digest = hashlib.sha256(buf[comp_off : comp_off + comp_size]).digest() if inside else b""
        chunks.append({"index": index, "orig_offset": orig_off, "orig_size": orig_size,
                       "comp_offset": comp_off, "size": comp_size, "sha256": sha,
                       "sha_at": sha_at, "lengths": lengths, "gaps": gaps, "payload_sha256": digest,
                       "inside": inside})
    return {"version": version, "name": name, "size": size, "mtime_ms": mtime_ms,
            "chunk_bytes": chunk_bytes, "global_sha256": global_sha, "subblock": subblock,
            "count": count, "chunks": chunks, "footer_at": footer_at,
            "footer_end": cur.at, "file_bytes": len(buf)}
