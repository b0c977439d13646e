"""The traffic's bytes: a frozen copy of the program's test-data generators
(``datacomp_tpu_torch/utils/testdata.py``'s corpus kinds),
two 16-bit grey-image generators of the benchmark's own, and the assembly of
Silesia-sized files from them.

A file of kind K is built chunk by chunk from sub-block-sized pieces of a
pool of K's bytes; which pieces, and the pools, follow the traffic file's
fixed corpus seed alone.  The run's seed then only relabels the 256 byte
values (a permutation a file).  Each chunk's histogram is so the same up to
relabelling for every seed: its code-length multiset, coded bits, raw-store
decision and gap-array size are fixed, and so is where in the chunk each
code length falls (up to ties), which sets the device's work: an order of
the sub-blocks drawn from the seed would move the decode kernel's time by
up to a sixth from seed to seed.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Frozen copy of the generators (bytes equal to the program's, seed for seed)
# ---------------------------------------------------------------------------


def _corpus_words(rng, nwords: int, alphabet=b"etaoinshrdlcumwfgypbvkjxqz"):
    """Vocabulary of English-like words: letters by frequency, geometric
    lengths, Zipf-ranked usage (word list index 0 = most common)."""
    letters = np.frombuffer(alphabet, dtype=np.uint8)
    p = np.array([12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8,
                  2.8, 2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.2, 0.2,
                  0.1, 0.1])
    p = p / p.sum()
    lens = rng.geometric(0.22, nwords).clip(1, 14)
    return [rng.choice(letters, size=int(ln), p=p).tobytes() for ln in lens]


def _gen_english_text(n: int, seed: int) -> bytes:
    """Book-like English prose: Zipf word usage, sentences, paragraphs."""
    rng = np.random.default_rng(seed)
    vocab = _corpus_words(rng, 4000)
    ranks = np.arange(1, len(vocab) + 1, dtype=np.float64)
    pw = (1.0 / ranks**1.05)
    pw /= pw.sum()
    # ``rng.choice(len(vocab), p=pw)`` is this inverse-CDF lookup of one
    # uniform draw; building the CDF once, not at every word, gives the JAX
    # package's bytes with far less work (a 64 MB corpus holds 24 MB of text)
    cdf = pw.cumsum()
    cdf /= cdf[-1]
    out = bytearray()
    sentence_left = int(rng.integers(4, 18))
    para_left = int(rng.integers(3, 9))
    cap = True
    while len(out) < n:
        w = vocab[int(cdf.searchsorted(rng.random(), side="right"))]
        if cap:
            w = w[:1].upper() + w[1:]
            cap = False
        out += w
        sentence_left -= 1
        if sentence_left <= 0:
            out += b"." if rng.random() < 0.8 else (b"," if rng.random() < 0.5 else b"!")
            sentence_left = int(rng.integers(4, 18))
            para_left -= 1
            cap = True
            if para_left <= 0:
                out += b"\n\n"
                para_left = int(rng.integers(3, 9))
            else:
                out += b" "
        else:
            out += b" "
    return bytes(out[:n])


_SRC_KEYWORDS = [b"def", b"return", b"if", b"else", b"for", b"while", b"import",
                 b"class", b"self", b"None", b"True", b"False", b"in", b"not",
                 b"and", b"or", b"try", b"except", b"raise", b"with", b"assert"]
_SRC_OPS = [b" = ", b" == ", b" + ", b" - ", b" * ", b"(", b")", b"[", b"]",
            b": ", b", ", b"."]


def _gen_source_code(n: int, seed: int) -> bytes:
    """Source-code-like text: indentation, keywords, identifiers, literals."""
    rng = np.random.default_rng(seed)
    idents = _corpus_words(rng, 600)
    idents = [w + (b"_" + idents[i % len(idents)] if rng.random() < 0.3 else b"")
              for i, w in enumerate(idents)]
    out = bytearray()
    indent = 0
    while len(out) < n:
        r = rng.random()
        if r < 0.12:
            indent = max(0, indent + int(rng.integers(-2, 2)))
        line = bytearray(b" " * (4 * indent))
        ntok = int(rng.integers(2, 9))
        for t in range(ntok):
            q = rng.random()
            if q < 0.25:
                line += _SRC_KEYWORDS[int(rng.integers(0, len(_SRC_KEYWORDS)))]
                line += b" "
            elif q < 0.75:
                line += idents[int(rng.integers(0, len(idents)))]
            elif q < 0.9:
                line += str(int(rng.integers(0, 10000))).encode()
            else:
                line += b'"' + idents[int(rng.integers(0, len(idents)))] + b'"'
            if t < ntok - 1:
                line += _SRC_OPS[int(rng.integers(0, len(_SRC_OPS)))]
        if rng.random() < 0.15:
            line += b"  # " + idents[int(rng.integers(0, len(idents)))]
        out += line + b"\n"
    return bytes(out[:n])


_LOG_LEVELS = [b"INFO", b"INFO", b"INFO", b"DEBUG", b"WARN", b"ERROR"]
_LOG_COMPONENTS = [b"scheduler", b"worker-pool", b"io.reader", b"io.writer",
                   b"codec.encode", b"codec.decode", b"net.relay", b"metrics"]
_LOG_MSGS = [b"chunk %d processed in %d ms", b"queue depth %d",
             b"flushed %d bytes to disk", b"heartbeat ok seq=%d",
             b"retrying operation attempt=%d", b"cache hit ratio %d%%"]


def _gen_logs(n: int, seed: int) -> bytes:
    """Server-log-like text: monotone timestamps, heavily skewed
    template/level/component usage — highly repetitive (the reference's
    best-compressing type, 54%)."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    ts = 1_700_000_000_000

    def skewed(k: int) -> int:
        # zipf-ish pick: real logs are dominated by one or two templates
        return min(int(rng.geometric(0.62)) - 1, k - 1)

    while len(out) < n:
        ts += int(rng.integers(1, 40))
        s = ts // 1000
        line = b"2026-08-%02d %02d:%02d:%02d.%03d [%s] %s - " % (
            (s // 86400) % 28 + 1, (s // 3600) % 24, (s // 60) % 60, s % 60,
            ts % 1000,
            _LOG_LEVELS[skewed(len(_LOG_LEVELS))],
            _LOG_COMPONENTS[skewed(len(_LOG_COMPONENTS))],
        )
        msg = _LOG_MSGS[skewed(len(_LOG_MSGS))]
        line += msg.replace(b"%d", str(int(rng.integers(0, 100))).encode(), 1)
        line = line.replace(b"%d", str(int(rng.integers(0, 10))).encode())
        line += b" status=OK worker=default-pool thread=main"
        out += line + b"\n"
    return bytes(out[:n])


def _gen_xml(n: int, seed: int) -> bytes:
    """XML-like records: repeated tag vocabulary, attributes, nesting."""
    rng = np.random.default_rng(seed)
    words = _corpus_words(rng, 300)
    tags = [b"record", b"field", b"name", b"value", b"item", b"entry", b"meta"]
    out = bytearray(b'<?xml version="1.0" encoding="UTF-8"?>\n<dataset>\n')
    rid = 0
    while len(out) < n:
        rid += 1
        out += b'  <record id="%d">\n' % rid
        for _ in range(int(rng.integers(2, 7))):
            t = tags[int(rng.integers(0, len(tags)))]
            w = words[int(rng.integers(0, len(words)))]
            out += b"    <%s type=\"%s\">%s %s</%s>\n" % (
                t, words[int(rng.integers(0, len(words)))], w,
                str(int(rng.integers(0, 10**6))).encode(), t,
            )
        out += b"  </record>\n"
    return bytes(out[:n])


def _gen_mixed_binary(n: int, seed: int) -> bytes:
    """Executable-like mixed binary: machine-code-ish skewed sections,
    zero-padded alignment gaps, embedded ASCII string tables, data tables —
    the reference's hardest compressible type (89%)."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    strings = _corpus_words(rng, 400)
    # skewed "opcode" distribution: a few hot bytes, long tail
    hot = rng.permutation(256)[:24]
    p = np.full(256, 0.3 / 232)
    p[hot] = 0.7 / 24
    while len(out) < n:
        r = rng.random()
        if r < 0.55:  # code section
            m = int(rng.integers(2048, 16384))
            out += rng.choice(256, size=m, p=p).astype(np.uint8).tobytes()
        elif r < 0.70:  # zero padding
            out += b"\x00" * int(rng.integers(64, 4096))
        elif r < 0.85:  # string table
            for _ in range(int(rng.integers(20, 120))):
                out += strings[int(rng.integers(0, len(strings)))] + b"\x00"
        else:  # raw data table (near-uniform)
            out += rng.integers(0, 256, int(rng.integers(1024, 8192)),
                                dtype=np.int64).astype(np.uint8).tobytes()
    return bytes(out[:n])


# ---------------------------------------------------------------------------
# The benchmark's own: 16-bit medical images (Silesia's mr and x-ray)
# ---------------------------------------------------------------------------


def _grey16(n: int, seed: int, blobs: int, lo: float, hi: float, base: float,
            noise: float, disk: float) -> bytes:
    """A 512-pixel-wide grey image of 12-bit samples stored as little-endian
    16-bit words: a base level, ``blobs`` Gaussian structures, sensor noise,
    and (``disk`` > 0) a black background outside an ellipse.  The low byte
    of such samples takes every value often, so the order-0 code stays
    shallow (at most 11 bits here), as it does in real 16-bit scans."""
    rng = np.random.default_rng(seed)
    width = 512
    rows = -(-n // (2 * width))
    y, x = np.mgrid[0:rows, 0:width].astype(np.float64)
    field = np.full((rows, width), float(base))
    for _ in range(blobs):
        cy, cx, r = rng.uniform(0, rows), rng.uniform(0, width), rng.uniform(12, 80)
        field += rng.uniform(lo, hi) * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * r * r))
    field += rng.normal(0, noise, field.shape)
    if disk:
        inside = ((y - rows / 2) / (rows / 2)) ** 2 + ((x - width / 2) / (width * disk)) ** 2 < 1
        field = np.where(inside, field, 0.0)
    return np.clip(np.rint(field), 0, 4095).astype("<u2").tobytes()[:n]


def _gen_mri(n: int, seed: int) -> bytes:
    """An MR slice: soft structures inside the body, black around it."""
    return _grey16(n, seed, blobs=40, lo=100, hi=900, base=200, noise=12, disk=0.36)


def _gen_radiograph(n: int, seed: int) -> bytes:
    """A radiograph: exposure over the whole frame, broad structures, more
    noise."""
    return _grey16(n, seed, blobs=24, lo=300, hi=1800, base=1200, noise=60, disk=0.0)


GENERATORS = {
    "english": _gen_english_text,
    "source": _gen_source_code,
    "logs": _gen_logs,
    "xml": _gen_xml,
    "binary": _gen_mixed_binary,
    "mri": _gen_mri,
    "radiograph": _gen_radiograph,
}


# ---------------------------------------------------------------------------
# Files from pools
# ---------------------------------------------------------------------------


def make_pools(traffic: dict) -> dict:
    """generator name -> uint8 pool of ``traffic["pool_bytes"]`` bytes, each
    from the corpus seed (offset by the generator's place in the table)."""
    seed = int(traffic["corpus_seed"])
    used = sorted({f["generator"] for f in traffic["files"]})
    return {g: np.frombuffer(GENERATORS[g](int(traffic["pool_bytes"]), seed + i), np.uint8)
            for i, g in enumerate(used)}


def chunk_layout(size: int, chunk_bytes: int, subblock: int) -> list:
    """(whole sub-blocks, tail bytes) of each chunk of a ``size``-byte file."""
    out = []
    for off in range(0, size, chunk_bytes):
        n = min(chunk_bytes, size - off)
        out.append((n // subblock, n % subblock))
    return out


def base_pieces(traffic: dict, index: int, chunk_bytes: int, subblock: int) -> list:
    """Per chunk of file ``index``: the pool offsets of its whole sub-blocks
    and of its tail, drawn from the corpus seed and the file's place."""
    f = traffic["files"][index]
    rng = np.random.default_rng([int(traffic["corpus_seed"]), index])
    span = int(traffic["pool_bytes"]) - subblock
    return [(rng.integers(0, span, blocks), int(rng.integers(0, span)), tail)
            for blocks, tail in chunk_layout(int(f["bytes"]), chunk_bytes, subblock)]


def make_file(pool: np.ndarray, pieces: list, subblock: int, rng) -> np.ndarray:
    """One file's bytes: each chunk's sub-blocks in their drawn order, its
    tail last, every byte relabelled by a permutation from ``rng``."""
    windows = np.lib.stride_tricks.sliding_window_view(pool, subblock)
    label = rng.permutation(256).astype(np.uint8)
    parts = []
    for offsets, tail_at, tail in pieces:
        parts.append(windows[offsets].reshape(-1))
        parts.append(pool[tail_at : tail_at + tail])
    return label[np.concatenate(parts)]


def make_corpus(traffic: dict, seed: int, chunk_bytes: int, subblock: int) -> list:
    """The traffic's files, in its table's order, for the run's ``seed``."""
    pools = make_pools(traffic)
    rng = np.random.default_rng(seed)
    return [make_file(pools[f["generator"]], base_pieces(traffic, i, chunk_bytes, subblock),
                      subblock, rng)
            for i, f in enumerate(traffic["files"])]
