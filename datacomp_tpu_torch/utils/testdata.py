"""Deterministic test-data generators: the port's copy of
``datacomp_tpu/utils/testdata.py``, byte for byte the same data.

The "random" generator reproduces ``java.util.Random(42).nextBytes`` exactly
(48-bit LCG, little-endian byte extraction from each nextInt), vectorized in
numpy via LCG jump-ahead; the "compressible" generator repeats the fox/dog
pattern of the original Java test fixtures; the corpus generators write a
Silesia-style mixed corpus (``generate_corpus``) for ``bench --corpus``.
"""

from __future__ import annotations

import numpy as np

_LCG_MULT = 0x5DEECE66D
_LCG_ADD = 0xB
_LCG_MASK = (1 << 48) - 1

PATTERN = b"The quick brown fox jumps over the lazy dog. "


class JavaRandom:
    """java.util.Random replica (only what nextBytes needs), vectorized."""

    def __init__(self, seed: int):
        self._state = (seed ^ _LCG_MULT) & _LCG_MASK

    def next_ints(self, count: int) -> np.ndarray:
        """``count`` consecutive nextInt() draws as int32, via parallel
        jump-ahead: state_k = A^k·s + C·(A^k−1)/(A−1) (mod 2^48)."""
        if count == 0:
            return np.zeros(0, dtype=np.int32)
        # per-step affine coefficients: state after k+1 steps = a[k]*s + c[k],
        # filled by iterative doubling (compose the first `filled` steps onto
        # the already-computed prefix)
        a = np.empty(count, dtype=np.uint64)
        c = np.empty(count, dtype=np.uint64)
        a[0], c[0] = _LCG_MULT, _LCG_ADD
        filled = 1
        while filled < count:
            take = min(filled, count - filled)
            # compose: state_{i+filled} = a_filled * state_i + c_filled
            af = int(a[filled - 1])
            cf = int(c[filled - 1])
            a[filled : filled + take] = (a[:take] * np.uint64(af)) & np.uint64(_LCG_MASK)
            c[filled : filled + take] = (
                c[:take] * np.uint64(af) + np.uint64(cf)
            ) & np.uint64(_LCG_MASK)
            filled += take
        s = np.uint64(self._state)
        states = (a * s + c) & np.uint64(_LCG_MASK)
        self._state = int(states[-1])
        return (states >> np.uint64(16)).astype(np.uint32).view(np.int32)

    def next_bytes(self, n: int) -> bytes:
        """java.util.Random.nextBytes semantics: 4 little-endian bytes per
        nextInt, tail truncated."""
        nints = (n + 3) // 4
        ints = self.next_ints(nints)
        b = ints.astype("<i4").tobytes()
        return b[:n]


def java_random_bytes(n: int, seed: int = 42) -> bytes:
    return JavaRandom(seed).next_bytes(n)


def generate_random_file(size_mb: int, path: str, seed: int = 42) -> None:
    """Reference parity: 1 MB buffers from Random(42).nextBytes
    (``TestDataGenerator.generateRandomFile:26-50``). Note the reference
    reuses a full 1 MB draw even for a short final write — replicated here."""
    size = size_mb * 1024 * 1024
    rnd = JavaRandom(seed)
    buf_size = 1024 * 1024
    with open(path, "wb") as f:
        remaining = size
        while remaining > 0:
            to_write = min(buf_size, remaining)
            buf = rnd.next_bytes(buf_size)
            f.write(buf[:to_write])
            remaining -= to_write


def generate_compressible_file(size_mb: int, path: str) -> None:
    """Reference parity: repeats the fox/dog pattern
    (``TestDataGenerator.generateCompressibleFile:55-73``)."""
    size = size_mb * 1024 * 1024
    reps = size // len(PATTERN) + 1
    data = (PATTERN * reps)[:size]
    with open(path, "wb") as f:
        f.write(data)


def generate_bytes(kind: str, n: int, seed: int = 42) -> bytes:
    """In-memory generator used by tests/benchmarks: kinds 'random',
    'compressible', 'text', 'zeros', 'skewed', and the corpus kinds
    'english', 'source', 'logs', 'xml', 'binary'."""
    if kind == "random":
        return java_random_bytes(n, seed)
    if kind == "compressible":
        reps = n // len(PATTERN) + 1
        return (PATTERN * reps)[:n]
    if kind == "zeros":
        return b"\x00" * n
    if kind == "text":
        rng = np.random.default_rng(seed)
        # English-letter-frequency-ish text
        letters = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz ", dtype=np.uint8)
        p = np.array([12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8,
                      2.8, 2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.2, 0.2,
                      0.1, 0.1, 18.0])
        p = p / p.sum()
        return rng.choice(letters, size=n, p=p).tobytes()
    if kind == "skewed":
        rng = np.random.default_rng(seed)
        vals = rng.geometric(0.05, size=n).clip(1, 256) - 1
        return vals.astype(np.uint8).tobytes()
    if kind in _CORPUS_KINDS:
        return _CORPUS_KINDS[kind](n, seed)
    raise ValueError(f"unknown test-data kind: {kind}")


# ---------------------------------------------------------------------------
# Corpus generators — Silesia-style mixed data types
# ---------------------------------------------------------------------------
# The reference publishes per-type compression ratios (text 78%, source 82%,
# mixed binary 89%, repetitive logs 54%, random 100%+ —
# ``docs/CHAPTER5_IMPLEMENTATION_TESTING.md:2387-2393``) but ships no corpus,
# and the real Silesia corpus is not part of this repository.  These
# deterministic generators produce data with realistic structure and byte
# distributions for each published type so the corpus benchmark
# (``bench --corpus``) can measure ratios against the reference's table.


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


_CORPUS_KINDS = {
    "english": _gen_english_text,
    "source": _gen_source_code,
    "logs": _gen_logs,
    "xml": _gen_xml,
    "binary": _gen_mixed_binary,
}

#: Silesia-style corpus layout: (filename, kind, MB) at scale 1.0 (64 MB).
CORPUS_SPEC = [
    ("dickens.txt", "english", 8),
    ("webster.txt", "english", 16),
    ("samba.c", "source", 8),
    ("server.log", "logs", 8),
    ("records.xml", "xml", 8),
    ("mozilla.bin", "binary", 12),
    ("sao.rnd", "random", 4),
]


def generate_corpus(directory: str, scale: float = 1.0, seed: int = 42) -> list:
    """Write the deterministic mixed-type corpus to ``directory``; returns
    the list of (path, kind) written."""
    import os

    os.makedirs(directory, exist_ok=True)
    written = []
    for i, (name, kind, mb) in enumerate(CORPUS_SPEC):
        n = max(int(mb * scale * 1024 * 1024), 4096)
        path = os.path.join(directory, name)
        with open(path, "wb") as f:
            f.write(generate_bytes(kind, n, seed=seed + i))
        written.append((path, kind))
    return written
