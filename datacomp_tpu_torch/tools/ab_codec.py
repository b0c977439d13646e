"""A/B harness of the codec's kernels K1 (histogram), K2 (encode), K3
(decode) and K4 (codebook) on one CUDA device: this checkout against
another.

    python -m datacomp_tpu_torch.tools.ab_codec [size_mb] [--checkout DIR]

DIR is another checkout of this repository, for example the parent commit
unpacked by ``git archive`` into a git-ignored directory of this one
(``_ab/parent``).  Each side is timed in a process of its own with its
checkout first on the path, in turns DIR, this, this, DIR (without DIR:
this, this); a turn builds its side's kernels into that checkout's
``datacomp_tpu_torch/_build/`` and uses only the ops' public calls, which
both sides share, timed by this checkout's :func:`..tools.graph_ms` (the
device time of a call: CUDA graphs replayed between CUDA events, the
wrappers' fills included, cycling through copies of the inputs that
together exceed L2).

At ``size_mb`` MiB (16 by default) a turn times

- K1 on ``random``, ``text``, ``skewed``, ``compressible`` and ``zeros`` (one
  byte repeated) from ``utils.testdata``, each held to ``np.bincount``;
- K2 and K3 on ``text``, ``skewed`` and ``compressible`` with the v2 codebook
  (``fast``, auto cap) and 4032-symbol sub-blocks, the encode held to its
  plain version and the decode to the input;
- K4 on the histograms of the ``text``, ``skewed`` and ``compressible``
  chunks, on Fibonacci counts of depth 32 (one merge pair a round), on 256
  equal counts and on one symbol, held to its plain version (lengths and
  codes); and, as K4's yardstick, the launch floor: ``zero_()`` of a
  256-element tensor, the cheapest one-block launch PyTorch makes, timed the
  same way.  K4 and the floor run many calls a graph
  (``tools.SHORT_PER_INPUT``), so that the host's replays keep ahead of the
  device.

One JSON line a side, kernel and case: ``{"side", "kernel", "case", "ms",
"exact"}`` with the mean of the side's two turns.  It exits 1 when a side is
not exact, and needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

HIST_KINDS = ("random", "text", "skewed", "compressible", "zeros")
CODEC_KINDS = ("text", "skewed", "compressible")
SUBBLOCK = 4032
REPS = 48
_HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _timers():
    """This checkout's ``tools`` module, loaded from its file: the other
    side's package may be the one on the path, and both sides must be timed
    by the same code."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "__init__.py")
    spec = importlib.util.spec_from_file_location("_ab_codec_timers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fibonacci(depth: int) -> np.ndarray:
    """Counts 1, 1, 2, 3, 5, ... on symbols 0..depth: an optimal code that
    deep, whose merge pairs one node at a time."""
    fib = np.zeros(256, np.int64)
    a, b = 1, 1
    for s in range(depth + 1):
        fib[s] = a
        a, b = b, a + b
    return fib


def codebook_cases(chunks: dict) -> dict:
    """name -> int32[256] histogram for K4: the chunks' and three shapes."""
    cases = {kind: np.bincount(chunks[kind], minlength=256) for kind in CODEC_KINDS}
    one = np.zeros(256, np.int64)
    one[65] = 1 << 24
    cases.update({"fibonacci-32": fibonacci(32), "all-equal": np.full(256, 1 << 16),
                  "one": one})
    return {name: h.astype(np.int32) for name, h in cases.items()}


def measure(size_mb: int) -> list:
    """One turn with whichever ``datacomp_tpu_torch`` is first on the path:
    ``[{"kernel", "case", "ms", "exact"}]``."""
    from datacomp_tpu_torch import ops
    from datacomp_tpu_torch.core.huffman import build_codebook
    from datacomp_tpu_torch.utils.testdata import generate_bytes

    timers = _timers()
    n = size_mb << 20
    out_words = (9 * n + 31) // 32 + 2
    nsub = -(-n // SUBBLOCK)
    chunks = {kind: np.frombuffer(generate_bytes(kind, n), np.uint8) for kind in HIST_KINDS}
    rows = []

    def row(kernel, case, ms, exact):
        rows.append({"kernel": kernel, "case": case, "ms": ms, "exact": bool(exact)})

    def short_ms(fn, x):
        per = timers.SHORT_PER_INPUT
        return timers.graph_ms(fn, timers.copies(x), REPS * per, per)

    for kind in HIST_KINDS:
        data = chunks[kind]
        x = torch.from_numpy(data.copy()).cuda()
        exact = np.array_equal(ops.histogram(x, n).cpu().numpy(),
                               np.bincount(data, minlength=256))
        row("histogram", kind, timers.graph_ms(lambda t: ops.histogram(t, n),
                                               timers.copies(x), REPS), exact)
        del x
    for kind in CODEC_KINDS:
        data = chunks[kind]
        lengths, codes = build_codebook(np.bincount(data, minlength=256), mode="fast",
                                        max_len=-1)
        x = torch.from_numpy(data.copy()).cuda()
        lt, ct = ops.codebook_to_torch(lengths, codes, "cuda")
        rw, rtb, rg = ops.encode_reference(x, n, lt, ct, out_words, SUBBLOCK)
        kw, ktb, kg = ops.encode(x, n, lt, ct, out_words, SUBBLOCK)
        tb = int(rtb)
        live = (tb + 31) // 32
        payload = ops.words_to_bytes(rw[:live].cpu().numpy(), tb)
        words = torch.from_numpy(ops.payload_to_words(payload)).cuda()
        gaps = rg[:nsub].contiguous()
        tables = ops.decode_tables_to_torch(*ops.build_decode_tables(lengths), "cuda")
        kd = ops.decode(words, gaps, *tables, SUBBLOCK, n)
        row("encode", kind,
            timers.graph_ms(lambda t: ops.encode(t, n, lt, ct, out_words, SUBBLOCK),
                            timers.copies(x), REPS),
            int(ktb) == tb and torch.equal(kw[:live].cpu(), rw[:live].cpu())
            and torch.equal(kg.cpu(), rg.cpu()))
        row("decode", kind,
            timers.graph_ms(lambda w, g: ops.decode(w, g, *tables, SUBBLOCK, n),
                            timers.copies(words, gaps), REPS),
            np.array_equal(kd.cpu().numpy(), data))
        del x, kw, rw, words
    for name, hist in codebook_cases(chunks).items():
        h = torch.from_numpy(hist).cuda()
        kl, kc = ops.codebook(h)
        rl, rc = ops.codebook_reference(h)
        row("codebook", name, short_ms(ops.codebook, h),
            torch.equal(kl.cpu(), rl.cpu()) and torch.equal(kc.cpu(), rc.cpu()))
    row("launch floor", "zero_",
        short_ms(lambda t: t.zero_(), torch.zeros(256, dtype=torch.int32, device="cuda")), True)
    return rows


def _turn_in(checkout: str, size_mb: int) -> list:
    """One turn in a process of its own, with ``checkout`` first on the path."""
    env = dict(os.environ, PYTHONPATH=checkout)
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", str(size_mb)],
                         cwd=checkout, env=env, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def run(size_mb: int = 16, checkout: str | None = None, emit=print) -> list:
    sides = {"this": _HERE} if checkout is None else {checkout: checkout, "this": _HERE}
    names = list(sides)
    results = {name: [] for name in names}
    for name in names + names[::-1]:
        results[name].append(_turn_in(sides[name], size_mb))
    records = []
    for name in names:
        first, second = results[name]
        for a, b in zip(first, second):
            rec = {"side": name, "kernel": a["kernel"], "case": a["case"],
                   "ms": (a["ms"] + b["ms"]) / 2, "exact": a["exact"] and b["exact"]}
            emit(json.dumps(rec))
            records.append(rec)
    return records


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("ab_codec: needs a CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["--worker"]:
        print(json.dumps(measure(int(argv[1]))))
        return 0
    checkout = None
    if "--checkout" in argv:
        i = argv.index("--checkout")
        checkout = os.path.abspath(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    size_mb = int(argv[0]) if argv else 16
    records = run(size_mb, checkout)
    return 0 if all(r["exact"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
