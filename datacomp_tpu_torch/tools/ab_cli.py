"""End-to-end A/B of the CLI on one CUDA device: this checkout against
another, on ``chip_smoke.py`` phases 6 and 7.

    python -m datacomp_tpu_torch.tools.ab_cli [pairs] [corpus_mb] --checkout DIR

DIR is another checkout of this repository, for example the parent commit
unpacked by ``git archive`` into a git-ignored directory of this one
(``_ab/parent``).  bench.py's corpus (``bench.write_corpus``,
128 MB by default) is written once.  Then ``pairs`` pairs of turns run (5
by default), DIR first in even pairs and this checkout first in odd ones.
A turn is a process of its own with its checkout first on the path and
``DATACOMP_DEVICE_BATCH_CHUNKS=1``, as in phases 6 and 7.  Through its
CLI's ``main`` it runs one warm-up compress (the kernels' build and the
first service), then ``compress --format 2 --no-verify`` in 16 MiB chunks
and ``decompress``, in ``fast`` and then ``device`` codebook mode.

Prints one JSON line a turn: the side, the package it ran, and for each
mode the wall MB/s of the compress and the decompress call and the
``.dcz``'s SHA-256.  The last
line is a summary: each side's median of each rate, this side's median
over DIR's, and the pairs this side won.  Exits 1 without a CUDA device,
when a file is not restored, or when the sides' ``.dcz`` files differ.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

_HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODES = ("fast", "device")
RATES = ("compress_mbps", "decompress_mbps")


def _cli(cli, argv: list) -> float:
    """Seconds of one call of the CLI's ``main``; raises on a non-zero exit."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    if rc:
        raise RuntimeError(f"{' '.join(argv[:2])} exited {rc}:\n{buf.getvalue()[-2000:]}")
    return seconds


def _worker(corpus: str, work: str) -> dict:
    """One turn, in the checkout first on the path."""
    from datacomp_tpu_torch import cli

    size = os.path.getsize(corpus)
    args = ["16", "--format", "2", "--no-verify"]
    _cli(cli, ["compress", corpus, os.path.join(work, "warm.dcz"), *args,
               "--codebook-mode", "fast"])
    res = {"package": os.path.dirname(cli.__file__)}
    for mode in MODES:
        dcz, out = os.path.join(work, f"{mode}.dcz"), os.path.join(work, f"{mode}.out")
        c_s = _cli(cli, ["compress", corpus, dcz, *args, "--codebook-mode", mode])
        d_s = _cli(cli, ["decompress", dcz, out, "16"])
        with open(corpus, "rb") as a, open(out, "rb") as b:
            restored = a.read() == b.read()
        with open(dcz, "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
        res[mode] = {"compress_mbps": size / 1e6 / c_s, "decompress_mbps": size / 1e6 / d_s,
                     "dcz_sha256": sha, "restored": restored}
    return res


def _turn(checkout: str, corpus: str) -> dict:
    env = dict(os.environ, PYTHONPATH=checkout, DATACOMP_DEVICE_BATCH_CHUNKS="1")
    with tempfile.TemporaryDirectory() as work:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", corpus, work],
                             cwd=checkout, env=env, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def run(checkout: str, pairs: int = 5, corpus_mb: int = 128, emit=print) -> dict:
    from datacomp_tpu_torch.bench import write_corpus

    turns = {"parent": [], "this": []}
    with tempfile.TemporaryDirectory() as d:
        corpus = os.path.join(d, "corpus.bin")
        write_corpus(corpus, corpus_mb)
        for i in range(pairs):
            order = ("parent", "this") if i % 2 == 0 else ("this", "parent")
            for side in order:
                res = _turn(checkout if side == "parent" else _HERE, corpus)
                turns[side].append(res)
                emit(json.dumps({"pair": i, "side": side, **res}))
    summary = {"pairs": pairs, "checkout": checkout}
    for mode in MODES:
        for rate in RATES:
            a = [t[mode][rate] for t in turns["parent"]]
            b = [t[mode][rate] for t in turns["this"]]
            summary[f"{mode} {rate}"] = {
                "parent_median": statistics.median(a), "this_median": statistics.median(b),
                "ratio": statistics.median(b) / statistics.median(a),
                "this_wins": sum(y > x for x, y in zip(a, b))}
    every = [t[mode] for side in turns.values() for t in side for mode in MODES]
    summary["ok"] = all(r["restored"] for r in every) and all(
        len({t[mode]["dcz_sha256"] for side in turns.values() for t in side}) == 1
        for mode in MODES)
    emit(json.dumps(summary))
    return summary


def main(argv: list) -> int:
    if argv[:1] == ["--worker"]:
        print(json.dumps(_worker(argv[1], argv[2])))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ab_cli: needs a CUDA device", file=sys.stderr)
        return 1
    if "--checkout" not in argv:
        print("ab_cli: --checkout DIR is required", file=sys.stderr)
        return 1
    i = argv.index("--checkout")
    checkout = os.path.abspath(argv[i + 1])
    argv = argv[:i] + argv[i + 2:]
    return 0 if run(checkout, *(int(a) for a in argv[:2]))["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
