"""Every local GPU from one process against one GPU: bench.py's corpus
through the CLI's ``compress`` / ``decompress`` in this process (no
``torchrun``) at three levels: the service on one card (``one card``);
``--sharded`` on one card (``DATACOMP_DEVICE_DEVICE_INDEX=0``: the
multihost loop with the codec's batched groups, ``one card sharded``); and
``--sharded`` over the local mesh of every visible card (``every card``).

    python -m datacomp_tpu_torch.tools.local_mesh [corpus_mb] [chunk_mb] [mode]

First ``graft_entry.dryrun_multichip(device_count)`` (which also builds the
kernels and touches every card), then the runs in turns: one card, one card
sharded, every card, every card, one card sharded, one card, each a
compress then a decompress, with the counts set to 0 before each.  Every
``.dcz`` must equal the first one-card file byte for byte and every
restored file the corpus.  Prints each run's
output (stages and launch counts) and, last, one JSON line: the card and
power limit, the device count, the dry run's seconds, and each run's wall
MB/s (the CLI call in this process) and the CLI's own MB/s.  Exits 1 when a
check fails or there is no CUDA device.
"""

from __future__ import annotations

import contextlib
import filecmp
import io
import json
import os
import sys
import tempfile
import time

import torch

from ..bench import write_corpus


def _cli(argv: list, device_index: str | None = None) -> tuple:
    """The CLI in this process, with ``DATACOMP_DEVICE_DEVICE_INDEX`` set
    when ``device_index`` is given: (seconds, its output); raises on a
    non-zero exit."""
    from .. import cli

    buf = io.StringIO()
    if device_index is not None:
        os.environ["DATACOMP_DEVICE_DEVICE_INDEX"] = device_index
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        os.environ.pop("DATACOMP_DEVICE_DEVICE_INDEX", None)
    seconds = time.perf_counter() - t0
    if rc:
        raise RuntimeError(f"{' '.join(argv[:2])} exited {rc}:\n{buf.getvalue()[-3000:]}")
    return seconds, buf.getvalue()


def run(corpus_mb: int = 128, chunk_mb: int = 16, mode: str = "device") -> int:
    from .. import ops
    from ..benchmark.kernels import card_line
    from ..graft_entry import dryrun_multichip

    if not torch.cuda.is_available():
        print("local_mesh: no CUDA device", file=sys.stderr)
        return 1
    n = torch.cuda.device_count()
    res = {"card": card_line(), "device_count": n, "corpus_mb": corpus_mb, "chunk_mb": chunk_mb,
           "mode": mode, "runs": []}
    t0 = time.perf_counter()
    dryrun_multichip(n)
    res["dryrun_multichip_s"] = time.perf_counter() - t0
    args = [str(chunk_mb), "--format", "2", "--codebook-mode", mode, "--no-verify", "--stages"]
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "corpus.bin")
        write_corpus(src, corpus_mb)
        size = os.path.getsize(src)
        first = None
        levels = ("one card", "one card sharded", "every card", "every card",
                  "one card sharded", "one card")
        for i, level in enumerate(levels):
            dcz, out = os.path.join(d, f"run{i}.dcz"), os.path.join(d, f"run{i}.out")
            sharded = [] if level == "one card" else ["--sharded"]
            index = "0" if level == "one card sharded" else None
            ops.reset_counters()
            c_s, c_out = _cli(["compress", src, dcz, *args, *sharded], index)
            d_s, d_out = _cli(["decompress", dcz, out, str(chunk_mb), "--stages", *sharded], index)
            launches = {k: c.value for k, (c, _) in ops.COUNTERS.items() if c.value}
            first = first or dcz
            same = filecmp.cmp(dcz, first, shallow=False)
            restored = filecmp.cmp(src, out, shallow=False)
            print(f"--- {level} (run {i}): .dcz equal to run 0's: {same}; restored: {restored}; "
                  f"launches {launches}\n{c_out}\n{d_out}", flush=True)
            res["runs"].append({
                "level": level, "compress_mbps": size / 1e6 / c_s,
                "decompress_mbps": size / 1e6 / d_s,
                "cli_compress_mbps": float(c_out.split("Throughput:")[1].split()[0]),
                "cli_decompress_mbps": float(d_out.split("Throughput:")[1].split()[0]),
                "launches": launches, "dcz_equal": same, "restored": restored})
            os.remove(out)
    res["ok"] = all(r["dcz_equal"] and r["restored"] for r in res["runs"])
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(run(*(int(a) for a in sys.argv[1:3]), *sys.argv[3:4]))
