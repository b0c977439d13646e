"""What handing a chunk's SHA-256 to a helper thread costs on this host,
against the hash itself: the measurement behind
``datacomp_tpu_torch.services.gpu_service.INLINE_HASH_BYTES``.

    PYTHONPATH=. python tools/hash_handoff.py [reps]

Prints one JSON line:

* ``handoff_us``: median and 90th percentile of ``submit(noop).result()`` on
  a warm pool of the codec's kind, one hand-off at a time (``reps``, 2000 by
  default);
* ``sha256``: for each size from 16 KiB to 16 MiB, the median microseconds
  of ``compute_sha256`` on the calling thread and its MB/s;
* ``four_16MiB_ms``: four 16 MiB hashes one after another on this thread,
  and on four pool threads at once (``hashlib`` drops the interpreter lock
  on large inputs, so these overlap);
* ``smallest_size_past_handoff``: the smallest size whose hash takes
  longer than the median hand-off.

It needs no card: the hand-off is the host's.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from datacomp_tpu_torch.utils.checksum import compute_sha256

SIZES = [16 << 10, 32 << 10, 64 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20]


def _noop() -> None:
    return None


def _quantiles(ns: list) -> dict:
    us = sorted(x / 1e3 for x in ns)
    return {"median": round(statistics.median(us), 2),
            "p90": round(us[int(0.9 * (len(us) - 1))], 2)}


def handoff(pool: ThreadPoolExecutor, reps: int) -> dict:
    """Microseconds from submitting a no-op to having its result."""
    for _ in range(50):
        pool.submit(_noop).result()
    times = []
    for _ in range(reps):
        t = time.perf_counter_ns()
        pool.submit(_noop).result()
        times.append(time.perf_counter_ns() - t)
    return _quantiles(times)


def sha256_rates(data: np.ndarray) -> dict:
    out = {}
    for size in SIZES:
        piece = data[:size]
        reps = max(5, min(200, (64 << 20) // size))
        times = []
        for _ in range(reps):
            t = time.perf_counter_ns()
            compute_sha256(piece)
            times.append(time.perf_counter_ns() - t)
        us = statistics.median(times) / 1e3
        out[str(size)] = {"us": round(us, 2), "MBps": round(size / us, 1)}
    return out


def four_at_once(pool: ThreadPoolExecutor, chunks: list) -> dict:
    t = time.perf_counter()
    for c in chunks:
        compute_sha256(c)
    serial = time.perf_counter() - t
    t = time.perf_counter()
    for f in [pool.submit(compute_sha256, c) for c in chunks]:
        f.result()
    pooled = time.perf_counter() - t
    return {"serial": round(serial * 1e3, 2), "pooled": round(pooled * 1e3, 2)}


def run(reps: int = 2000) -> dict:
    rng = np.random.default_rng(20)
    data = rng.integers(0, 256, 16 << 20, dtype=np.uint8)
    chunks = [rng.integers(0, 256, 16 << 20, dtype=np.uint8) for _ in range(4)]
    with ThreadPoolExecutor(max_workers=4, thread_name_prefix="dcz-sha256") as pool:
        one = handoff(pool, reps)
        rates = sha256_rates(data)
        overlap = [four_at_once(pool, chunks) for _ in range(3)]
    smallest = next((s for s in SIZES if rates[str(s)]["us"] > one["median"]), None)
    return {"handoff_us": one, "sha256": rates,
            "four_16MiB_ms": overlap, "smallest_size_past_handoff": smallest}


def main(argv: list) -> int:
    print(json.dumps(run(*(int(a) for a in argv[:1]))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
