"""A/B harness of the byte histogram on one CUDA device: K1 against its
variants K1s (``stacked``, ``stacked8``, ``stacked-i16``: private narrow
counters folded every ``groups`` x 16 bytes a thread) and K1p
(``partial-k1`` .. ``partial-k8``: k stripes of blocks with their own partial
histograms), and ``torch.bincount`` as the library's yardstick.

    python -m datacomp_tpu_torch.tools.ab_histogram [size_mb]

Counterpart of ``tools/ab_hist_pallas_r3.py`` and
``tools/ab_hist_pallas_r4.py``.  r4's ``partial-k8-parallel`` has no row:
its "parallel" dimension semantics has no GPU counterpart, because a GPU's
blocks always run in parallel.  For each input kind (``random``, ``skewed``,
``text`` from ``utils.testdata``) at ``size_mb`` MiB with
``valid_len = n - 12345``, every variant is first checked against
``np.bincount``, then timed with CUDA events, cycling through copies of the
input that together exceed L2, so that each call reads its input cold, and
by graph replay (:func:`..tools.graph_ms`: the device time alone, the
wrapper's host work left out).  ``torch.bincount`` has no device time: on a
CUDA tensor it reads the input's maximum back to the host, which a CUDA
graph cannot capture, so its record keeps its event time alone and says so.
One JSON line a variant and kind: ``{"variant", "kind", "bytes", "ms",
"device_ms", "gbps", "exact"}`` (``gbps`` from ``device_ms`` where there is
one).  It exits 1 when a variant is not exact, and needs a CUDA device.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .. import ops
from ..utils.testdata import generate_bytes
from . import copies, cuda_ms, graph_ms

KINDS = ("random", "skewed", "text")
#: bytes below the end that ``valid_len`` leaves out (the mask is exercised)
TAIL = 12345
REPS = 96
#: the library yardstick, which no CUDA graph can capture
LIBRARY = "torch.bincount"


def variants() -> dict:
    """name -> fn(data, valid_len) -> int32[256] (``torch.bincount`` aside)."""
    out = {"histogram": ops.histogram}
    for name, (groups, bits) in ops.STACKED.items():
        out[name] = lambda x, v, g=groups, b=bits: ops.histogram_stacked(x, v, g, b)
    for k in ops.PARTIAL_K:
        out[f"partial-k{k}"] = lambda x, v, k=k: ops.histogram_partial(x, v, k)
    out[LIBRARY] = lambda x, v: torch.bincount(x[:v], minlength=256)
    return out


def run(size_mb: int = 16, kinds=KINDS, emit=print) -> list:
    """Check and time every variant on each kind; one record a pair."""
    if not torch.cuda.is_available():
        raise RuntimeError("the histogram A/B needs a CUDA device")
    n = size_mb << 20
    valid = n - TAIL
    records = []
    for kind in kinds:
        host = np.frombuffer(generate_bytes(kind, n), np.uint8)
        want = np.bincount(host[:valid], minlength=256)
        x = torch.from_numpy(host.copy()).cuda()
        xs = copies(x)
        for name, fn in variants().items():
            exact = bool(np.array_equal(fn(x, valid).cpu().numpy(), want))

            def call(t, fn=fn):
                return fn(t, valid)

            ms = cuda_ms(call, xs, REPS)
            if name == LIBRARY:
                device_ms, note = None, {"device_ms_note": "not capturable: reads the "
                                                          "input's maximum back to the host"}
            else:
                device_ms, note = graph_ms(call, xs, REPS), {}
            rec = {"variant": name, "kind": kind, "bytes": valid, "ms": ms,
                   "device_ms": device_ms, "gbps": valid / (device_ms or ms) / 1e6,
                   "exact": exact, **note}
            records.append(rec)
            emit(json.dumps(rec))
    return records


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    records = run(int(argv[0]) if argv else 16)
    return 0 if all(r["exact"] for r in records) else 1


if __name__ == "__main__":
    raise SystemExit(main())
