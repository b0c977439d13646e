"""Corpus benchmark: per-file compression ratio vs the reference's table;
the port of ``datacomp_tpu/benchmark/corpus.py``.

The reference publishes per-type ratios (``docs/CHAPTER5_IMPLEMENTATION_
TESTING.md:2387-2393``: text 78%, source 82%, mixed binary 89%, repetitive
logs 54%, random 100%+) but ships no corpus and no corpus runner.  This
module benchmarks any directory of files — by default the deterministic
Silesia-style corpus from ``utils/testdata.py`` (``gen SIZE DIR --corpus``)
— reporting per-file ratio, throughput, the order-0 entropy bound (the floor
for ANY Huffman-class coder), and the comparison against the reference's
published number for that data type.  ``backend="cpu"`` runs the host codec,
``"gpu"`` the GPU service (which raises without a CUDA device unless
``device.platform=cpu`` selects the kernels' plain versions); both write the
same ``.dcz`` bytes in the default java-mode v1.

Honesty note, recorded because the comparison is the point: the reference's
own shipped run logs (``app/logs/datacomp.log``) have order-0 entropy
5.35 bits/byte — an order-0 floor of ~67% — so its published "logs 54%" is
not achievable by its own (or any) pure-Huffman codec on its own data.  The
entropy-bound column makes that visible instead of hiding it.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Optional

import numpy as np

#: Reference's published per-type compression ratios (compressed/original).
REFERENCE_RATIOS = {
    "english": 0.78,   # "text files"
    "source": 0.82,    # "source code"
    "binary": 0.89,    # "mixed binary"
    "logs": 0.54,      # "repetitive logs" (see module docstring)
    "random": 1.01,    # "random 100%+" — expansion expected; 1% allowance
                       # covers per-chunk metadata at any file size
    "xml": None,
    "pattern": None,
}

#: filename → kind map for the generated corpus + the reference's real files
_KIND_BY_NAME = {
    "dickens.txt": "english",
    "webster.txt": "english",
    "samba.c": "source",
    "server.log": "logs",
    "records.xml": "xml",
    "mozilla.bin": "binary",
    "sao.rnd": "random",
    "datacomp.log": "logs",
    "test_input.bin": "random",
    "test_2mb.bin": "pattern",   # reference fixture: constant-byte content
    "test_small.bin": "pattern",
}
_KIND_BY_EXT = {".txt": "english", ".c": "source", ".py": "source",
                ".log": "logs", ".xml": "xml", ".bin": "binary", ".rnd": "random"}


def _infer_kind(name: str) -> Optional[str]:
    if name in _KIND_BY_NAME:
        return _KIND_BY_NAME[name]
    return _KIND_BY_EXT.get(os.path.splitext(name)[1])


def _entropy_bits(path: str, sample_bytes: int = 64 << 20) -> float:
    with open(path, "rb") as f:
        data = f.read(sample_bytes)
    if not data:
        return 0.0
    h = np.bincount(np.frombuffer(data, np.uint8), minlength=256).astype(np.float64)
    p = h / h.sum()
    nz = p[p > 0]
    return max(0.0, float(-(nz * np.log2(nz)).sum()))


def run_corpus_bench(
    directory: str,
    config=None,
    backend: str = "cpu",
    verify_roundtrip: bool = True,
) -> dict:
    """Compress every regular file under ``directory`` (java-mode v1 unless
    the config overrides) and return the per-file + total report dict."""
    from ..config import load_config

    cfg = config or load_config(
        compression={"format_version": 1, "codebook_mode": "java"}
    )
    if backend not in ("cpu", "gpu"):
        raise ValueError(f"corpus backend must be cpu|gpu, got {backend!r}")
    from ..services import CpuCompressionService, create_compression_service

    svc = (create_compression_service(cfg, force_cpu=False) if backend == "gpu"
           else CpuCompressionService(cfg))

    files = sorted(
        f for f in os.listdir(directory)
        if os.path.isfile(os.path.join(directory, f)) and not f.endswith(".dcz")
    )
    rows = []
    tot_in = tot_out = 0
    tot_comp_s = tot_dec_s = 0.0
    try:
        with tempfile.TemporaryDirectory() as td:
            for name in files:
                src = os.path.join(directory, name)
                size = os.path.getsize(src)
                if size == 0:
                    continue
                dcz = os.path.join(td, name + ".dcz")
                t0 = time.perf_counter()
                svc.compress(src, dcz)
                comp_s = time.perf_counter() - t0
                csize = os.path.getsize(dcz)
                dec_s = 0.0
                if verify_roundtrip:
                    out = os.path.join(td, name + ".out")
                    t0 = time.perf_counter()
                    svc.decompress(dcz, out)
                    dec_s = time.perf_counter() - t0
                    import filecmp

                    if not filecmp.cmp(src, out, shallow=False):
                        raise IOError(f"corpus round-trip mismatch on {name}")
                    os.remove(out)
                os.remove(dcz)
                kind = _infer_kind(name)
                ent = _entropy_bits(src)
                ratio = csize / size
                ref = REFERENCE_RATIOS.get(kind) if kind else None
                # a published reference ratio below the data's own order-0
                # entropy bound is unattainable by ANY Huffman-class coder
                # (incl. the reference itself) — flag it instead of "losing"
                ref_feasible = ref is None or ref >= ent / 8
                rows.append({
                    "file": name,
                    "kind": kind,
                    "original_bytes": size,
                    "compressed_bytes": csize,
                    "ratio": round(ratio, 4),
                    "entropy_bound_ratio": round(ent / 8, 4),
                    "reference_ratio": ref,
                    "reference_claim_below_entropy_bound": not ref_feasible,
                    "beats_reference": (ratio <= ref) if (ref and ref_feasible) else None,
                    "compress_mbps": round(size / 1e6 / max(comp_s, 1e-9), 1),
                    "decompress_mbps": (
                        round(size / 1e6 / max(dec_s, 1e-9), 1) if verify_roundtrip else None
                    ),
                })
                tot_in += size
                tot_out += csize
                tot_comp_s += comp_s
                tot_dec_s += dec_s
    finally:
        svc.close()
    return {
        "directory": os.path.abspath(directory),
        "backend": backend,
        "format_version": cfg.compression.format_version,
        "codebook_mode": cfg.compression.codebook_mode,
        "files": rows,
        "totals": {
            "original_bytes": tot_in,
            "compressed_bytes": tot_out,
            "ratio": round(tot_out / max(tot_in, 1), 4),
            "compress_mbps": round(tot_in / 1e6 / max(tot_comp_s, 1e-9), 1),
            "decompress_mbps": round(tot_in / 1e6 / max(tot_dec_s, 1e-9), 1)
            if verify_roundtrip else None,
            "all_typed_files_beat_reference": all(
                r["beats_reference"] for r in rows if r["beats_reference"] is not None
            ),
        },
    }


def format_corpus_results(report: dict, fmt: str = "console") -> str:
    if fmt == "json":
        return json.dumps(report, indent=2)
    if fmt == "csv":
        cols = ["file", "kind", "original_bytes", "compressed_bytes", "ratio",
                "entropy_bound_ratio", "reference_ratio", "compress_mbps",
                "decompress_mbps"]
        lines = [",".join(cols)]
        for r in report["files"]:
            lines.append(",".join("" if r[c] is None else str(r[c]) for c in cols))
        return "\n".join(lines)
    lines = [
        "",
        f"Corpus benchmark — {report['directory']} "
        f"[{report['backend']} backend, v{report['format_version']} "
        f"{report['codebook_mode']} codebooks]",
        "=" * 86,
        f"  {'file':<16} {'kind':<8} {'size':>10} {'ratio':>7} {'entropy':>8} "
        f"{'ref':>6} {'beats':>6} {'MB/s':>8}",
        "-" * 86,
    ]
    for r in report["files"]:
        ref = f"{r['reference_ratio']:.0%}" if r["reference_ratio"] else "—"
        beats = {True: "yes", False: "NO", None: "—"}[r["beats_reference"]]
        if r.get("reference_claim_below_entropy_bound"):
            beats = "n/a*"  # * published claim is below the entropy bound
        lines.append(
            f"  {r['file']:<16} {r['kind'] or '?':<8} {r['original_bytes']:>10,} "
            f"{r['ratio']:>6.1%} {r['entropy_bound_ratio']:>7.1%} {ref:>6} "
            f"{beats:>6} {r['compress_mbps']:>8.1f}"
        )
    t = report["totals"]
    lines += [
        "-" * 86,
        f"  TOTAL {t['original_bytes']:,} -> {t['compressed_bytes']:,} bytes "
        f"(ratio {t['ratio']:.1%}), compress {t['compress_mbps']:.1f} MB/s"
        + (f", decompress {t['decompress_mbps']:.1f} MB/s" if t["decompress_mbps"] else ""),
        "=" * 86,
    ]
    if any(r.get("reference_claim_below_entropy_bound") for r in report["files"]):
        lines.append(
            "  * reference's published ratio is below the data's order-0 entropy "
            "bound — unattainable by any Huffman-class coder on this data"
        )
    return "\n".join(lines)
