#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``datacomp_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``datacomp_tpu_torch/csrc`` (nvcc, sm_90a,
   one process a source).
2. K1 histogram on 16 MiB chunks of ``random``, ``text``, ``skewed``,
   ``compressible`` and ``zeros`` (one byte repeated) with ``valid_len = n -
   12345``: kernel == plain PyTorch version == ``np.bincount``, each timed;
   ``valid_len`` 0, 1, 15, 16 and 17 once; the service's 1 KB probe passes.
3. K2 encode and K3 decode on 16 MiB ``text``, ``skewed`` and
   ``compressible`` chunks (the last is 45-byte periodic text, the case where
   K3's lanes could lock into a wrong phase): the kernel equals the plain
   version bit for bit (live words, total bits, gap array) and the decode
   returns the input.  K3 also reports its mean synchronisation rounds a
   sub-block, and K2 the time of its wrapper's zero-fill alone.  Then a
   ``dense`` chunk (random bytes, every 8th sub-block zeros: about 7.6 bits
   a byte, so the codec codes it, with most sub-blocks too dense for K3's
   per-warp buffers), timed for K3's direct route; and a ``text`` chunk with
   ``valid_len = n - 12345``, which leaves a short last sub-block, through
   both kernels.
4. K4 codebook on a few hundred histograms (the corpus's 8 chunks, random
   symbol subsets, heavy ties, 256 equal counts, one, two and no symbols,
   Fibonacci histograms of depth 20, 32 and 40, totals of 2^31 - 1 and
   2^32 - 2): lengths and codes equal the plain version's everywhere.  Its
   device time on the text chunk's histogram and on Fibonacci-32 beside the
   launch floor (``zero_()`` of 256 elements, timed the same way).
5. K1's A/B variants K1s and K1p through their entry point, the harness
   ``datacomp_tpu_torch.tools.ab_histogram``, on 16 MiB ``random`` and
   ``skewed`` input with ``valid_len = n - 12345`` (events and device time);
   then K1s in each of ``ops.STACKED``'s configurations and K1p for each
   ``k`` in 1, 2, 3, 4, 5, 8 and 64 against ``np.bincount`` and the plain
   version on the five kinds of phase 2 and at ``valid_len`` 0, 1, 15, 16
   and 17.  No codec path calls them: their ``launches`` are the harness's,
   and ``codec_path_launches`` (0) those of phases 6-8.
6. The fast path: ``bench.py``'s 128 MB mixed corpus (text, compressible,
   skewed, random) through the port's CLI, ``compress --format 2
   --codebook-mode fast --no-verify`` in 16 MiB chunks, then ``decompress``,
   each with its stage breakdown.  The restored file equals the input, the
   ``.dcz`` equals the one the port's host codec (``CpuCompressionService``)
   writes, byte for byte, K2 and K3 ran once per chunk that is not stored
   raw, K1 ran (the services' probes), and no plain version or host route
   ran.  The host codec's own rates on the same corpus are printed beside.
7. The device-codebook path, v2: the same corpus through ``compress --format
   2 --codebook-mode device``, then ``decompress``.  The input is restored;
   each chunk's lengths equal the plain K4 on its histogram, and exactly the
   chunks whose optimal code needs 8 bits a byte or more are stored raw; K1
   ran once per coded chunk and probe, K4 and K2 once per coded chunk, K3
   once per coded chunk of depth at most 16, and the deeper chunks took the
   counted host decode route; nothing else.
8. The device-codebook path, v1: the ``.dcz`` equals the port's host codec's
   in the same config, K1, K4 and K2 ran once per chunk (and K1 per probe),
   and the round trip restores the input through the host decode route.
   Phases 6-8 pin ``batch_chunks`` to 1 (``DATACOMP_DEVICE_BATCH_CHUNKS``):
   one chunk a launch.
9. The batched kernels: a group of four 16 MiB rows (``text``, ``skewed``,
   ``compressible``, ``zeros``, with ``valid_len`` n, n - 12345, 17 and 0)
   through K1 → K4 and, with the rows' capped host codebooks, K2 → K3, each
   through its batched entry point: row by row equal to the unbatched
   kernel, equal to the batched plain version (K3's on the ``text`` row
   alone: about a second a row), and the decode returns each row's input.
   Each batched launch's device time beside four unbatched launches of the
   same rows, both by graph replay in this call.
10. The batched paths: phases 6-8's three configurations again at
    ``batch_chunks`` auto (4 on a CUDA device): each ``.dcz`` equals its
    batch-1 leg's byte for byte, the round trip restores the input, each
    batched kernel ran once for each group of four chunks with at least two
    device members (a group with one ran the unbatched kernel), the counts
    derived from the container's raw-stored chunks and host routes, and no
    plain version ran.  Wall MB/s and ``--stages`` for both batch sizes.

Kernel, plain and library times are taken with CUDA events after a warm-up,
cycling through copies of the inputs that together exceed the L2 cache, so
that each call reads its input cold: back-to-back calls, so a call whose
wrapper's host work outlasts its device work is timed by the host work.
Every kernel also gets ``device_ms``, the device time alone: the same
calls captured into a CUDA graph and replayed (``tools.graph_ms``; K4 and its
launch floor 40 calls a graph on each input copy), and K2 the time of its
wrapper's zero-fill alone, also replayed.  The launch counts of the kernels line
come from the run of each kernel's path (phases 5-7; the batched kernels'
from phase 10), with the counts set to 0 just before it and read just after;
the comparison launches are not in them.  ``bound_ms`` is the larger of the bytes each kernel must move over
3.35 TB/s and its operations over 67 T/s (the H100's non-tensor rate); K4,
which neither bounds, also carries ``launch_floor_ms``.  A batched kernel's
bytes and operations are those of this run's rows, summed.

The script imports the port alone, never jax or ``datacomp_tpu``; the CPU
tests hold the port to the JAX package.  All comparisons are exact: the
outputs are integers and bytes.  Any failure exits non-zero.  The script
needs a CUDA device and exits non-zero without one.  The line before the last
is a JSON object of the kernels' launches, errors, times and bounds; the last
is ``{"ok": true, "device": {...}}``.
"""

import filecmp
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CHUNK = 16 << 20  # the default chunk size, and the kernels' main-path shape
SUBBLOCK = 4032  # the default v2 sub-block (symbols)
K3_WARP_WORDS = 1024  # csrc/decode.cu's kWarpWords: a larger sub-block takes the direct route
CORPUS_MB = 128  # bench.py's default corpus
TAIL = 12345  # bytes that valid_len leaves out of the histogram inputs
HIST_KINDS = ("random", "text", "skewed", "compressible", "zeros")  # K1's inputs
BATCH_KINDS = ("text", "skewed", "compressible", "zeros")  # the batched kernels' rows
BATCH_VALID = (CHUNK, CHUNK - TAIL, 17, 0)  # and their valid lengths
AUTO_BATCH = 4  # batch_chunks auto on a CUDA device
VARIANT_K = (1, 2, 3, 4, 5, 8, 64)  # K1p's stripe counts checked (3, 5, 64: uneven stripes)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# the H100's non-tensor float32 rate, taken as the ceiling of the integer
# and compare instructions these kernels are made of
OPS_PER_S = 67e12


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the scalar rate, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    diff = (a.cpu().to(torch.int64) - b.cpu().to(torch.int64)).abs()
    return int(diff.max()) if diff.numel() else 0


def check_histogram(cfg) -> dict:
    """K1 on 16 MiB of each of ``HIST_KINDS`` with ``valid_len = n - TAIL``,
    and on the ``valid_len`` edges; the service's 1 KB probe."""
    from datacomp_tpu_torch.ops import histogram, histogram_reference
    from datacomp_tpu_torch.services import GpuFrequencyService
    from datacomp_tpu_torch.tools import copies, cuda_ms, graph_ms
    from datacomp_tpu_torch.utils.testdata import generate_bytes

    valid = CHUNK - TAIL
    kinds, err = {}, 0
    for kind in HIST_KINDS:
        host = np.frombuffer(generate_bytes(kind, CHUNK), np.uint8)
        x = torch.from_numpy(host.copy()).cuda()
        k = histogram(x, valid)
        r = histogram_reference(x, valid)
        want = np.bincount(host[:valid], minlength=256)
        if not (np.array_equal(k.cpu().numpy(), want) and np.array_equal(r.cpu().numpy(), want)):
            fail(f"K1 histogram differs from np.bincount on {kind}")
        err = max(err, max_abs_err(k, r))
        if kind == "random":
            for edge in (0, 1, 15, 16, 17):
                if not np.array_equal(histogram(x, edge).cpu().numpy(),
                                      np.bincount(host[:edge], minlength=256)):
                    fail(f"K1 histogram differs from np.bincount at valid_len {edge}")
        xs = copies(x)
        kinds[kind] = {"ms": cuda_ms(lambda t: histogram(t, valid), xs, 24),
                       "device_ms": graph_ms(lambda t: histogram(t, valid), xs, 48)}
        if kind == "random":
            plain_ms = cuda_ms(lambda t: histogram_reference(t, valid), xs, 6)
            library_ms = cuda_ms(lambda t: torch.bincount(t[:valid], minlength=256), xs, 6)
        del x, xs
    # the services' own K1 shape: the 1 KB availability probe
    probe = torch.from_numpy((np.arange(1024) % 251).astype(np.uint8)).cuda()
    if not torch.equal(histogram(probe, 1024), histogram_reference(probe, 1024)):
        fail("K1 histogram differs from the plain version on the 1 KB probe")
    if not GpuFrequencyService(cfg, "cuda").is_available():
        fail("the 1 KB histogram probe failed")
    res = {"max_abs_err": err, **kinds["random"], "plain_ms": plain_ms,
           **bound(valid + 256 * 4, valid), "library_ms": library_ms, "kinds": kinds}
    print("K1 histogram 16 MiB, ms (device time alone): "
          + ", ".join(f"{kind} {t['ms']} ({t['device_ms']})" for kind, t in kinds.items())
          + f"; on random plain {plain_ms} ms, torch.bincount {library_ms} ms, bound "
          f"{res['bound_ms']} ms; equal to np.bincount on every kind and at valid_len "
          f"0, 1, 15, 16, 17; probe ok", flush=True)
    return res


def run_codec(kind: str, data: np.ndarray, valid: int) -> dict:
    """K2 then K3 on one chunk (``valid`` of its bytes), each held to its
    plain version bit for bit and the decode to the input."""
    from datacomp_tpu_torch.core import huffman
    from datacomp_tpu_torch.ops import (
        build_decode_tables, codebook_to_torch, decode, decode_reference,
        decode_tables_to_torch, encode, encode_reference, payload_to_words,
        words_to_bytes,
    )

    hist = np.bincount(data[:valid], minlength=256).astype(np.int64)
    lengths, codes = huffman.build_codebook(hist, mode="fast", max_len=-1)  # v2 auto cap
    opt_bits = int(hist @ lengths.astype(np.int64))
    out_words = (9 * CHUNK + 31) // 32 + 2
    x = torch.from_numpy(data.copy()).cuda()
    lt, ct = codebook_to_torch(lengths, codes, "cuda")

    kw, ktb, kg = encode(x, valid, lt, ct, out_words, SUBBLOCK)
    rw, rtb, rg = encode_reference(x, valid, lt, ct, out_words, SUBBLOCK)
    tb = int(ktb)
    live = (tb + 31) // 32
    if not tb == int(rtb) == opt_bits:
        fail(f"K2 {kind}: total bits kernel {tb}, plain {int(rtb)}, host {opt_bits}")
    if not torch.equal(kw[:live].cpu(), rw[:live].cpu()) or not torch.equal(kg.cpu(), rg.cpu()):
        fail(f"K2 {kind}: kernel words or gaps differ from the plain version")

    payload = words_to_bytes(kw[:live].cpu().numpy(), tb)
    words = torch.from_numpy(payload_to_words(payload)).cuda()
    nsub = (valid + SUBBLOCK - 1) // SUBBLOCK
    gaps = kg[:nsub].contiguous()
    tables = decode_tables_to_torch(*build_decode_tables(lengths), "cuda")
    stats = torch.zeros(2, dtype=torch.int64, device="cuda")
    kd = decode(words, gaps, *tables, SUBBLOCK, valid, stats)
    rd = decode_reference(words, gaps, *tables, SUBBLOCK, valid)
    if not (np.array_equal(kd.cpu().numpy(), data[:valid])
            and np.array_equal(rd.cpu().numpy(), data[:valid])):
        fail(f"K3 {kind}: decode does not return the input")
    subs, rounds = stats.tolist()
    if subs != nsub:
        fail(f"K3 {kind}: {subs} sub-blocks counted, {nsub} expected")
    g = np.append(gaps.cpu().numpy().astype(np.int64), 32 * words.numel())
    direct = int((((g[1:] >> 5) + 3 - (g[:-1] >> 5)) > K3_WARP_WORDS).sum())
    return {"x": x, "lt": lt, "ct": ct, "out_words": out_words, "live": live, "nsub": nsub,
            "words": words, "gaps": gaps, "tables": tables, "depth": int(lengths.max()),
            "bits_per_byte": tb / valid, "sync_rounds": rounds / nsub, "direct": direct,
            "enc_err": max(max_abs_err(kw, rw), max_abs_err(kg, rg)),
            "dec_err": max_abs_err(kd, rd)}


def dense_chunk() -> np.ndarray:
    """Random bytes with every 8th sub-block zeros: under 8 bits a byte, so
    the codec codes it rather than store it raw, while the random sub-blocks
    take more than ``K3_WARP_WORDS`` words each."""
    data = np.random.default_rng(3).integers(0, 256, CHUNK, dtype=np.uint8)
    for i in range(0, -(-CHUNK // SUBBLOCK), 8):
        data[i * SUBBLOCK : (i + 1) * SUBBLOCK] = 0
    return data


def check_codec(kind: str) -> dict:
    from datacomp_tpu_torch.ops import (
        _build, decode, decode_reference, encode, encode_reference,
    )
    from datacomp_tpu_torch.tools import copies, cuda_ms, graph_ms
    from datacomp_tpu_torch.utils.testdata import generate_bytes

    data = (dense_chunk() if kind == "dense"
            else np.frombuffer(generate_bytes(kind, CHUNK), np.uint8))
    c = run_codec(kind, data, CHUNK)
    if kind == "dense" and not (c["bits_per_byte"] < 8 and c["direct"] > c["nsub"] // 2):
        fail(f"K3 dense: {c['bits_per_byte']} bits a byte, {c['direct']} of {c['nsub']} "
             f"sub-blocks on the direct route")
    lt, ct, out_words, tables, nsub = c["lt"], c["ct"], c["out_words"], c["tables"], c["nsub"]
    xs, ws = copies(c["x"]), copies(c["words"], c["gaps"])
    table_bytes = sum(t.numel() * t.element_size() for t in tables)
    # the wrapper's one zero-fill (tile ticket, total, tile statuses, words)
    tiles = -(-CHUNK // _build.library().dcz_encode_tile_symbols())
    zeroed = 2 * (2 + tiles) + out_words
    res = {
        "depth": c["depth"],
        "bits_per_byte": c["bits_per_byte"],
        "encode": {
            "max_abs_err": c["enc_err"],
            "ms": cuda_ms(lambda t: encode(t, CHUNK, lt, ct, out_words, SUBBLOCK), xs, 24),
            "device_ms": graph_ms(
                lambda t: encode(t, CHUNK, lt, ct, out_words, SUBBLOCK), xs, 48),
            "plain_ms": cuda_ms(
                lambda t: encode_reference(t, CHUNK, lt, ct, out_words, SUBBLOCK), xs, 3),
            # the chunk and tables in; the live words and the gap array out
            **bound(CHUNK + 256 * 8 + 4 * c["live"] + 4 * nsub, CHUNK),
            "library_ms": None,
            "zero_fill_ms": graph_ms(
                lambda: torch.zeros(zeroed, dtype=torch.int32, device="cuda"), [()], 48),
        },
        "decode": {
            "max_abs_err": c["dec_err"],
            "ms": cuda_ms(lambda w, g: decode(w, g, *tables, SUBBLOCK, CHUNK), ws, 24),
            "device_ms": graph_ms(lambda w, g: decode(w, g, *tables, SUBBLOCK, CHUNK), ws, 48),
            "plain_ms": cuda_ms(
                lambda w, g: decode_reference(w, g, *tables, SUBBLOCK, CHUNK), ws, 1),
            # the stream, gap array and tables in; the chunk out
            **bound(4 * c["words"].numel() + 4 * nsub + table_bytes + CHUNK, CHUNK),
            "library_ms": None,
        },
        "sync_rounds": c["sync_rounds"],
        "direct_subblocks": c["direct"],
    }
    print(f"K2/K3 16 MiB {kind} (depth {res['depth']}, {res['bits_per_byte']} "
          f"bits/byte): encode kernel {res['encode']['ms']} ms (device time alone "
          f"{res['encode']['device_ms']} ms, of it the zero-fill "
          f"{res['encode']['zero_fill_ms']} ms), plain {res['encode']['plain_ms']} ms, "
          f"bound {res['encode']['bound_ms']} ms; decode kernel {res['decode']['ms']} ms "
          f"(device time alone {res['decode']['device_ms']} ms), plain "
          f"{res['decode']['plain_ms']} ms, bound {res['decode']['bound_ms']} ms, "
          f"{res['sync_rounds']} sync rounds a sub-block, {c['direct']} of {nsub} "
          f"sub-blocks on the direct route; bit-exact, round trip ok",
          flush=True)
    return res


def check_short_tail() -> None:
    """A text chunk whose valid length leaves a short last sub-block."""
    from datacomp_tpu_torch.utils.testdata import generate_bytes

    valid = CHUNK - TAIL
    c = run_codec("text, short tail", np.frombuffer(generate_bytes("text", CHUNK), np.uint8),
                  valid)
    print(f"K2/K3 16 MiB text, valid_len = n - {TAIL} (last sub-block "
          f"{valid - (c['nsub'] - 1) * SUBBLOCK} symbols): bit-exact, round trip ok, "
          f"{c['sync_rounds']} sync rounds a sub-block", flush=True)


def codebook_histograms(corpus: np.ndarray) -> list:
    """(name, int32[256]) histograms for K4: the corpus's chunks, and others
    made from a numpy seed."""
    from datacomp_tpu_torch.tools.ab_codec import fibonacci

    rng = np.random.default_rng(2)
    cases = [(f"chunk-{i // CHUNK}", np.bincount(corpus[i : i + CHUNK], minlength=256))
             for i in range(0, corpus.size, CHUNK)]
    for i in range(200):  # random symbol subsets, counts up to 2^26
        k = int(rng.integers(1, 257))
        top = max(1, min(1 << int(rng.integers(0, 27)), ((1 << 30) - 1) // k))
        hist = np.zeros(256, np.int64)
        hist[rng.choice(256, k, replace=False)] = rng.integers(1, top + 1, k)
        cases.append((f"subset-{i}", hist))
    for i in range(60):  # heavy ties: all equal, many equal pairs, few values
        k = int(rng.integers(2, 257))
        hist = np.zeros(256, np.int64)
        syms = rng.choice(256, k, replace=False)
        if i % 3 == 0:
            hist[syms] = int(rng.integers(1, 1 << 20))
        elif i % 3 == 1:
            hist[syms] = np.repeat(rng.integers(1, 1000, (k + 1) // 2), 2)[:k]
        else:
            hist[syms] = rng.choice(rng.integers(1, 50, 3), k)
        cases.append((f"ties-{i}", hist))
    one, two = np.zeros(256, np.int64), np.zeros(256, np.int64)
    one[200] = 1 << 24
    two[[7, 8]] = [5, 1 << 20]
    cases += [("one", one), ("two", two), ("empty", np.zeros(256, np.int64))]
    for depth in (20, 32, 40):
        cases.append((f"fibonacci-{depth}", fibonacci(depth)))
    cases.append(("all-equal", np.full(256, 1 << 16, np.int64)))
    # totals of a chunk of 2^31 - 1 bytes, and up to 2^32 - 2, where the
    # kernel's 32-bit sums are still exact
    top = (1 << 31) - 1
    cases.append(("total-2^31-1", np.full(256, top // 256, np.int64)))
    fib = fibonacci(40)
    cases.append(("total-2^31-1-fibonacci-40", fib * (top // int(fib.sum()))))
    near = np.zeros(256, np.int64)
    near[[0, 1, 2]] = [top, top - 2, 2]
    cases.append(("total-2^32-2", near))
    return [(name, h.astype(np.int32)) for name, h in cases]



def check_codebook(corpus: np.ndarray) -> dict:
    from datacomp_tpu_torch.ops import codebook, codebook_reference
    from datacomp_tpu_torch.tools import SHORT_PER_INPUT, copies, cuda_ms, graph_ms
    from datacomp_tpu_torch.tools.ab_codec import fibonacci

    cases = codebook_histograms(corpus)
    err = 0
    depths = {}
    for name, hist in cases:
        h = torch.from_numpy(hist).cuda()
        kl, kc = codebook(h)
        rl, rc = codebook_reference(h)
        if not torch.equal(kl.cpu(), rl.cpu()):
            fail(f"K4 {name}: kernel lengths differ from the plain version")
        if not torch.equal(kc.cpu(), rc.cpu()):
            fail(f"K4 {name}: kernel codes differ from the plain version")
        err = max(err, max_abs_err(kl, rl), max_abs_err(kc, rc))
        if name.startswith(("fibonacci", "chunk")):
            depths[name] = int(rl.max())
    if [depths[f"fibonacci-{d}"] for d in (20, 32, 40)] != [20, 32, 40]:
        fail(f"K4: Fibonacci depths {depths}")
    text = torch.from_numpy(cases[0][1]).cuda()  # the corpus's first chunk: text
    fib = torch.from_numpy(fibonacci(32).astype(np.int32)).cuda()
    zeros = torch.zeros(256, dtype=torch.int32, device="cuda")
    hs = copies(text)

    def short_ms(fn, x):
        return graph_ms(fn, copies(x), 48 * SHORT_PER_INPUT, SHORT_PER_INPUT)

    res = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda t: codebook(t), hs, 200),
        "device_ms": short_ms(codebook, text),
        "device_ms_fibonacci_32": short_ms(codebook, fib),
        # the cheapest one-block launch PyTorch makes on 256 elements, timed
        # the same way: K4's yardstick, which bytes or operations are not
        "launch_floor_ms": short_ms(lambda t: t.zero_(), zeros),
        "plain_ms": cuda_ms(lambda t: codebook_reference(t), hs, 20),
        # 1 KB in, 2 KB out; the sort's compares: 15 network stages and 48
        # search steps a symbol
        **bound(256 * 4 * 3, 256 * (15 + 48)),
        "library_ms": None,
    }
    print(f"K4 codebook: {len(cases)} histograms, lengths and codes equal everywhere; "
          f"depths {depths}; text chunk kernel {res['ms']} ms (device time alone "
          f"{res['device_ms']} ms; Fibonacci-32 {res['device_ms_fibonacci_32']} ms; launch "
          f"floor {res['launch_floor_ms']} ms), plain {res['plain_ms']} ms", flush=True)
    return res


def check_variants() -> dict:
    """K1s and K1p through their entry point, the A/B harness, with the
    counts set to 0 before it; then every configuration (and ``k`` in
    ``VARIANT_K``) on each of ``HIST_KINDS`` and at the ``valid_len`` edges,
    against np.bincount and the plain version."""
    from datacomp_tpu_torch.ops import (
        COUNTERS, STACKED, histogram_partial, histogram_reference, histogram_stacked,
        reset_counters,
    )
    from datacomp_tpu_torch.tools import ab_histogram
    from datacomp_tpu_torch.utils.testdata import generate_bytes

    reset_counters()
    records = ab_histogram.run(16, kinds=("random", "skewed"),
                               emit=lambda line: print(f"ab_histogram: {line}", flush=True))
    launches = {name: COUNTERS[name][0].value
                for name in ("histogram_stacked", "histogram_partial")}
    if not all(r["exact"] for r in records):
        fail(f"a histogram variant differs from np.bincount: {records}")
    err = {"histogram_stacked": 0, "histogram_partial": 0}
    for kind in HIST_KINDS:
        host = np.frombuffer(generate_bytes(kind, CHUNK), np.uint8)
        x = torch.from_numpy(host.copy()).cuda()
        for valid in (CHUNK - TAIL, *((0, 1, 15, 16, 17) if kind == "random" else ())):
            want = np.bincount(host[:valid], minlength=256)
            plain = histogram_reference(x, valid)
            if not np.array_equal(plain.cpu().numpy(), want):
                fail(f"the plain histogram differs from np.bincount on {kind}")
            runs = [("histogram_stacked", f"groups {g}, {b}-bit",
                     histogram_stacked(x, valid, g, b)) for g, b in STACKED.values()]
            runs += [("histogram_partial", f"k = {k}", histogram_partial(x, valid, k))
                     for k in VARIANT_K]
            for name, config, got in runs:
                if not torch.equal(got.cpu(), plain.cpu()):
                    fail(f"{name} ({config}) differs from the plain version on {kind} at "
                         f"valid_len {valid}")
                err[name] = max(err[name], max_abs_err(got, plain))
        del x
    ms = {(r["variant"], r["kind"]): r for r in records}
    print("K1 variants, 16 MiB, ms cold by events (device time alone); equal to np.bincount "
          f"and the plain version on {', '.join(HIST_KINDS)} and at valid_len 0, 1, 15, 16, "
          f"17, with k in {VARIANT_K}:", flush=True)
    for kind in ("random", "skewed"):
        print(f"  {kind}: " + ", ".join(f"{name} {r['ms']} ({r['device_ms']})"
                                        for (name, k), r in ms.items() if k == kind), flush=True)
    return {"launches": launches, "max_abs_err": err, "ms": ms}


def write_corpus(path: str) -> None:
    """bench.py's corpus: a quarter each of text, compressible, skewed, random."""
    from datacomp_tpu_torch.utils.testdata import generate_bytes

    mb = 1 << 20
    per = CORPUS_MB // 4
    with open(path, "wb") as f:
        for kind in ("text", "compressible", "skewed"):
            f.write(generate_bytes(kind, per * mb))
        f.write(generate_bytes("random", (CORPUS_MB - 3 * per) * mb))


def run_cli(label: str, compress_args: list, src: str, dcz: str, out: str,
            batch: int = 1) -> dict:
    """compress then decompress through the CLI at ``batch_chunks`` ``batch``
    (0: auto), with every count set to 0 just before and read just after."""
    from datacomp_tpu_torch import cli
    from datacomp_tpu_torch.ops import COUNTERS, reset_counters
    from datacomp_tpu_torch.services import gpu_service

    os.environ["DATACOMP_DEVICE_BATCH_CHUNKS"] = str(batch)
    reset_counters()
    gpu_service.host_encode_routes.reset()
    gpu_service.host_decode_routes.reset()
    t0 = time.perf_counter()
    rc_c = cli.main(["compress", src, dcz, "16", *compress_args, "--no-verify", "--stages"])
    t1 = time.perf_counter()
    rc_d = cli.main(["decompress", dcz, out, "16", "--stages"])
    t2 = time.perf_counter()
    del os.environ["DATACOMP_DEVICE_BATCH_CHUNKS"]
    res = {
        "launches": {name: k.value for name, (k, _) in COUNTERS.items()},
        "plain": {name: r.value for name, (_, r) in COUNTERS.items()},
        "encode_routes": gpu_service.host_encode_routes.value,
        "decode_routes": gpu_service.host_decode_routes.value,
        "probes": 2,  # one availability probe for each CLI command's service
    }
    print(flush=True)
    if rc_c or rc_d:
        fail(f"{label}: CLI exit codes: compress {rc_c}, decompress {rc_d}")
    if not filecmp.cmp(src, out, shallow=False):
        fail(f"{label}: decompress did not restore the input")
    size = os.path.getsize(src)
    res.update(compress_mbps=size / 1e6 / (t1 - t0), decompress_mbps=size / 1e6 / (t2 - t1),
               ratio=os.path.getsize(dcz) / size)
    if any(res["plain"].values()) or res["encode_routes"]:
        fail(f"{label}: a plain version or a host encode route ran: {res}")
    print(f"{label}: {size} bytes, compress {res['compress_mbps']} MB/s, decompress "
          f"{res['decompress_mbps']} MB/s, ratio {res['ratio']}; launches {res['launches']}; "
          f"host decode routes {res['decode_routes']}; round trip ok", flush=True)
    return res


def host_codec(cfg_over: dict, src: str, dcz: str, out: str) -> tuple:
    """The port's host codec on the same corpus and config: (compress MB/s,
    decompress MB/s), service start included as in the CLI's times."""
    from datacomp_tpu_torch.config import load_config
    from datacomp_tpu_torch.services import CpuCompressionService

    size = os.path.getsize(src)
    t0 = time.perf_counter()
    with CpuCompressionService(load_config(compression={"chunk_size_mb": 16, **cfg_over})) as svc:
        svc.compress(src, dcz)
        t1 = time.perf_counter()
        svc.decompress(dcz, out)
        t2 = time.perf_counter()
    if not filecmp.cmp(src, out, shallow=False):
        fail("the host codec did not restore the input")
    return size / 1e6 / (t1 - t0), size / 1e6 / (t2 - t1)


def run_fast_path(d: str, src: str) -> dict:
    from datacomp_tpu_torch.core import read_container
    from datacomp_tpu_torch.ops import max_code_len

    dcz, out, ref = (os.path.join(d, f) for f in ("fast.dcz", "fast.out", "fast-host.dcz"))
    res = run_cli("fast path (v2, host codebook)",
                  ["--format", "2", "--codebook-mode", "fast"], src, dcz, out)
    host = host_codec({"format_version": 2, "codebook_mode": "fast"}, src, ref,
                      os.path.join(d, "fast-host.out"))
    if not filecmp.cmp(dcz, ref, shallow=False):
        fail("fast path: the port's .dcz differs from the host codec's")
    header, _ = read_container(dcz)
    depths = [max_code_len(c.code_lengths) for c in header.chunks]
    live = sum(1 for dep in depths if dep > 0)
    launches = res["launches"]
    print(f"fast path: codebook depths {depths} (0 = stored raw); .dcz byte-identical "
          f"to the host codec's, which ran at {host[0]} MB/s compress, {host[1]} MB/s "
          f"decompress", flush=True)
    if live == 0 or launches["encode"] != live or launches["decode"] != live:
        fail(f"fast path: K2/K3 launches {launches} != {live} chunks not stored raw")
    if launches["histogram"] != res["probes"] or res["decode_routes"]:
        fail(f"fast path: K1 launches {launches['histogram']} or host decode routes "
             f"{res['decode_routes']} are not the probes' {res['probes']} and 0")
    res.update(host_compress_mbps=host[0], host_decompress_mbps=host[1])
    return res


def run_device_v2(d: str, src: str) -> dict:
    from datacomp_tpu_torch.core import huffman, read_container
    from datacomp_tpu_torch.ops import TABLE_BITS, codebook_reference, max_code_len

    dcz, out = os.path.join(d, "dev2.dcz"), os.path.join(d, "dev2.out")
    res = run_cli("device codebook, v2", ["--format", "2", "--codebook-mode", "device"],
                  src, dcz, out)
    header, _ = read_container(dcz)
    data = np.fromfile(src, np.uint8)
    depths = []
    for meta in header.chunks:
        chunk = data[meta.original_offset : meta.original_offset + meta.original_size]
        hist = np.bincount(chunk, minlength=256)
        opt_bits = int(hist @ huffman.build_code_lengths(hist, mode="fast").astype(np.int64))
        raw = not meta.code_lengths.any()
        if raw != (opt_bits >= 8 * chunk.size):
            fail(f"device v2: chunk {meta.index} raw-stored {raw}, optimal bits {opt_bits}")
        if not raw:
            want, _ = codebook_reference(torch.from_numpy(hist.astype(np.int32)))
            if not np.array_equal(meta.code_lengths, want.numpy()):
                fail(f"device v2: chunk {meta.index} lengths differ from K4's plain version")
        depths.append(max_code_len(meta.code_lengths))
    coded = sum(1 for dep in depths if dep > 0)
    shallow = sum(1 for dep in depths if 0 < dep <= TABLE_BITS)
    want = {"histogram": coded + res["probes"], "codebook": coded, "encode": coded,
            "decode": shallow}
    got = {name: res["launches"][name] for name in want}
    print(f"device v2: codebook depths {depths} (0 = stored raw); launches {got}, derived "
          f"from the container {want}; host decode routes {res['decode_routes']} for "
          f"{coded - shallow} chunks deeper than {TABLE_BITS} bits", flush=True)
    if coded == 0 or got != want or res["decode_routes"] != coded - shallow:
        fail("device v2: launch counts or routes differ from those the container implies")
    return res


def run_device_v1(d: str, src: str) -> dict:
    from datacomp_tpu_torch.core import read_container

    dcz, out, ref = (os.path.join(d, f) for f in ("dev1.dcz", "dev1.out", "dev1-host.dcz"))
    res = run_cli("device codebook, v1", ["--format", "1", "--codebook-mode", "device"],
                  src, dcz, out)
    host = host_codec({"format_version": 1, "codebook_mode": "device"}, src, ref,
                      os.path.join(d, "dev1-host.out"))
    if not filecmp.cmp(dcz, ref, shallow=False):
        fail("device v1: the port's .dcz differs from the host codec's")
    chunks = len(read_container(dcz)[0].chunks)
    want = {"histogram": chunks + res["probes"], "codebook": chunks, "encode": chunks,
            "decode": 0}
    got = {name: res["launches"][name] for name in want}
    print(f"device v1: {chunks} chunks; .dcz byte-identical to the host codec's (which "
          f"ran at {host[0]} / {host[1]} MB/s); launches {got}, expected {want}; host "
          f"decode routes {res['decode_routes']}", flush=True)
    if got != want or res["decode_routes"] != chunks:
        fail("device v1: launch counts or routes are not one per chunk")
    return res


def check_batched_kernels() -> dict:
    """Phase 9: K1 → K4 and K2 → K3 through their batched entry points on
    ``BATCH_KINDS`` rows with ``BATCH_VALID`` lengths, against the unbatched
    kernels row by row and the plain batched versions, each batched launch
    timed beside four unbatched launches of the same rows."""
    from datacomp_tpu_torch.core import huffman
    from datacomp_tpu_torch.ops import (
        build_decode_tables, codebook, codebook_batch, codebook_batch_reference, decode,
        decode_batch, decode_batch_reference, encode, encode_batch, encode_batch_reference,
        histogram, histogram_batch, histogram_batch_reference, payload_to_words,
        words_to_bytes,
    )
    from datacomp_tpu_torch.tools import SHORT_PER_INPUT, copies, cuda_ms, graph_ms
    from datacomp_tpu_torch.utils.testdata import generate_bytes

    valid = list(BATCH_VALID)
    rows = len(valid)
    data = np.stack([np.frombuffer(generate_bytes(kind, CHUNK), np.uint8)
                     for kind in BATCH_KINDS])
    x = torch.from_numpy(data).cuda()
    err = {}

    def same(name: str, got: torch.Tensor, want: torch.Tensor, what: str) -> None:
        if not torch.equal(got.cpu(), want.cpu()):
            fail(f"batched {name}: {what}")
        err[name] = max(err.get(name, 0), max_abs_err(got, want))

    hist = histogram_batch(x, valid)
    same("histogram", hist, histogram_batch_reference(x, valid), "differs from the plain version")
    lens, codes = codebook_batch(hist)
    rl, rc = codebook_batch_reference(hist)
    same("codebook", lens, rl, "lengths differ from the plain version")
    same("codebook", codes, rc, "codes differ from the plain version")
    for b, v in enumerate(valid):
        if not np.array_equal(hist[b].cpu().numpy(), np.bincount(data[b, :v], minlength=256)):
            fail(f"batched histogram: row {b} differs from np.bincount")
        same("histogram", hist[b], histogram(x[b], v), f"row {b} differs from the unbatched kernel")
        kl, kc = codebook(hist[b])
        same("codebook", lens[b], kl, f"row {b} lengths differ from the unbatched kernel")
        same("codebook", codes[b], kc, f"row {b} codes differ from the unbatched kernel")

    # K2 and K3 on the rows' host codebooks with the v2 auto cap (the fast path's)
    books = [huffman.build_codebook(np.bincount(data[b, :v], minlength=256), mode="fast",
                                    max_len=-1) for b, v in enumerate(valid)]
    lt = torch.from_numpy(np.stack([bk[0] for bk in books]).astype(np.int32)).cuda()
    ct = torch.from_numpy(np.stack([bk[1] for bk in books]).astype(np.uint32)).cuda()
    out_words = (9 * CHUNK + 31) // 32 + 2
    words, totals, gaps = encode_batch(x, valid, lt, ct, out_words, SUBBLOCK)
    rw, rt, rg = encode_batch_reference(x, valid, lt, ct, out_words, SUBBLOCK)
    same("encode", words, rw, "words differ from the plain version")
    same("encode", totals, rt, "totals differ from the plain version")
    same("encode", gaps, rg, "gaps differ from the plain version")
    streams, gap_rows, live = [], [], 0
    for b, v in enumerate(valid):
        kw, ktb, kg = encode(x[b], v, lt[b], ct[b], out_words, SUBBLOCK)
        same("encode", words[b], kw, f"row {b} words differ from the unbatched kernel")
        same("encode", totals[b], ktb, f"row {b} total differs from the unbatched kernel")
        same("encode", gaps[b], kg, f"row {b} gaps differ from the unbatched kernel")
        tb = int(totals[b])
        live += (tb + 31) // 32
        streams.append(payload_to_words(words_to_bytes(words[b, : (tb + 31) // 32].cpu().numpy(),
                                                       tb)))
        gap_rows.append(gaps[b, : -(-v // SUBBLOCK)].cpu().numpy())
    tables = [build_decode_tables(bk[0]) for bk in books]
    lim, adj, sym = (torch.from_numpy(np.stack([t[k] for t in tables])).cuda() for k in range(3))
    word_off = np.cumsum([0] + [w.size for w in streams]).tolist()
    gap_off = np.cumsum([0] + [g.size for g in gap_rows]).tolist()
    w = torch.from_numpy(np.concatenate(streams)).cuda()
    g = torch.from_numpy(np.concatenate(gap_rows)).cuda()
    stats = torch.zeros(2, dtype=torch.int64, device="cuda")
    out = decode_batch(w, word_off, g, gap_off, lim, adj, sym, SUBBLOCK, valid, stats)
    if not np.array_equal(out.cpu().numpy(),
                          np.concatenate([data[b, :v] for b, v in enumerate(valid)])):
        fail("batched decode does not return the rows' input")
    if int(stats[0]) != gap_off[-1]:
        fail(f"batched decode: {int(stats[0])} sub-blocks counted, {gap_off[-1]} expected")
    cuts = np.cumsum([0] + valid).tolist()
    singles = []
    for b, v in enumerate(valid):
        args = (w[word_off[b] : word_off[b + 1]], g[gap_off[b] : gap_off[b + 1]], lim[b],
                adj[b], sym[b], SUBBLOCK, v)
        singles.append(args)
        same("decode", out[cuts[b] : cuts[b + 1]], decode(*args),
             f"row {b} differs from the unbatched kernel")
    # the plain K3 on the text row alone (about a second a 16 MiB row)
    plain_rows = (w[: word_off[1]], [0, word_off[1]], g[: gap_off[1]], [0, gap_off[1]],
                  lim[:1], adj[:1], sym[:1], SUBBLOCK, valid[:1])
    t0 = time.perf_counter()
    plain = decode_batch_reference(*plain_rows)
    torch.cuda.synchronize()
    decode_plain_ms = (time.perf_counter() - t0) * 1e3
    same("decode", out[: valid[0]], plain, "the text row differs from the plain version")

    # device time: each batched launch beside four unbatched launches, by
    # graph replay; events around back-to-back batched calls; the plain
    # batched versions (K3's on one row) by events
    xs = copies(x)
    hs = copies(hist)
    ws = copies(w, g)
    nbytes = sum(valid)
    table_bytes = sum(t.numel() * t.element_size() for t in (lim, adj, sym))
    res = {
        "histogram": {
            "ms": cuda_ms(lambda t: histogram_batch(t, valid), xs, 24),
            "device_ms": graph_ms(lambda t: histogram_batch(t, valid), xs, 48),
            "unbatched_device_ms": graph_ms(
                lambda t: [histogram(t[b], v) for b, v in enumerate(valid)], xs, 48),
            "plain_ms": cuda_ms(lambda t: histogram_batch_reference(t, valid), xs, 6),
            **bound(nbytes + rows * 256 * 4, nbytes),
        },
        "codebook": {
            "ms": cuda_ms(lambda h: codebook_batch(h), hs, 200),
            "device_ms": graph_ms(codebook_batch, hs, 48 * SHORT_PER_INPUT, SHORT_PER_INPUT),
            "unbatched_device_ms": graph_ms(
                lambda h: [codebook(h[b]) for b in range(rows)], hs, 48 * SHORT_PER_INPUT,
                SHORT_PER_INPUT),
            "plain_ms": cuda_ms(lambda h: codebook_batch_reference(h), hs, 10),
            **bound(rows * 256 * 4 * 3, rows * 256 * (15 + 48)),
        },
        "encode": {
            "ms": cuda_ms(lambda t: encode_batch(t, valid, lt, ct, out_words, SUBBLOCK), xs, 24),
            "device_ms": graph_ms(
                lambda t: encode_batch(t, valid, lt, ct, out_words, SUBBLOCK), xs, 48),
            "unbatched_device_ms": graph_ms(
                lambda t: [encode(t[b], v, lt[b], ct[b], out_words, SUBBLOCK)
                           for b, v in enumerate(valid)], xs, 48),
            "plain_ms": cuda_ms(
                lambda t: encode_batch_reference(t, valid, lt, ct, out_words, SUBBLOCK), xs, 3),
            "zero_fill_ms": graph_ms(lambda: torch.zeros(
                rows * out_words, dtype=torch.int32, device="cuda"), [()], 48),
            # the rows and tables in; the live words and gap arrays out
            **bound(nbytes + rows * 256 * 8 + 4 * live + 4 * gap_off[-1], nbytes),
        },
        "decode": {
            "ms": cuda_ms(lambda w_, g_: decode_batch(w_, word_off, g_, gap_off, lim, adj, sym,
                                                      SUBBLOCK, valid), ws, 24),
            "device_ms": graph_ms(lambda w_, g_: decode_batch(
                w_, word_off, g_, gap_off, lim, adj, sym, SUBBLOCK, valid), ws, 48),
            "unbatched_device_ms": graph_ms(lambda w_, g_: [
                decode(w_[word_off[b] : word_off[b + 1]], g_[gap_off[b] : gap_off[b + 1]],
                       lim[b], adj[b], sym[b], SUBBLOCK, v) for b, v in enumerate(valid)],
                ws, 48),
            "plain_ms": decode_plain_ms,
            "plain_rows": 1,
            # the streams, gap arrays and tables in; the rows out
            **bound(4 * w.numel() + 4 * g.numel() + table_bytes + nbytes, nbytes),
        },
    }
    for name, r in res.items():
        r["max_abs_err"] = err[name]
    print(f"batched kernels, {rows} rows of {CHUNK >> 20} MiB ({', '.join(BATCH_KINDS)}; valid_len "
          f"{valid}): each equal to the unbatched kernel row by row and to the plain "
          f"version; device ms of one batched launch against four unbatched launches: "
          + "; ".join(f"{name} {r['device_ms']} / {r['unbatched_device_ms']}"
                      for name, r in res.items())
          + f"; K3 decoded {int(stats[0])} sub-blocks in {int(stats[1])} sync rounds",
          flush=True)
    return res


def expected_launches(dcz: str, device_codebook: bool, batch: int) -> tuple:
    """The launches and host decode routes a compress → decompress of ``dcz``
    at ``batch_chunks`` ``batch`` implies: each group of ``batch`` chunks
    runs the batched kernels once when two or more of its members reach the
    device, the unbatched kernels once when one does.  Compress: the chunks
    not stored raw; decompress: v2 chunks of depth 1 to 16 (the rest that
    are not raw take the host route)."""
    from datacomp_tpu_torch.core import read_container
    from datacomp_tpu_torch.ops import TABLE_BITS, max_code_len

    header, _ = read_container(dcz)
    v2 = header.version >= 2
    want = {name: 0 for name in ("histogram", "codebook", "encode", "decode", "histogram_batch",
                                 "codebook_batch", "encode_batch", "decode_batch")}
    routes = 0
    for i in range(0, len(header.chunks), batch):
        depths = [max_code_len(c.code_lengths) for c in header.chunks[i : i + batch]]
        coded = sum(1 for dep in depths if dep > 0)
        on_k3 = sum(1 for dep in depths if v2 and 0 < dep <= TABLE_BITS)
        routes += coded - on_k3
        for names, members in (((("histogram", "codebook") if device_codebook else ())
                                + ("encode",), coded), (("decode",), on_k3)):
            for name in names:
                if members > 1:
                    want[f"{name}_batch"] += 1
                elif members == 1:
                    want[name] += 1
    want["histogram"] += 2  # the availability probe of each CLI command's service
    return want, routes


def run_batched(label: str, compress_args: list, d: str, src: str, leg: str,
                unbatched: dict) -> dict:
    """Phase 10: one configuration at ``batch_chunks`` auto, against its
    batch-1 leg ``leg`` (``{leg}.dcz``, whose run was ``unbatched``)."""
    dcz, out = os.path.join(d, f"{leg}-auto.dcz"), os.path.join(d, f"{leg}-auto.out")
    res = run_cli(f"{label}, batch_chunks auto", compress_args, src, dcz, out, batch=0)
    if not filecmp.cmp(dcz, os.path.join(d, f"{leg}.dcz"), shallow=False):
        fail(f"{label}: the .dcz at batch_chunks auto differs from batch_chunks 1")
    want, routes = expected_launches(dcz, "device" in compress_args, AUTO_BATCH)
    got = {name: res["launches"][name] for name in want}
    print(f"{label}, batch_chunks auto ({AUTO_BATCH}): .dcz byte-identical to batch 1; "
          f"launches {got}, derived from the container {want}; host decode routes "
          f"{res['decode_routes']} (expected {routes}); compress "
          f"{res['compress_mbps']} MB/s, decompress {res['decompress_mbps']} MB/s against "
          f"{unbatched['compress_mbps']} / {unbatched['decompress_mbps']} at batch 1",
          flush=True)
    if got != want or res["decode_routes"] != routes:
        fail(f"{label}: batched launch counts or routes differ from those the container implies")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from datacomp_tpu_torch import native
    from datacomp_tpu_torch.config import load_config
    from datacomp_tpu_torch.ops import _build

    print(f"card: {card_line()}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0} s ({os.path.basename(_build.library_path())})",
          flush=True)
    # the shared native host codec (the prepass's histogram) also builds on
    # first use: build it here, so that the paths' times exclude it
    t0 = time.perf_counter()
    built = native.is_available()
    print(f"host codec build: {time.perf_counter() - t0} s "
          f"({'ok' if built else f'numpy fallback: {native.build_error()}'})", flush=True)

    hist = check_histogram(load_config(compression={"chunk_size_mb": 16}))
    codec = {kind: check_codec(kind) for kind in ("text", "skewed", "compressible", "dense")}
    check_short_tail()
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "bench.bin")
        write_corpus(src)
        cbook = check_codebook(np.fromfile(src, np.uint8))
        variants = check_variants()
        fast = run_fast_path(d, src)
        dev2 = run_device_v2(d, src)
        dev1 = run_device_v1(d, src)
        batched = check_batched_kernels()
        fast4 = run_batched("fast path (v2, host codebook)", ["--format", "2", "--codebook-mode",
                                                              "fast"], d, src, "fast", fast)
        dev2_4 = run_batched("device codebook, v2", ["--format", "2", "--codebook-mode",
                                                     "device"], d, src, "dev2", dev2)
        run_batched("device codebook, v1", ["--format", "1", "--codebook-mode",
                                                     "device"], d, src, "dev1", dev1)
    jax_side = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "datacomp_tpu"))
    if jax_side:
        fail(f"jax or the JAX package was imported: {jax_side}")

    source = "datacomp_tpu_torch/csrc/{}.cu"
    valid = CHUNK - TAIL
    ms = variants["ms"]

    def variant(name: str, config: str) -> dict:
        return {"name": name, "route": "cuda", "source": source.format("histogram_variants"),
                # the A/B harness's count: no codec path calls the variants
                "launches": variants["launches"][name], "launches_counted_in": "ab_histogram",
                "codec_path_launches": sum(r["launches"][name] for r in (fast, dev2, dev1)),
                "max_abs_err": variants["max_abs_err"][name], "config": config,
                "ms": ms[config, "random"]["ms"], "device_ms": ms[config, "random"]["device_ms"],
                "plain_ms": hist["plain_ms"], **bound(valid + 256 * 4, valid),
                "library_ms": ms["torch.bincount", "random"]["ms"]}

    kernels = [
        {"name": "histogram", "route": "cuda", "source": source.format("histogram"),
         "replaces": "datacomp_tpu/ops/histogram_pallas.py:114",
         "launches": dev2["launches"]["histogram"], **hist},
        {"name": "encode", "route": "cuda", "source": source.format("encode"),
         "replaces": "datacomp_tpu/ops/encode_merge.py:228",
         "launches": fast["launches"]["encode"], **codec["text"]["encode"]},
        {"name": "decode", "route": "cuda", "source": source.format("decode"),
         "replaces": "datacomp_tpu/ops/decode.py:133",
         "launches": fast["launches"]["decode"], **codec["text"]["decode"],
         "sync_rounds": {kind: r["sync_rounds"] for kind, r in codec.items()},
         "direct_route": {key: codec["dense"][key] for key in ("bits_per_byte",
                                                               "direct_subblocks")}
         | {key: codec["dense"]["decode"][key] for key in ("ms", "device_ms")}},
        {"name": "codebook", "route": "cuda", "source": source.format("codebook"),
         "replaces": "datacomp_tpu/ops/codebook.py:37",
         "launches": dev2["launches"]["codebook"], **cbook},
        {**variant("histogram_stacked", "stacked"), "replaces": "tools/ab_hist_pallas_r3.py:42"},
        {**variant("histogram_partial", "partial-k4"), "replaces": "tools/ab_hist_pallas_r4.py:50"},
    ]
    # the batched entry points, with the launches of phase 10's runs (device
    # v2 for K1 and K4, fast v2 for K2 and K3), beside the rows' unbatched time
    for name, leg, replaces in (
            ("histogram", dev2_4, "datacomp_tpu/ops/histogram_pallas.py:114"),
            ("codebook", dev2_4, "datacomp_tpu/ops/codebook.py:37"),
            ("encode", fast4, "datacomp_tpu/ops/encode_merge.py:459"),
            ("decode", fast4, "datacomp_tpu/services/tpu_service.py:745")):
        kernels.append({"name": f"{name}_batch", "route": "cuda", "source": source.format(name),
                        "replaces": replaces, "launches": leg["launches"][f"{name}_batch"],
                        "rows": len(BATCH_VALID), **batched[name], "library_ms": None})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
