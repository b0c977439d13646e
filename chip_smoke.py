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
   skewed, random; written by ``datacomp_tpu_torch.bench.write_corpus``)
   through the port's CLI, ``compress --format 2 --codebook-mode fast
   --no-verify`` in 16 MiB chunks, then ``decompress``,
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
11. Several ranks (``datacomp_tpu_torch.parallel``).  11a: a process group
    of this process alone on ``cpu:gloo,cuda:nccl`` (``file://`` store), and
    the sharded compress step on four 16 MiB rows of the corpus (``text``
    whole, ``skewed`` at n - 12345, ``compressible``, and a 0-length row),
    through ``tools.sharded_step.check_step`` (which the step's multi-card
    tool also runs): its eight outputs equal batched K1 → K4 → K2 row by row
    and, here, the plain versions, its offsets the host's exclusive cumsum
    of the sizes (the all-gather on NCCL), and the sharded decompress step
    restores every row of depth at most 16; its launches, and its time by
    events beside the batched kernels alone and the all-gather alone (the
    step's difference from the kernels is the all-gather and the cumsum).
    11b: the CLI's ``compress --sharded`` then ``decompress --sharded`` over
    the corpus, fast v2 and device v2, at 1 rank (in this process: a lone
    process is a job of one rank) and at 2 ranks (``torchrun --standalone
    --nproc_per_node 2``, both ranks on ``cuda:0`` through
    ``DATACOMP_DEVICE_DEVICE_INDEX=0``, so no device collective runs; the
    two configurations' jobs at once, as each is nearly all process start): each
    ``.dcz`` equals phase 6/7's, the corpus is restored, and the launches,
    plain calls and host routes that rank 0 prints summed over the ranks are
    those the container implies for each rank's stripe.  Wall MB/s of each
    command (at 2 ranks, process starts included, the other configuration's
    job running beside it) and the CLI's own rate,
    ranks sharing one card.  A rank's non-zero exit fails the script.
12. The surfaces, through the CLI's ``main`` in this process.  12a: ``gen 16
    DIR --corpus`` (the 7-file Silesia-style corpus at a quarter of its
    default size), then ``bench --corpus
    DIR`` on the ``gpu`` and the ``cpu`` backend (java v1, every file
    round-tripped): each file's compressed size equal on both, K2 launched
    on ``gpu`` only.  12b: ``bench --size-mb 16``: a ``CPU`` and a ``GPU
    (<card>)`` row for each operation; then the suite's
    ``benchmark_service`` on the GPU service with ``detailed_profiling``
    over the corpus (fast v2): the ``torch.profiler`` trace is written, and
    its device time split into kernels, copies and fills, with the device's
    idle share, is printed (``profiler: no device events`` when it holds
    none).  12c: ``bench --kernels --kind text``: every row exact, each
    row's device time printed beside phases 2-4's for the same kernel and
    chunk, and the card's primitives.  12d: ``bench --batched``: the batched
    K1 → K4 → K2 and K3 at B = 1, 4 and 8.  12e: phase 6's ``.dcz`` cut after
    chunk 2 with its ``.partial`` sidecar, then ``resume --last-chunk 2`` (v2
    ``fast`` and ``batch_chunks`` 1 from the environment): phase 6's file
    byte for byte, K2 once a resumed chunk not stored raw.  12f:
    ``dashboard --html`` names the card, ``config --init`` then ``config
    --file`` reads the template back, ``stats`` runs.
13. The local level of the mesh: one process driving several devices,
    here ``[cuda:0, cuda:0]`` (two entries on the one card; on a host with
    several cards ``--sharded`` alone takes them all).  ``compress_multihost``
    then ``decompress_multihost`` of the corpus through that mesh, device v2
    (groups of one chunk a device through the sharded compress step) and
    fast v2 (compress through the codec; decompress through the sharded
    decompress step): each ``.dcz`` equals phase 7's or phase 6's, the
    corpus is restored, K1, K4 and K2 launched once for each device in each
    group with a member on the device and K3 once for each chunk of depth 1
    to 16 (the counts derived from the container; fast v2's compress as
    phase 10's groups of four), the deeper chunks took the host route, and
    no plain version ran.  Wall MB/s and the stages of each.  Then
    ``graft_entry.dryrun_multichip(torch.cuda.device_count())`` and
    ``graft_entry.entry()``'s pipeline on the card, equal to its plain
    version and timed by events.  The config's ``fallback_on_error`` is off,
    and nothing here sets it.
14. The headline benchmark (``datacomp_tpu_torch.bench``, the port's root
    ``bench.py``).  In this process, ``bench.run`` on the corpus at full size:
    the ``cpu`` leg (host codec, v2) and the ``gpu`` leg (fast v2, 16 MiB
    chunks, ``batch_chunks`` auto, a warm-up and 2 timed calls each way, the
    link probed before and after), with the counts set to 0 just before and
    read just after: the ``gpu`` leg's ``.dcz`` equals phase 6's and its
    ratio phase 6's, K1 ran once (the service's probe), K2 and K3 as the
    container implies at ``batch_chunks`` auto for each of the 3 compresses
    and decompresses, and no plain version or host route ran.  Then
    ``python -m datacomp_tpu_torch.bench`` once at ``BENCH_SIZE_MB=16``:
    exit 0 and one JSON line with every key of the in-process line.  Both
    lines are printed; the kernels line carries each kernel's
    ``headline_launches``.
15. The CLI's options, through ``cli.main`` in this process.  15a: the
    corpus through ``compress --backend gpu --format 2 --codebook-mode fast
    --max-code-len 12 --no-verify`` at ``batch_chunks`` 1, then
    ``decompress --backend gpu``: the ``.dcz`` equals the host codec's in
    the same config, every coded chunk is at most 12 bits deep, K2 and K3
    ran once a coded chunk and nothing else ran (``--backend gpu`` builds
    the GPU service without the factory's probe), and the corpus is
    restored.  15b: ``compress --sharded`` with no format or codebook flag
    (one rank in this process) writes phase 7's device v2 ``.dcz``.  15c:
    ``compress --backend gpu`` and ``--backend auto`` as two subprocesses
    with ``CUDA_VISIBLE_DEVICES=`` exit non-zero and write no file.

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
the comparison launches are not in them.  Phase 12 reads the counts of its
own paths (the ``gpu`` corpus bench, ``resume``) the same way; it adds no
kernel.  Each entry's ``headline_launches`` are phase 14's, read the same
way (K1 for the probe, the batched K2 and K3).  ``bound_ms`` is the larger of
the bytes each kernel must move over 3.35 TB/s and its operations over 67
T/s (the H100's non-tensor rate;
``datacomp_tpu_torch.benchmark.kernels.bound`` and its work counts); K4,
which neither bounds, also carries ``launch_floor_ms``.  A batched kernel's
bytes and operations are those of this run's rows, summed.

The script imports the port alone, never jax or ``datacomp_tpu``; the CPU
tests hold the port to the JAX package.  All comparisons are exact: the
outputs are integers and bytes.  Any failure exits non-zero.  The script
needs a CUDA device and exits non-zero without one.  The line before the last
is a JSON object of the kernels' launches, errors, times and bounds; the last
is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import filecmp
import io
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
SURFACE_CORPUS_MB = 16  # phase 12a's gen --corpus size (7 files of 1-4 MB)
TAIL = 12345  # bytes that valid_len leaves out of the histogram inputs
HIST_KINDS = ("random", "text", "skewed", "compressible", "zeros")  # K1's inputs
BATCH_KINDS = ("text", "skewed", "compressible", "zeros")  # the batched kernels' rows
BATCH_VALID = (CHUNK, CHUNK - TAIL, 17, 0)  # and their valid lengths
SHARDED_VALID = (CHUNK, CHUNK - TAIL, CHUNK, 0)  # the sharded step's rows' valid lengths
AUTO_BATCH = 4  # batch_chunks auto on a CUDA device
VARIANT_K = (1, 2, 3, 4, 5, 8, 64)  # K1p's stripe counts checked (3, 5, 64: uneven stripes)
HEADLINE_ITERS = 2  # the headline's BENCH_ITERS default
HEADLINE_SUBPROCESS_MB = 16  # the module's own run: its line and exit code


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    diff = (a.cpu().to(torch.int64) - b.cpu().to(torch.int64)).abs()
    return int(diff.max()) if diff.numel() else 0


def check_histogram(cfg) -> dict:
    """K1 on 16 MiB of each of ``HIST_KINDS`` with ``valid_len = n - TAIL``,
    and on the ``valid_len`` edges; the service's 1 KB probe."""
    from datacomp_tpu_torch.benchmark.kernels import bound, histogram_work
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
           **bound(*histogram_work([valid])), "library_ms": library_ms, "kinds": kinds}
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
    from datacomp_tpu_torch.benchmark.kernels import bound, decode_work, encode_work
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
            **bound(*encode_work([CHUNK], c["live"], nsub)),
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
            **bound(*decode_work(c["words"].numel(), nsub, table_bytes, CHUNK)),
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
    from datacomp_tpu_torch.benchmark.kernels import bound, codebook_work
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
        **bound(*codebook_work(1)),
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


def run_cli(label: str, compress_args: list, src: str, dcz: str, out: str,
            batch: int = 1, decompress_args: tuple = (), probes: int = 2) -> dict:
    """compress then decompress through the CLI at ``batch_chunks`` ``batch``
    (0: auto), with every count set to 0 just before and read just after.
    ``probes``: the services' availability probes (K1 launches), one a
    command through the factory and none under ``--backend gpu``."""
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
    rc_d = cli.main(["decompress", dcz, out, "16", *decompress_args, "--stages"])
    t2 = time.perf_counter()
    del os.environ["DATACOMP_DEVICE_BATCH_CHUNKS"]
    res = {
        "launches": {name: k.value for name, (k, _) in COUNTERS.items()},
        "plain": {name: r.value for name, (_, r) in COUNTERS.items()},
        "encode_routes": gpu_service.host_encode_routes.value,
        "decode_routes": gpu_service.host_decode_routes.value,
        "probes": probes,
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
    from datacomp_tpu_torch.benchmark.kernels import (
        bound, codebook_work, decode_work, encode_work, histogram_work,
    )
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
            **bound(*histogram_work(valid)),
        },
        "codebook": {
            "ms": cuda_ms(lambda h: codebook_batch(h), hs, 200),
            "device_ms": graph_ms(codebook_batch, hs, 48 * SHORT_PER_INPUT, SHORT_PER_INPUT),
            "unbatched_device_ms": graph_ms(
                lambda h: [codebook(h[b]) for b in range(rows)], hs, 48 * SHORT_PER_INPUT,
                SHORT_PER_INPUT),
            "plain_ms": cuda_ms(lambda h: codebook_batch_reference(h), hs, 10),
            **bound(*codebook_work(rows)),
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
            **bound(*encode_work(valid, live, gap_off[-1])),
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
            **bound(*decode_work(w.numel(), g.numel(), table_bytes, nbytes)),
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


def expected_launches(dcz: str, device_codebook: bool, batch: int, ranks: int = 1,
                      probes: int = 2) -> tuple:
    """The launches and host decode routes a compress → decompress of ``dcz``
    at ``batch_chunks`` ``batch`` implies: each group of ``batch`` chunks
    (of each rank's round-robin stripe, with ``ranks`` ranks) runs the
    batched kernels once when two or more of its members reach the device,
    the unbatched kernels once when one does.  Compress: the chunks not
    stored raw; decompress: v2 chunks of depth 1 to 16 (the rest that are
    not raw take the host route).  K1 also runs once a service probe."""
    from datacomp_tpu_torch.core import read_container
    from datacomp_tpu_torch.ops import TABLE_BITS, max_code_len

    header, _ = read_container(dcz)
    v2 = header.version >= 2
    want = {name: 0 for name in ("histogram", "codebook", "encode", "decode", "histogram_batch",
                                 "codebook_batch", "encode_batch", "decode_batch")}
    routes = 0
    groups = [stripe[i : i + batch] for stripe in (header.chunks[r::ranks] for r in range(ranks))
              for i in range(0, len(stripe), batch)]
    for group in groups:
        depths = [max_code_len(c.code_lengths) for c in group]
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
    want["histogram"] += probes  # by default one for each CLI command's service
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


def check_sharded_step(d: str, corpus: np.ndarray) -> dict:
    """Phase 11a: the sharded compress and decompress steps at world size 1,
    the all-gather on NCCL.  ``tools.sharded_step.check_step`` holds the
    step to the batched kernels and the host's cumsum and times it; here it
    is also held to the plain versions, and the decompress step restores
    the rows."""
    import torch.distributed as dist

    from datacomp_tpu_torch import parallel
    from datacomp_tpu_torch.ops import (
        COUNTERS, TABLE_BITS, codebook_batch_reference, encode_batch_reference,
        histogram_batch_reference, max_code_len, payload_to_words, reset_counters,
        words_to_bytes,
    )
    from datacomp_tpu_torch.tools.sharded_step import check_step

    # the corpus's chunks: text 0-1, compressible 2-3, skewed 4-5, random 6-7
    rows = np.stack([corpus[0:CHUNK], corpus[4 * CHUNK : 5 * CHUNK],
                     corpus[2 * CHUNK : 3 * CHUNK], np.zeros(CHUNK, np.uint8)])
    valid = list(SHARDED_VALID)
    x = torch.from_numpy(rows).cuda()
    out_words = (9 * CHUNK + 31) // 32 + 2
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"file://{d}/pg-store",
                            world_size=1, rank=0)
    try:
        mesh = parallel.make_mesh(1, device="cuda:0")
        got, res = check_step(mesh, x, valid, SUBBLOCK)
        if not res["ok"]:
            fail(f"sharded step: {res}")
        ph = histogram_batch_reference(x, valid)
        pl, pc = codebook_batch_reference(ph)
        plain = (ph, pl, pc, *encode_batch_reference(x, valid, pl, pc, out_words, SUBBLOCK))
        names = ("hists", "lengths", "codes", "words", "total_bits", "gaps")
        err = 0
        for name, mine, p in zip(names, got, plain):
            if not torch.equal(mine.cpu(), p.cpu()):
                fail(f"sharded step: {name} differ from the plain versions")
            err = max(err, max_abs_err(mine, p))
        lengths = got[1].cpu().numpy()
        depths = [max_code_len(row) for row in lengths]
        keep = [b for b, dep in enumerate(depths) if 0 < dep <= TABLE_BITS]
        words, totals, gaps = (t.cpu().numpy() for t in got[3:6])
        reset_counters()
        restored = parallel.sharded_decompress_arrays(
            mesh, [payload_to_words(words_to_bytes(words[b], int(totals[b]))) for b in keep],
            gaps[keep], lengths[keep], SUBBLOCK, [valid[b] for b in keep])
        for b, row in zip(keep, restored):
            if not np.array_equal(row.cpu().numpy(), rows[b, : valid[b]]):
                fail(f"sharded decompress step: row {b} is not restored")
        res["launches"]["decode_batch"] = COUNTERS["decode_batch"][0].value
        res.update(rows=len(valid), valid=valid, depths=depths, max_abs_err=err,
                   restored_rows=keep)
    finally:
        dist.destroy_process_group()
    print(f"sharded step, world size 1 on NCCL, {len(valid)} rows of {CHUNK >> 20} MiB (text, "
          f"skewed, compressible, empty; valid_len {valid}): equal to the batched kernels and "
          f"the plain versions, offsets the host's cumsum; launches {res['launches']}; rows "
          f"{keep} restored by the decompress step (depths {depths}); step {res['step_ms']} ms "
          f"against the batched K1 → K4 → K2 alone {res['batched_kernels_ms']} ms and the "
          f"all-gather alone {res['all_gather_ms']} ms (events)",
          flush=True)
    return res


def cli_out(argv: list, env: dict | None = None, echo: bool = True) -> tuple:
    """The port's CLI in this process, with ``env`` set in the environment for
    the call: (seconds, its output).  A non-zero exit fails the script."""
    from datacomp_tpu_torch import cli

    saved = {key: os.environ.get(key) for key in env or {}}
    os.environ.update(env or {})
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        for key, value in saved.items():
            if value is None:
                del os.environ[key]
            else:
                os.environ[key] = value
    seconds = time.perf_counter() - t0
    if echo:
        print(buf.getvalue(), end="", flush=True)
    if rc != 0:
        fail(f"{' '.join(argv[:2])} exited {rc}:\n{buf.getvalue()[-2000:]}")
    return seconds, buf.getvalue()


def cli_in_process(argv: list) -> tuple:
    """The port's CLI with ``--sharded --stages`` in this process, a job of one
    rank on ``cuda:0`` (a lone process is one, and runs the code a 1-rank
    ``torchrun`` would; ``device_index`` 0 keeps it on one card where the
    host has several): (seconds, its output)."""
    return cli_out([*argv, "--sharded", "--stages"], env={"DATACOMP_DEVICE_DEVICE_INDEX": "0"})


def torchrun_jobs(d: str, ranks: int, argvs: list) -> list:
    """``torchrun --standalone --nproc_per_node ranks`` of the port's CLI with
    ``--sharded --stages``, one job for each of ``argvs``, all started at
    once (a job is nearly all process start), every rank on ``cuda:0``:
    [(seconds from its start to its end, rank 0's output)].  A job past 300
    s, or one that exits non-zero, fails the script; every job is stopped
    first."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, DATACOMP_DEVICE_DEVICE_INDEX="0",
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    jobs, ends = [], {}
    try:
        for i, argv in enumerate(argvs):
            logs = [open(os.path.join(d, f"torchrun{i}.{ext}"), "w+") for ext in ("out", "err")]
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", str(ranks), "-m", "datacomp_tpu_torch.cli", *argv,
                   "--sharded", "--stages"]
            jobs.append((time.perf_counter(), subprocess.Popen(
                cmd, cwd=root, env=env, stdout=logs[0], stderr=logs[1]), logs))
        while len(ends) < len(jobs):
            for i, (t0, proc, _) in enumerate(jobs):
                if i not in ends and proc.poll() is not None:
                    ends[i] = time.perf_counter() - t0
            if time.perf_counter() - jobs[0][0] > 300:
                break
            time.sleep(0.02)
    finally:
        for _, proc, _ in jobs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    res = []
    for i, (argv, (_, proc, logs)) in enumerate(zip(argvs, jobs)):
        for f in logs:
            f.seek(0)
        out, err = (f.read() for f in logs)
        for f in logs:
            f.close()
        if i not in ends or proc.returncode != 0:
            fail(f"{argv[0]} --sharded at {ranks} ranks exited {proc.returncode} or ran past "
                 f"300 s:\n{out[-2000:]}\n{err[-4000:]}")
        res.append((ends[i], out))
    return res


def _cli_numbers(out: str) -> tuple:
    """(the CLI's own MB/s, the counts rank 0 printed) from its output."""
    mbps = float(out.split("Throughput:")[1].split()[0])
    return mbps, json.loads(out.split("counts: ")[1].splitlines()[0])


def sharded_dcz(d: str, leg: str, ranks: int) -> tuple:
    return os.path.join(d, f"{leg}-r{ranks}.dcz"), os.path.join(d, f"{leg}-r{ranks}.out")


def check_sharded_cli(d: str, src: str, label: str, compress_args: list, leg: str,
                      ranks: int, compressed: tuple, decompressed: tuple, at_once: bool) -> dict:
    """Phase 11b: one configuration's ``compress --sharded`` and ``decompress
    --sharded`` at ``ranks`` ranks, each a (seconds, rank 0's output), held
    to phase 6/7's ``{leg}.dcz``, the corpus, and the launches and routes
    its container implies for each rank's stripe."""
    from datacomp_tpu_torch.ops import COUNTERS

    dcz, out = sharded_dcz(d, leg, ranks)
    size = os.path.getsize(src)
    (c_s, c_out), (d_s, d_out) = compressed, decompressed
    if not filecmp.cmp(dcz, os.path.join(d, f"{leg}.dcz"), shallow=False):
        fail(f"{label}, {ranks} ranks: the .dcz differs from the single-process file")
    if not filecmp.cmp(src, out, shallow=False):
        fail(f"{label}, {ranks} ranks: decompress did not restore the input")
    (c_mbps, c_counts), (d_mbps, d_counts) = _cli_numbers(c_out), _cli_numbers(d_out)
    got = {name: c_counts["launches"][name] + d_counts["launches"][name] for name in COUNTERS}
    want, routes = expected_launches(dcz, "device" in compress_args, AUTO_BATCH, ranks, probes=0)
    plain = sum(c_counts["plain"].values()) + sum(d_counts["plain"].values())
    if ({name: got[name] for name in want} != want or d_counts["host_decode_routes"] != routes
            or plain or c_counts["host_encode_routes"]):
        fail(f"{label}, {ranks} ranks: launches {got}, routes {d_counts['host_decode_routes']} "
             f"and plain calls {plain}; the container implies {want} and {routes} routes")
    res = {"ranks": ranks, "compress_mbps": size / 1e6 / c_s, "decompress_mbps": size / 1e6 / d_s,
           "cli_compress_mbps": c_mbps, "cli_decompress_mbps": d_mbps,
           "launches": {name: v for name, v in got.items() if v},
           "host_decode_routes": d_counts["host_decode_routes"], "jobs_at_once": at_once}
    how = ("torchrun, process starts included, both configurations' jobs at once" if at_once
           else "in this process")
    print(f"{label}, --sharded at {ranks} rank(s) sharing one card: .dcz byte-identical to "
          f"the single-process file, corpus restored; wall ({how}) compress "
          f"{res['compress_mbps']} MB/s, decompress {res['decompress_mbps']} MB/s; the CLI's "
          f"own {c_mbps} / {d_mbps} MB/s; launches {res['launches']} as the stripes imply; host "
          f"decode routes {routes}", flush=True)
    return res


def run_sharded_cli(d: str, src: str) -> dict:
    """Phase 11b: fast v2 and device v2 through ``--sharded``, at 1 rank in
    this process (one configuration after the other), then at 2 ranks under
    ``torchrun`` (both configurations' compress jobs at once, then both
    decompress jobs)."""
    legs = (("fast", "fast path (v2, host codebook)", ["--format", "2", "--codebook-mode", "fast"]),
            ("dev2", "device codebook, v2", ["--format", "2", "--codebook-mode", "device"]))
    res = {}
    for leg, label, args in legs:
        dcz, out = sharded_dcz(d, leg, 1)
        compressed = cli_in_process(["compress", src, dcz, "16", *args, "--no-verify"])
        decompressed = cli_in_process(["decompress", dcz, out, "16"])
        res[leg] = [check_sharded_cli(d, src, label, args, leg, 1, compressed, decompressed,
                                      at_once=False)]
    compressed = torchrun_jobs(d, 2, [["compress", src, sharded_dcz(d, leg, 2)[0], "16", *args,
                                       "--no-verify"] for leg, _, args in legs])
    decompressed = torchrun_jobs(d, 2, [["decompress", *sharded_dcz(d, leg, 2), "16"]
                                        for leg, _, _ in legs])
    for (leg, label, args), c, dc in zip(legs, compressed, decompressed):
        res[leg].append(check_sharded_cli(d, src, label, args, leg, 2, c, dc, at_once=True))
    return res


def local_launches(dcz: str, device_codebook: bool, local: int) -> tuple:
    """The launches and host decode routes that a compress → decompress of
    ``dcz`` through a mesh of ``local`` devices implies: device v2 runs K1,
    K4 and K2 once for each device in each group of ``local`` chunks with a
    chunk not stored raw; host codebooks go through the codec in groups of
    ``AUTO_BATCH``; every v2 chunk of depth 1 to 16 decodes on a device of
    its own (one K3 launch), and the deeper ones take the host route."""
    from datacomp_tpu_torch.core import read_container
    from datacomp_tpu_torch.ops import TABLE_BITS, max_code_len

    want, _ = expected_launches(dcz, False, AUTO_BATCH, probes=0)
    want = {name: 0 for name in want} | (
        {} if device_codebook else {name: want[name] for name in ("encode", "encode_batch")})
    depths = [max_code_len(c.code_lengths) for c in read_container(dcz)[0].chunks]
    if device_codebook:
        groups = sum(1 for g in range(0, len(depths), local) if any(depths[g : g + local]))
        for name in ("histogram_batch", "codebook_batch", "encode_batch"):
            want[name] = local * groups
    want["decode_batch"] = sum(1 for dep in depths if 0 < dep <= TABLE_BITS)
    return want, sum(1 for dep in depths if dep > TABLE_BITS)


def run_local_mesh(d: str, src: str) -> dict:
    """Phase 13: the corpus through a local mesh of ``cuda:0`` twice, device
    v2 and fast v2, against phase 7's and phase 6's files, with every count
    set to 0 just before each leg and read just after; then the dry runs."""
    from datacomp_tpu_torch import graft_entry, parallel
    from datacomp_tpu_torch.config import load_config
    from datacomp_tpu_torch.models import StageMetrics
    from datacomp_tpu_torch.ops import COUNTERS, reset_counters
    from datacomp_tpu_torch.services import gpu_service
    from datacomp_tpu_torch.tools import cuda_ms

    t_phase = time.perf_counter()
    if load_config().device.fallback_on_error:
        fail("device.fallback_on_error is on: a device error would be hidden")
    mesh = parallel.make_mesh(devices=["cuda:0", "cuda:0"])
    size, res = os.path.getsize(src), {"local_devices": [str(x) for x in mesh.local_devices]}
    for leg, label, mode in (("dev2", "device codebook, v2", "device"),
                             ("fast", "fast path (v2, host codebook)", "fast")):
        cfg = load_config(compression={"chunk_size_mb": CHUNK >> 20, "format_version": 2,
                                       "codebook_mode": mode})
        dcz, out = os.path.join(d, f"{leg}-local.dcz"), os.path.join(d, f"{leg}-local.out")
        stages = [StageMetrics(), StageMetrics()]
        reset_counters()
        gpu_service.host_encode_routes.reset()
        gpu_service.host_decode_routes.reset()
        t0 = time.perf_counter()
        parallel.compress_multihost(src, dcz, cfg, mesh=mesh, metrics=stages[0])
        t1 = time.perf_counter()
        parallel.decompress_multihost(dcz, out, cfg, mesh=mesh, metrics=stages[1])
        t2 = time.perf_counter()
        launches = {name: k.value for name, (k, _) in COUNTERS.items()}
        plain = sum(r.value for _, r in COUNTERS.values())
        routes = (gpu_service.host_encode_routes.value, gpu_service.host_decode_routes.value)
        if not filecmp.cmp(dcz, os.path.join(d, f"{leg}.dcz"), shallow=False):
            fail(f"{label}, local mesh: the .dcz differs from the single-device file")
        if not filecmp.cmp(src, out, shallow=False):
            fail(f"{label}, local mesh: decompress did not restore the input")
        want, want_routes = local_launches(dcz, mode == "device", len(mesh.local_devices))
        got = {name: launches[name] for name in want}
        if got != want or plain or routes != (0, want_routes):
            fail(f"{label}, local mesh: launches {got}, plain calls {plain}, routes {routes}; "
                 f"the container implies {want} and {want_routes} host decode routes")
        res[leg] = {"compress_mbps": size / 1e6 / (t1 - t0),
                    "decompress_mbps": size / 1e6 / (t2 - t1),
                    "launches": {name: v for name, v in launches.items() if v},
                    "host_decode_routes": routes[1]}
        print(f"{label}, local mesh of {len(mesh.local_devices)} entries on cuda:0: .dcz "
              f"byte-identical to the single-device file, corpus restored; compress "
              f"{res[leg]['compress_mbps']} MB/s, decompress {res[leg]['decompress_mbps']} MB/s "
              f"(wall); launches {got} as the container implies; host decode routes "
              f"{routes[1]}\ncompress stages:\n{stages[0].summary()}\ndecompress stages:\n"
              f"{stages[1].summary()}", flush=True)

    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(torch.cuda.device_count())
    res["dryrun_multichip_s"] = time.perf_counter() - t0
    fn, args = graft_entry.entry()
    got = fn(*args)
    plain_fn, plain_args = graft_entry.entry(device="cpu")
    if not all(torch.equal(a.cpu(), b) for a, b in zip(got, plain_fn(*plain_args))):
        fail("entry(): the kernels' pipeline differs from its plain version")
    res["entry_ms"] = cuda_ms(fn, [args], 50)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"dryrun_multichip({torch.cuda.device_count()}) ok in {res['dryrun_multichip_s']} s; "
          f"entry()'s K1 → K4 → K2 on 64 KiB equal to the plain versions, {res['entry_ms']} ms "
          f"a call (events, back to back); phase 13 {res['seconds']} s", flush=True)
    return res


def counts() -> dict:
    """The kernels this process launched since the counts were last set to 0."""
    from datacomp_tpu_torch.ops import COUNTERS

    return {name: k.value for name, (k, _) in COUNTERS.items() if k.value}


def check_corpus_bench(d: str) -> dict:
    """Phase 12a: ``gen 16 DIR --corpus``, then ``bench --corpus DIR`` on the
    ``gpu`` and the ``cpu`` backend (java v1, every file round-tripped by the
    bench): each file's compressed size the same on both.  16 MB, not the
    64 MB default: the generators are Python loops (about 0.3 s a MB on the
    host), and every file is one chunk at either size."""
    from datacomp_tpu_torch.ops import reset_counters

    corpus = os.path.join(d, "corpus")
    gen_s, _ = cli_out(["gen", str(SURFACE_CORPUS_MB), corpus, "--corpus"], echo=False)
    reports, launches = {}, {}
    for backend in ("gpu", "cpu"):
        reset_counters()
        secs, out = cli_out(["bench", "--corpus", corpus, "--corpus-backend", backend,
                             "--format-out", "json"], echo=False)
        launches[backend] = counts()
        reports[backend] = json.loads(out)
    sizes = {b: {r["file"]: r["compressed_bytes"] for r in rep["files"]}
             for b, rep in reports.items()}
    if len(sizes["gpu"]) != 7 or sizes["gpu"] != sizes["cpu"]:
        fail(f"corpus bench: gpu sizes {sizes['gpu']} differ from cpu sizes {sizes['cpu']}")
    if launches["cpu"] or not launches["gpu"].get("encode", 0) + launches["gpu"].get(
            "encode_batch", 0):
        fail(f"corpus bench: launches {launches}: K2 must run on gpu, nothing on cpu")
    totals = {b: rep["totals"] for b, rep in reports.items()}
    print(f"12a corpus: gen {SURFACE_CORPUS_MB} MB in {gen_s} s; bench --corpus gpu and cpu: compressed sizes "
          f"equal on all 7 files {sizes['gpu']}, every round trip held; gpu launches "
          f"{launches['gpu']}; totals gpu {totals['gpu']}, cpu {totals['cpu']}", flush=True)
    return {"sizes": sizes["gpu"], "launches": launches["gpu"], "totals": totals,
            "gen_s": gen_s}


def check_suite(d: str, src: str) -> dict:
    """Phase 12b: ``bench --size-mb 16`` (a CPU and a GPU row for each
    operation, the GPU row named after the card), then the suite's
    ``benchmark_service`` on the GPU service with ``detailed_profiling`` over
    the corpus in the fast v2 configuration: the trace is written, and its
    device share printed when it holds CUDA events."""
    from datacomp_tpu_torch.benchmark.suite import (
        BenchmarkSuite, device_time_split, gpu_row_name,
    )
    from datacomp_tpu_torch.config import load_config
    from datacomp_tpu_torch.services import create_compression_service

    secs, out = cli_out(["bench", "--size-mb", "16", "--format-out", "json"], echo=False)
    report = json.loads(out)
    gpu = f"GPU ({torch.cuda.get_device_name(0)})"
    rows = {(r["service"], r["operation"]): r for r in report["results"]}
    if set(rows) != {(name, op) for name in ("CPU", gpu) for op in ("compress", "decompress")}:
        fail(f"bench: rows {sorted(rows)}; a CPU and a {gpu} row for each operation expected")
    print(f"12b bench --size-mb 16 ({secs} s): "
          + "; ".join(f"{name} {op} {r['throughput_mbps']} MB/s" for (name, op), r in
                      rows.items())
          + f"; speedup compress {report['speedup_compress']}, decompress "
          f"{report['speedup_decompress']}", flush=True)
    cfg = load_config(compression={"chunk_size_mb": 16, "format_version": 2,
                                   "codebook_mode": "fast"},
                      benchmark={"detailed_profiling": True, "warmup_iterations": 1,
                                 "measurement_iterations": 3})
    svc = create_compression_service(cfg)
    try:
        profiled = BenchmarkSuite(cfg).benchmark_service(svc, gpu_row_name(svc), src, d)
    finally:
        svc.close()
    trace = os.path.join(d, "torch-trace-GPU.json")
    if not os.path.isfile(trace):
        fail(f"detailed_profiling wrote no {trace}")
    split = device_time_split(trace)
    if split is None:
        print("profiler: no device events", flush=True)
    else:
        print(f"12b profiler, 3 compresses of the {CORPUS_MB} MB corpus (fast v2, "
              f"{profiled[0].mean_s * 1e3} ms each, trace {os.path.getsize(trace)} bytes): "
              f"kernels {split['kernel_ms']} ms, memcpy {split['memcpy_ms']} ms, memset "
              f"{split['memset_ms']} ms, device busy {split['busy_ms']} ms of a "
              f"{split['window_ms']} ms window: idle share {split['idle_share']}", flush=True)
    return {"rows": {f"{name} {op}": r["throughput_mbps"] for (name, op), r in rows.items()},
            "speedup_compress": report["speedup_compress"],
            "speedup_decompress": report["speedup_decompress"], "trace_split": split,
            "profiled_compress_ms": profiled[0].mean_s * 1e3}


def check_kernel_bench(hist: dict, codec: dict, cbook: dict) -> dict:
    """Phase 12c: ``bench --kernels --kind text``: every row exact; each
    row's device time beside the one phases 2-4 measured for the same kernel
    on the same text chunk (phase 3 ran the v2 auto cap, 8 bits on text)."""
    secs, out = cli_out(["bench", "--kernels", "--kind", "text", "--format-out", "json"],
                        echo=False)
    report = json.loads(out)
    rows = {k: v for k, v in report["kernels"].items() if not k.startswith("_")}
    want = {"histogram", "histogram-library", "codebook", "encode", "decode"}
    if not want <= set(rows) or not all(r["exact"] for r in rows.values()):
        fail(f"bench --kernels: rows {sorted(rows)}, exact {[r['exact'] for r in rows.values()]}")
    earlier = {"histogram": hist["kinds"]["text"]["device_ms"], "codebook": cbook["device_ms"]}
    for name in rows:
        if name.startswith(("encode", "decode")):
            earlier[name] = codec["text"][name.split("-")[0]]["device_ms"]
    print(f"12c bench --kernels --kind text ({secs} s), device {report['device']}:", flush=True)
    for name, r in rows.items():
        beside = (f"; phase 2-4 {earlier[name]} ms, ratio {r['ms_per_chunk'] / earlier[name]}"
                  if name in earlier else "")
        print(f"  {name}: {r['ms_per_chunk']} ms (call {r['call_ms']}), bound {r['bound_ms']} "
              f"[{r['bound_kind']}], efficiency {r['efficiency']}, depth {r.get('depth')}"
              f"{beside}", flush=True)
    print(f"  primitives: {json.dumps(report['kernels']['_primitives'])}", flush=True)
    return {"rows": rows, "primitives": report["kernels"]["_primitives"],
            "device": report["device"], "earlier_ms": earlier, "seconds": secs}


def check_batch_bench() -> dict:
    """Phase 12d: ``bench --batched``: both benches at B = 1, 4 and 8."""
    secs, out = cli_out(["bench", "--batched", "--format-out", "json"], echo=False)
    rows = json.loads(out)["pipeline"]
    want = {f"{bench}-b{b}" for bench in ("pipeline", "decode") for b in (1, 4, 8)}
    if set(rows) != want:
        fail(f"bench --batched: rows {sorted(rows)}, expected {sorted(want)}")
    print(f"12d bench --batched ({secs} s): " + "; ".join(
        f"{name} {r['compute_ms_per_chunk']} ms/chunk, overhead {r['overhead_ms_per_program']} "
        f"ms/call" for name, r in rows.items()), flush=True)
    return rows


def check_resume(d: str, src: str) -> dict:
    """Phase 12e: phase 6's fast v2 ``.dcz`` cut after chunk 2, with its
    ``.partial`` sidecar, then ``resume SRC DCZ 16 --last-chunk 2`` at
    ``batch_chunks`` 1: the phase-6 file byte for byte, K2 once a resumed
    chunk that is not stored raw."""
    from datacomp_tpu_torch.core import read_container
    from datacomp_tpu_torch.ops import max_code_len, reset_counters
    from datacomp_tpu_torch.services import pipeline

    full_path = os.path.join(d, "fast.dcz")
    header, _ = read_container(full_path)
    dcz = os.path.join(d, "resumed.dcz")
    with open(dcz + pipeline.PARTIAL_SUFFIX, "wb") as f:
        pipeline._write_partial_header(f, header)
        for c in header.chunks[:3]:
            pipeline._append_partial_chunk(f, c)
    with open(full_path, "rb") as f:
        full = f.read()
    with open(dcz, "wb") as f:
        f.write(full[: header.chunks[2].compressed_offset + header.chunks[2].compressed_size])
    reset_counters()
    secs, _ = cli_out(["resume", src, dcz, "16", "--last-chunk", "2", "--stages"],
                      env={"DATACOMP_COMPRESSION_FORMAT_VERSION": "2",
                           "DATACOMP_COMPRESSION_CODEBOOK_MODE": "fast",
                           "DATACOMP_DEVICE_BATCH_CHUNKS": "1"}, echo=False)
    launches = counts()
    coded = sum(1 for c in header.chunks[3:] if max_code_len(c.code_lengths) > 0)
    if not filecmp.cmp(dcz, full_path, shallow=False):
        fail("resume: the resumed .dcz differs from phase 6's")
    if os.path.exists(dcz + pipeline.PARTIAL_SUFFIX):
        fail("resume: the .partial sidecar is left behind")
    if launches.get("encode", 0) != coded or launches.get("encode_batch", 0):
        fail(f"resume: launches {launches}; K2 once for each of {coded} coded chunks expected")
    print(f"12e resume --last-chunk 2 ({secs} s): .dcz byte-identical to phase 6's; "
          f"launches {launches} for chunks 3-{len(header.chunks) - 1} ({coded} coded)",
          flush=True)
    return {"launches": launches, "coded": coded, "seconds": secs}


def check_dashboard_config_stats(d: str) -> None:
    """Phase 12f: ``dashboard --html`` names the card; ``config --init`` then
    ``config --file`` reads it back; ``stats`` lists this process's runs."""
    name = torch.cuda.get_device_name(0)
    html = os.path.join(d, "dashboard.html")
    _, out = cli_out(["dashboard", "--html", html], echo=False)
    with open(html) as f:
        page = f.read()
    if name not in out or name not in page:
        fail(f"dashboard: {name} is not named:\n{out}")
    toml = os.path.join(d, "datacomp.toml")
    cli_out(["config", "--init", toml], echo=False)
    _, out = cli_out(["config", "--file", toml], echo=False)
    if "[benchmark]" not in out or "measurement_iterations = 5" not in out:
        fail(f"config --file: {out}")
    _, stats = cli_out(["stats"], echo=False)
    device = next(line for line in out.splitlines() if "platform" in line)
    print(f"12f dashboard names {name}; config --init / --file round trip ({device.strip()}); "
          f"stats lists {len(stats.splitlines())} operations", flush=True)


def check_surfaces(d: str, src: str, hist: dict, codec: dict, cbook: dict) -> dict:
    """Phase 12, the surfaces, through ``cli.main`` in this process."""
    t0 = time.perf_counter()
    res = {"corpus": check_corpus_bench(d), "suite": check_suite(d, src),
           "kernel_bench": check_kernel_bench(hist, codec, cbook),
           "batch_bench": check_batch_bench(), "resume": check_resume(d, src)}
    check_dashboard_config_stats(d)
    res["seconds"] = time.perf_counter() - t0
    print("surfaces: " + json.dumps(res), flush=True)
    return res


def run_headline(d: str, src: str, fast: dict) -> dict:
    """Phase 14: the headline benchmark (``datacomp_tpu_torch.bench``).  In
    this process, both legs on the corpus at full size (16 MiB chunks,
    ``HEADLINE_ITERS``), with every count set to 0 just before and read just
    after: the ``gpu`` leg's ``.dcz`` is phase 6's and its ratio phase 6's,
    K1 ran for the service's probe alone, K2 and K3 as the container implies
    at ``batch_chunks`` auto for each warm-up and timed call, and no plain
    version or host route ran.  Then ``python -m datacomp_tpu_torch.bench``
    once at ``BENCH_SIZE_MB=16``: exit 0 and one JSON line on stdout."""
    from datacomp_tpu_torch import bench
    from datacomp_tpu_torch.ops import COUNTERS, reset_counters
    from datacomp_tpu_torch.services import gpu_service

    t_phase = time.perf_counter()
    work = os.path.join(d, "headline")
    os.makedirs(work)
    reset_counters()
    gpu_service.host_encode_routes.reset()
    gpu_service.host_decode_routes.reset()
    line = bench.run(src, work, CHUNK >> 20, HEADLINE_ITERS, list(bench.BACKENDS))
    launches = {name: k.value for name, (k, _) in COUNTERS.items()}
    plain = sum(r.value for _, r in COUNTERS.values())
    routes = (gpu_service.host_encode_routes.value, gpu_service.host_decode_routes.value)
    in_process_s = time.perf_counter() - t_phase
    print(f"14 headline, in process ({in_process_s} s): {json.dumps(line)}", flush=True)
    dcz = os.path.join(work, "g.dcz")
    if not filecmp.cmp(dcz, os.path.join(d, "fast.dcz"), shallow=False):
        fail("headline: the gpu leg's .dcz differs from phase 6's")
    if line["gpu_ratio"] != round(fast["ratio"], 4):
        fail(f"headline: gpu_ratio {line['gpu_ratio']} is not phase 6's {fast['ratio']}")
    calls = 1 + HEADLINE_ITERS  # a warm-up, then the timed calls, each way
    want, want_routes = expected_launches(dcz, False, AUTO_BATCH, probes=0)
    want = {name: calls * n for name, n in want.items()}
    want["histogram"] += 1  # the service's availability probe
    got = {name: launches[name] for name in want}
    if got != want or plain or routes != (0, calls * want_routes):
        fail(f"headline: launches {got}, plain calls {plain}, routes {routes}; the "
             f"container implies {want} and {calls * want_routes} host decode routes")
    if line["device"]["name"] != torch.cuda.get_device_name(0):
        fail(f"headline: device {line['device']} is not the card")
    print(f"14 headline: gpu .dcz byte-identical to phase 6's, ratio {line['gpu_ratio']}; "
          f"launches {got} as the container implies for {calls} compresses and decompresses "
          f"and one probe; no plain version, no host route", flush=True)

    t0 = time.perf_counter()
    env = {**os.environ, "BENCH_SIZE_MB": str(HEADLINE_SUBPROCESS_MB)}
    for key in ("BENCH_CHUNK_MB", "BENCH_ITERS", "BENCH_BACKENDS", "DATACOMP_DEVICE_PLATFORM"):
        env.pop(key, None)
    try:
        proc = subprocess.run([sys.executable, "-m", "datacomp_tpu_torch.bench"], env=env,
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        fail("headline: python -m datacomp_tpu_torch.bench ran past 300 s")
    sub_s = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    print(f"14 headline, python -m datacomp_tpu_torch.bench at BENCH_SIZE_MB="
          f"{HEADLINE_SUBPROCESS_MB} ({sub_s} s, exit {proc.returncode}): {proc.stdout.strip()}",
          flush=True)
    if proc.returncode != 0 or len(lines) != 1:
        fail(f"headline: the module exited {proc.returncode} with {len(lines)} stdout lines; "
             f"stderr:\n{proc.stderr[-3000:]}")
    sub = json.loads(lines[0])
    missing = sorted(set(line) - set(sub))
    if missing or sub["file_mb"] != HEADLINE_SUBPROCESS_MB or sub["gpu_link_ceiling_mbps"] is None:
        fail(f"headline: the module's line lacks {missing} or its numbers: {sub}")
    seconds = time.perf_counter() - t_phase
    print(f"phase 14 {seconds} s", flush=True)
    return {"line": line, "launches": {k: v for k, v in launches.items() if v},
            "subprocess_line": sub, "subprocess_s": sub_s, "seconds": seconds}


def run_cli_options(d: str, src: str) -> dict:
    """Phase 15: the CLI's ``--backend``, ``--max-code-len`` and ``--sharded``
    defaults on the card.  15a: ``--backend gpu`` fast v2 at ``--max-code-len
    12``, ``batch_chunks`` 1: the host codec's ``.dcz``, every depth at most
    12, K2 and K3 once a coded chunk, nothing else.  15b: ``compress
    --sharded`` with no format or codebook flag: phase 7's ``.dcz``.  15c:
    ``--backend gpu`` and ``auto`` without a visible card exit non-zero and
    write nothing."""
    from datacomp_tpu_torch.core import read_container
    from datacomp_tpu_torch.ops import max_code_len

    t_phase = time.perf_counter()
    cap = 12
    dcz, out, ref = (os.path.join(d, f) for f in ("cap.dcz", "cap.out", "cap-host.dcz"))
    res = run_cli(f"--backend gpu, fast v2, --max-code-len {cap}",
                  ["--backend", "gpu", "--format", "2", "--codebook-mode", "fast",
                   "--max-code-len", str(cap)], src, dcz, out,
                  decompress_args=("--backend", "gpu"), probes=0)
    host = host_codec({"format_version": 2, "codebook_mode": "fast", "max_code_len": cap}, src,
                      ref, os.path.join(d, "cap-host.out"))
    if not filecmp.cmp(dcz, ref, shallow=False):
        fail("15a: the --backend gpu .dcz differs from the host codec's")
    depths = [max_code_len(c.code_lengths) for c in read_container(dcz)[0].chunks]
    coded = sum(1 for dep in depths if dep > 0)
    want = {name: 0 for name in res["launches"]} | {"encode": coded, "decode": coded}
    if max(depths) > cap or coded == 0 or res["launches"] != want or res["decode_routes"]:
        fail(f"15a: depths {depths}, launches {res['launches']} (want {want}), host decode "
             f"routes {res['decode_routes']}")
    cap_s = time.perf_counter() - t_phase
    print(f"15a --backend gpu --max-code-len {cap} ({cap_s} s): .dcz byte-identical to the "
          f"host codec's (which ran at {host[0]} / {host[1]} MB/s); depths {depths} (0 = "
          f"stored raw); K2 and K3 {coded} launches each, nothing else", flush=True)

    dcz = os.path.join(d, "defaults-sharded.dcz")
    t0 = time.perf_counter()
    _, text = cli_in_process(["compress", src, dcz, "16"])
    sharded_s = time.perf_counter() - t0
    counts_line = json.loads(text.split("counts: ")[1].splitlines()[0])
    if not filecmp.cmp(dcz, os.path.join(d, "dev2.dcz"), shallow=False):
        fail("15b: compress --sharded with no flags differs from phase 7's device v2 .dcz")
    if "Verify:     OK" not in text or sum(counts_line["plain"].values()):
        fail(f"15b: verify or plain calls: {counts_line}")
    sharded_launches = {k: v for k, v in counts_line["launches"].items() if v}
    print(f"15b compress --sharded, no format or codebook flag ({sharded_s} s): .dcz "
          f"byte-identical to phase 7's device v2 file; launches {sharded_launches}",
          flush=True)

    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("DATACOMP_")}
    env.update(CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    procs, t0 = {}, time.perf_counter()
    try:
        for backend in ("gpu", "auto"):
            target = os.path.join(d, f"nocard-{backend}.dcz")
            procs[backend] = (target, subprocess.Popen(
                [sys.executable, "-m", "datacomp_tpu_torch.cli", "compress", src, target, "16",
                 "--backend", backend], cwd=root, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        results = {b: (p.communicate(timeout=120), p.returncode, t) for b, (t, p) in procs.items()}
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for backend, ((_, err), rc, target) in results.items():
        if rc == 0 or os.path.exists(target) or "no CUDA device" not in err:
            fail(f"15c: --backend {backend} with no visible card exited {rc}, wrote "
                 f"{os.path.exists(target)}:\n{err[-2000:]}")
    nocard_s, seconds = time.perf_counter() - t0, time.perf_counter() - t_phase
    print(f"15c --backend gpu and auto with CUDA_VISIBLE_DEVICES='' ({nocard_s} s, two "
          f"processes at once): exit codes { {b: r[1] for b, r in results.items()} }, no file "
          f"written", flush=True)
    print(f"15 cli: {seconds} s", flush=True)
    return {"seconds": seconds, "cap_s": cap_s, "sharded_s": sharded_s, "nocard_s": nocard_s,
            "depths": depths, "launches": res["launches"], "sharded_launches": sharded_launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from datacomp_tpu_torch import bench, native
    from datacomp_tpu_torch.benchmark.kernels import bound, card_line, histogram_work
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
        bench.write_corpus(src, CORPUS_MB)
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
        sharded = {"step": check_sharded_step(d, np.fromfile(src, np.uint8)),
                   **run_sharded_cli(d, src)}
        print("sharded: " + json.dumps(sharded), flush=True)
        check_surfaces(d, src, hist, codec, cbook)
        local = run_local_mesh(d, src)
        print("local mesh: " + json.dumps(local), flush=True)
        headline = run_headline(d, src, fast)
        run_cli_options(d, src)
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
                "plain_ms": hist["plain_ms"], **bound(*histogram_work([valid])),
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
                        # phase 13's device v2 leg (fast v2's for K3)
                        "local_mesh_launches": local["dev2" if name != "decode" else "fast"]
                        ["launches"][f"{name}_batch"],
                        "rows": len(BATCH_VALID), **batched[name], "library_ms": None})
    for entry in kernels:  # phase 14's run of the headline
        entry["headline_launches"] = headline["launches"].get(entry["name"], 0)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
