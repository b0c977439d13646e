"""Command-line interface of the port: the JAX package's verbs (``compress``,
``decompress``, ``verify``, ``resume``, ``bench``, ``gen``, ``stats``,
``config``, ``ui``, ``dashboard``, ``devices``) with its conventions (same
arguments, progress line and report).

    python -m datacomp_tpu_torch.cli compress IN OUT.dcz [CHUNK_MB] --format 2 --codebook-mode fast
    python -m datacomp_tpu_torch.cli compress IN OUT.dcz --format 2 --codebook-mode device
    python -m datacomp_tpu_torch.cli compress IN OUT.dcz --format 2 --codebook-mode fast --max-code-len 12
    python -m datacomp_tpu_torch.cli decompress OUT.dcz RESTORED --backend gpu
    python -m datacomp_tpu_torch.cli verify OUT.dcz --deep
    python -m datacomp_tpu_torch.cli resume IN OUT.dcz --last-chunk 2
    python -m datacomp_tpu_torch.cli bench --size-mb 16 --format-out json
    python -m datacomp_tpu_torch.cli bench --kernels --kind text
    python -m datacomp_tpu_torch.cli bench --batched
    python -m datacomp_tpu_torch.cli gen 64 CORPUS_DIR --corpus
    python -m datacomp_tpu_torch.cli bench --corpus CORPUS_DIR --corpus-backend gpu
    python -m datacomp_tpu_torch.cli dashboard --html report.html
    python -m datacomp_tpu_torch.cli config --init datacomp.toml
    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m datacomp_tpu_torch.cli compress IN OUT.dcz --sharded
    python -m datacomp_tpu_torch.cli compress IN OUT.dcz --sharded --format 2 --codebook-mode fast

``compress --sharded`` writes what the JAX CLI's does: format 2 with the
device codebook, unless ``--format`` or ``--codebook-mode`` says otherwise
(``--format 1`` keeps the config's codebook mode).
``--backend`` (``compress``, ``decompress``, ``verify``, ``resume``) is the
JAX CLI's with ``gpu`` for ``tpu``: ``cpu`` the host codec, ``gpu`` the GPU
service, ``auto`` the config's choice.  The GPU service needs a CUDA device
and raises without one, under ``auto`` too.  The config's ``device``
section selects otherwise: ``DATACOMP_DEVICE_PLATFORM=cpu`` runs the
kernels' plain PyTorch versions, ``DATACOMP_DEVICE_FORCE_CPU=1`` the host
codec.  ``bench --kernels`` and ``bench --batched`` time the kernels on the
card and need one; ``resume`` takes the JAX verb's arguments, so its format
and codebook mode come from the config (``DATACOMP_COMPRESSION_*``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace

from .config import load_config
from .models import MetricsService
from .services import (
    CpuCompressionService, GpuCompressionService, create_compression_service,
    get_available_devices,
)


def _progress_printer(label: str, total_bytes: int = 0):
    """Progress line with live throughput and ETA (as ``datacomp_tpu.cli``)."""
    state = {"last": -1, "t0": None}

    def cb(frac: float) -> None:
        now = time.perf_counter()
        if state["t0"] is None:
            state["t0"] = now
        pct = int(frac * 100)
        if pct == state["last"]:
            return
        state["last"] = pct
        line = f"\r{label}: {pct:3d}%"
        elapsed = now - state["t0"]
        if total_bytes and frac > 0 and elapsed > 0.05:
            done = frac * total_bytes
            mbps = done / 1e6 / elapsed
            remaining = elapsed * (1 - frac) / frac
            eta = f"{int(remaining) // 60}:{int(remaining) % 60:02d}"
            line += f"  {mbps:7.1f} MB/s  ETA {eta} "
        print(line, end="", flush=True)

    return cb


def _input_size(path: str) -> int:
    try:
        return os.path.getsize(path)
    except OSError:
        return 0


def _report(op: str, in_path: str, out_path: str, seconds: float) -> None:
    in_size = os.path.getsize(in_path)
    out_size = os.path.getsize(out_path)
    # compression throughput over input bytes; decompression over output bytes
    mbps = max(in_size if op == "Compression" else out_size, 0) / 1e6 / max(seconds, 1e-9)
    print(f"\n{op} complete:")
    print(f"  Input:      {in_size:,} bytes")
    print(f"  Output:     {out_size:,} bytes")
    if op == "Compression" and in_size > 0:
        print(f"  Ratio:      {out_size / in_size * 100:.2f}%")
        print(f"  Space saved: {(1 - out_size / in_size) * 100:.2f}%")
    print(f"  Time:       {seconds:.2f} s")
    print(f"  Throughput: {mbps:.2f} MB/s")


def _config(args):
    """The config of a command.  ``compress`` takes the JAX CLI's defaults:
    format 1 and the config's codebook mode, or under ``--sharded`` format 2
    and the device codebook.  Explicit ``--format`` and ``--codebook-mode``
    win under ``--sharded`` too (the JAX CLI ignores them there), and an
    explicit ``--format 1`` keeps the config's codebook mode, as it does
    unsharded.  ``--max-code-len`` always goes in, as in the JAX CLI."""
    comp = {"chunk_size_mb": args.chunk_mb}
    mode = getattr(args, "codebook_mode", None)
    if hasattr(args, "format"):
        comp["format_version"] = args.format or (2 if args.sharded else 1)
        comp["max_code_len"] = args.max_code_len
        if args.sharded and comp["format_version"] == 2:
            mode = mode or "device"
    if mode:
        comp["codebook_mode"] = mode
    cfg = load_config(compression=comp)
    if args.backend == "cpu":  # the host codec, as force_cpu selects it
        cfg = replace(cfg, device=replace(cfg.device, force_cpu=True))
    return cfg


def _make_service(args):
    """``--backend gpu``: the GPU service, which raises without a CUDA device
    unless ``device.platform`` is ``cpu``; ``cpu`` (``force_cpu``, set by
    :func:`_config`) and ``auto``: the factory's choice."""
    cfg = _config(args)
    if args.backend == "gpu":
        return GpuCompressionService(cfg)
    return create_compression_service(cfg)


def _rank_counts() -> dict:
    """This process's kernel launches, plain-version calls and host routes
    so far."""
    from .ops import COUNTERS
    from .services import gpu_service

    return {"launches": {name: k.value for name, (k, _) in COUNTERS.items()},
            "plain": {name: r.value for name, (_, r) in COUNTERS.items()},
            "host_encode_routes": gpu_service.host_encode_routes.value,
            "host_decode_routes": gpu_service.host_decode_routes.value}


def _add(a: dict, b: dict, sign: int = 1) -> dict:
    """``a + sign * b``, key by key, nested dicts too."""
    return {k: _add(v, b[k], sign) if isinstance(v, dict) else v + sign * b[k]
            for k, v in a.items()}


def _run_sharded(args, compressing: bool) -> int:
    """``--sharded``: one rank a process and a GPU, as ``torchrun`` starts
    them, or a lone process (a job of one rank) over every visible GPU
    unless ``device.device_index`` names one.  The ranks share the file's
    chunks round-robin, and a lone process's GPUs share its groups
    (``parallel.compress_multihost`` / ``decompress_multihost``).  The
    config selects the backend as the unsharded verbs do, and ``--backend
    cpu`` selects the host codec.  Rank 0 prints the report; with
    ``--stages`` it prints every rank's stage breakdown and the kernel
    launches, plain calls and host routes summed over the ranks and their
    GPUs."""
    import functools

    import torch.distributed as dist

    from .models import StageMetrics
    from .parallel import (
        compress_multihost, decompress_multihost, initialize_distributed, local_devices,
        make_mesh,
    )

    cfg = _config(args)
    devices = local_devices(cfg)
    owned = not dist.is_initialized()
    initialize_distributed(device=devices[0])
    try:
        mesh = make_mesh(devices=devices)
        verb = "compress" if compressing else "decompress"
        if mesh.size == 1 and len(devices) == 1:
            print(f"note: one local device — sharded {verb} degrades to the "
                  "batched single-device path")
        metrics = StageMetrics()
        label = "Compressing" if compressing else "Decompressing"
        progress = _progress_printer(label, _input_size(args.input)) if mesh.rank == 0 else None
        run = compress_multihost if compressing else decompress_multihost
        before = _rank_counts()
        t0 = time.perf_counter()
        backend = "cpu" if cfg.device.force_cpu else "gpu"
        run(args.input, args.output, cfg, backend=backend, mesh=mesh, progress=progress,
            metrics=metrics)
        seconds = time.perf_counter() - t0
        ranks = [{"stages": metrics.summary(), "counts": _add(_rank_counts(), before, -1)}]
        if args.stages and mesh.size > 1:
            mine, ranks = ranks[0], [None] * mesh.size
            dist.all_gather_object(ranks, mine, group=mesh.host_group)
        if mesh.rank != 0:
            return 0
        _report("Compression" if compressing else "Decompression", args.input, args.output,
                seconds)
        if compressing and cfg.output.verify_after_compress and not args.no_verify:
            with CpuCompressionService(cfg) as svc:
                ok = svc.verify_integrity(args.output)
            print(f"  Verify:     {'OK' if ok else 'FAILED'}")
            if not ok:
                return 1
        if args.stages:
            for r, got in enumerate(ranks):
                print(f"rank {r} of {mesh.size}:\n{got['stages']}")
            print("counts: " + json.dumps(functools.reduce(_add, [got["counts"] for got in ranks])))
        return 0
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def cmd_compress(args) -> int:
    if args.sharded:
        return _run_sharded(args, compressing=True)
    svc = _make_service(args)
    try:
        t0 = time.perf_counter()
        svc.compress(args.input, args.output,
                     _progress_printer("Compressing", _input_size(args.input)))
        _report("Compression", args.input, args.output, time.perf_counter() - t0)
        if load_config().output.verify_after_compress and not args.no_verify:
            ok = svc.verify_integrity(args.output)
            print(f"  Verify:     {'OK' if ok else 'FAILED'}")
            if not ok:
                return 1
        if args.stages:
            print(svc.get_last_stage_metrics().summary())
        return 0
    finally:
        svc.close()


def cmd_decompress(args) -> int:
    if args.sharded:
        return _run_sharded(args, compressing=False)
    svc = _make_service(args)
    try:
        t0 = time.perf_counter()
        svc.decompress(args.input, args.output,
                       _progress_printer("Decompressing", _input_size(args.input)))
        _report("Decompression", args.input, args.output, time.perf_counter() - t0)
        if args.stages:
            print(svc.get_last_stage_metrics().summary())
        return 0
    finally:
        svc.close()


def cmd_verify(args) -> int:
    svc = _make_service(args)
    try:
        ok = svc.verify_integrity(args.input, deep=args.deep)
        print(f"{args.input}: {'OK' if ok else 'CORRUPT'}")
        return 0 if ok else 1
    finally:
        svc.close()


def cmd_resume(args) -> int:
    svc = _make_service(args)
    try:
        t0 = time.perf_counter()
        svc.resume_compression(
            args.input, args.output, args.last_chunk,
            _progress_printer("Resuming", _input_size(args.input))
        )
        _report("Compression", args.input, args.output, time.perf_counter() - t0)
        if args.stages:
            print(svc.get_last_stage_metrics().summary())
        return 0
    finally:
        svc.close()


def cmd_bench(args) -> int:
    if args.batched:
        from .benchmark.kernels import (
            batch_chunks,
            cuda_device,
            format_pipeline_batch_results,
            run_decode_batch_bench,
            run_pipeline_batch_bench,
        )

        cuda_device("bench --batched")
        blob = batch_chunks(args.size_mb, args.kind)  # both benches take these chunks
        results = run_pipeline_batch_bench(size_mb=args.size_mb, kind=args.kind, blob=blob)
        results.update(run_decode_batch_bench(size_mb=args.size_mb, kind=args.kind, blob=blob))
        if args.format_out == "json":
            print(json.dumps({"chunk_mb": args.size_mb, "pipeline": results}, indent=2))
        elif args.format_out == "csv":
            print("name,batch,compute_ms_per_chunk,mbps_per_chunk,"
                  "overhead_ms_per_program,overhead_ms_per_chunk")
            for name, r in results.items():
                print(f"{name},{r['batch']},{r['compute_ms_per_chunk']},"
                      f"{r['mbps_per_chunk']},{r['overhead_ms_per_program']},"
                      f"{r['overhead_ms_per_chunk']}")
        else:
            print(format_pipeline_batch_results(results, args.size_mb))
        return 0
    if args.kernels:
        from .benchmark.kernels import format_kernel_results, run_kernel_bench

        results = run_kernel_bench(size_mb=args.size_mb, kind=args.kind)
        print(format_kernel_results(results, args.size_mb, args.format_out))
        return 0
    if args.corpus:
        from .benchmark.corpus import format_corpus_results, run_corpus_bench

        report = run_corpus_bench(args.corpus, backend=args.corpus_backend)
        print(format_corpus_results(report, args.format_out))
        return 0
    from .benchmark.suite import BenchmarkSuite

    suite = BenchmarkSuite(load_config())
    results = suite.run_full_suite(input_path=args.input, size_mb=args.size_mb)
    print(suite.format_results(results, args.format_out))
    return 0


def cmd_gen(args) -> int:
    from .utils.testdata import (
        generate_compressible_file,
        generate_corpus,
        generate_random_file,
    )

    if args.corpus:
        written = generate_corpus(args.output, scale=args.size_mb / 64.0)
        for path, kind in written:
            print(f"  {path}  [{kind}]")
        print(f"Generated {len(written)}-file corpus in {os.path.abspath(args.output)}")
        return 0
    if args.compressible:
        generate_compressible_file(args.size_mb, args.output)
    else:
        generate_random_file(args.size_mb, args.output)
    print(f"Generated: {os.path.abspath(args.output)}")
    return 0


def cmd_ui(args) -> int:
    """Interactive terminal app: the reference's 4-view windowed application
    (Dashboard/Compress/Benchmark/Settings) as a curses TUI."""
    from .ui.app import run_app

    return run_app()


def cmd_dashboard(args) -> int:
    from .ui import export_html, render_dashboard

    print(render_dashboard())
    if args.html:
        export_html(args.html, theme=args.theme)
        print(f"HTML report written to {args.html}")
    return 0


def cmd_devices(args) -> int:
    for line in get_available_devices():
        print(line)
    return 0


TEMPLATE_TOML = """\
# datacomp-tpu (PyTorch/CUDA port) configuration (all keys optional; defaults shown)
[datacomp.compression]
chunk-size-mb = 16
cpu-threads = 0            # 0 = auto (clamp(cores, 2, 8))
use-memory-mapped-io = true
subblock-symbols = 4032    # v2 gap-array granularity (divisible by 32 and by 2-4)
format-version = 1         # 1 = reference-bit-compatible, 2 = +gap arrays
codebook-mode = "java"     # java | fast | device
max-code-len = 0           # 0 = unlimited (v1) / auto (v2); "auto" = shallowest
                           # cap costing <0.5% bits; N caps at N bits; 32 = opt out

[datacomp.device]
force-cpu = false          # the host codec instead of the GPU service
platform = "any"           # any (a CUDA device) | cpu (the kernels' plain PyTorch versions)
device-index = -1          # -1 = auto (cuda:LOCAL_RANK under torchrun, else cuda:0;
                           # a lone --sharded process: every visible card)
fallback-on-error = false  # must stay false: no host redo of a failed GPU call (true is refused)
parallel-chunks = 3
batch-chunks = 0           # 0 = auto (4 on a CUDA device, 1 on the CPU), else 1..16

[datacomp.benchmark]
warmup-iterations = 3
measurement-iterations = 5
detailed-profiling = false # torch.profiler trace of the measured compresses

[datacomp.logging]
level = "INFO"
metrics-enabled = true
file-path = ""

[datacomp.output]
verify-after-compress = true
"""


def cmd_config(args) -> int:
    """Settings surface (replaces the reference's JavaFX Settings view)."""
    if args.init:
        path = args.init
        if os.path.exists(path) and not args.force:
            print(f"error: {path} exists (use --force to overwrite)", file=sys.stderr)
            return 1
        with open(path, "w") as f:
            f.write(TEMPLATE_TOML)
        print(f"Wrote config template to {path}")
        return 0
    import dataclasses

    cfg = load_config(args.file)
    for section in ("compression", "device", "benchmark", "logging", "output"):
        print(f"[{section}]")
        for fld in dataclasses.fields(getattr(cfg, section)):
            print(f"  {fld.name} = {getattr(getattr(cfg, section), fld.name)!r}")
    return 0


def cmd_stats(args) -> int:
    """This process's recorded operations: a fresh process has none."""
    recent = MetricsService.get_instance().get_recent()
    if not recent:
        print("No operations recorded in this session")
        return 0
    for m in recent:
        print(
            f"{m.file_name}: {m.operation.value} {m.original_size:,} B "
            f"@ {m.throughput_mbps:.1f} MB/s [{m.backend}]"
        )
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dcz-torch",
        description="datacomp-tpu on PyTorch/CUDA: chunked canonical-Huffman compression",
    )
    sub = p.add_subparsers(dest="command", required=True)
    sharded_help = ("share the file's chunks among the ranks of a torchrun job, one "
                    "GPU a rank (cuda:LOCAL_RANK unless device.device_index is set), "
                    "or among every visible GPU of a lone process")

    def common(sp, output=True):
        sp.add_argument("input")
        if output:
            sp.add_argument("output")
        sp.add_argument("chunk_mb", nargs="?", type=int, default=16,
                        help="chunk size in MB (default 16)")
        sp.add_argument("--backend", choices=["auto", "cpu", "gpu"], default="auto",
                        help="cpu = the host codec, gpu = the GPU service (no CUDA "
                             "device: an error, unless device.platform is cpu), auto = "
                             "as the config selects (device.force_cpu)")
        sp.add_argument("--stages", action="store_true", help="print per-stage timing")

    sp = sub.add_parser("compress", aliases=["c"], help="compress a file")
    common(sp)
    sp.add_argument("--format", type=int, choices=[1, 2], default=None,
                    help="container version: 1=reference-compatible, 2=+gap arrays "
                         "(device decode); default 1, or 2 under --sharded")
    sp.add_argument("--no-verify", action="store_true",
                    help="skip the post-compress integrity verification")
    sp.add_argument("--max-code-len", default=0, metavar="N|auto",
                    type=lambda s: -1 if s.strip().lower() == "auto" else int(s),
                    help="cap code lengths at N bits via optimal package-merge "
                         "(0 = unlimited [v1 default]; 'auto' = shallowest cap "
                         "costing <0.5%% extra bits [v2 default]; <=16 keeps "
                         "v2 decode on-device)")
    sp.add_argument("--codebook-mode", choices=["java", "fast", "device"], default=None,
                    help="java = reference-bit-exact tie-breaks (default), "
                         "fast = two-queue optimal, device = histogram, codebook "
                         "and encode all on the GPU: optimal codes with no length "
                         "cap (the config's max_code_len is ignored), so v2 files "
                         "differ from the host codec's capped ones; default java, "
                         "or device under --sharded")
    sp.add_argument("--sharded", action="store_true", help=sharded_help)
    sp.set_defaults(func=cmd_compress)

    sp = sub.add_parser("decompress", aliases=["d"], help="decompress a .dcz file")
    common(sp)
    sp.add_argument("--sharded", action="store_true", help=sharded_help)
    sp.set_defaults(func=cmd_decompress)

    sp = sub.add_parser("verify", help="verify container integrity")
    common(sp, output=False)
    sp.add_argument("--deep", action="store_true", help="full decode + checksum check")
    sp.set_defaults(func=cmd_verify)

    sp = sub.add_parser("resume", help="resume an interrupted compression")
    common(sp)
    sp.add_argument("--last-chunk", type=int, required=True,
                    help="highest chunk index known completed (-1 restarts)")
    sp.set_defaults(func=cmd_resume)

    sp = sub.add_parser("bench", help="run the CPU-vs-GPU benchmark suite")
    sp.add_argument("--input", default=None, help="benchmark input file (default: generated)")
    sp.add_argument("--size-mb", type=int, default=16)
    sp.add_argument("--format-out", choices=["console", "json", "csv"], default="console")
    sp.add_argument("--kernels", action="store_true",
                    help="time the device kernels (device time by CUDA-graph replay, "
                         "call time by events) instead of the services; needs a CUDA device")
    sp.add_argument("--batched", action="store_true",
                    help="time the batched device calls (B=1/4/8 chunks a call); "
                         "needs a CUDA device")
    sp.add_argument("--kind", default="text",
                    choices=["text", "compressible", "skewed", "random"],
                    help="data kind for --kernels and --batched (default text)")
    sp.add_argument("--corpus", default=None, metavar="DIR",
                    help="benchmark every file in DIR: per-file ratio vs the "
                         "reference's published per-type table + entropy bound")
    sp.add_argument("--corpus-backend", choices=["cpu", "gpu"], default="cpu")
    sp.set_defaults(func=cmd_bench)

    sp = sub.add_parser("gen", help="generate deterministic test data")
    sp.add_argument("size_mb", type=int)
    sp.add_argument("output")
    sp.add_argument("--compressible", action="store_true")
    sp.add_argument("--corpus", action="store_true",
                    help="treat OUTPUT as a directory; write the Silesia-style "
                         "mixed corpus scaled to SIZE_MB total")
    sp.set_defaults(func=cmd_gen)

    sp = sub.add_parser("stats", help="show session metrics")
    sp.set_defaults(func=cmd_stats)

    sp = sub.add_parser("ui", help="interactive terminal app (4 views: "
                                   "dashboard/compress/benchmark/settings)")
    sp.set_defaults(func=cmd_ui)

    sp = sub.add_parser("dashboard", help="system/device info + metrics dashboard")
    sp.add_argument("--html", default=None, help="also write an HTML report here")
    sp.add_argument("--theme", choices=["dark", "light", "auto"], default="dark",
                    help="HTML report theme (auto follows prefers-color-scheme)")
    sp.set_defaults(func=cmd_dashboard)

    sp = sub.add_parser("devices", help="enumerate CUDA devices")
    sp.set_defaults(func=cmd_devices)

    sp = sub.add_parser("config", help="show effective configuration / write a template")
    sp.add_argument("--file", default=None, help="config file to load")
    sp.add_argument("--init", default=None, metavar="PATH",
                    help="write a commented datacomp.toml template to PATH")
    sp.add_argument("--force", action="store_true")
    sp.set_defaults(func=cmd_config)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .utils.logging_setup import setup_logging

    setup_logging()
    try:
        return args.func(args)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except Exception as e:  # noqa: BLE001 — the CLI boundary reports and exits
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
