"""One run of one cell: set-up, the measured window, the judge, one result line.

    python -m dczbench --workload fast-v2.silesia --seed 7 --seconds 12 --trace 0

The cell's configuration and traffic are files found by name from
``BENCHMARK.json``: ``dczbench/configs/<config>.json`` and
``dczbench/traffic/<traffic>.json``; its per-layer metrics are readers found
by name in ``dczbench/metrics/``.  The run drives the port's own service,
``datacomp_tpu_torch``'s ``GpuCompressionService``, in this process:
``compress`` of each file of the traffic's request list, then ``decompress``
of its ``.dcz``, back to back, on real files under ``TMPDIR``; the window is
that list, closed early only if ``--seconds`` runs out first.  ``--trace 0``
prints the cell's end-to-end metrics (under a ``torch.profiler`` trace of
the window where one of them is read from the device's trace), ``--trace 1``
its per-layer metrics from such a trace.  ``--control`` runs the
configuration's control (the program with one of its guarantees broken),
which the judge must find incorrect.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import host

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
#: top-level modules that must not be loaded by the run
FORBIDDEN = ("jax", "jaxlib", "flax", "datacomp_tpu")


def log(msg: str) -> None:
    print(f"dczbench: {msg}", file=sys.stderr, flush=True)


# -- the cell ------------------------------------------------------------------


def load_cell(workload: str, root: str = ROOT) -> tuple:
    """(benchmark, cell, configuration, traffic) of ``workload``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, config["file"])) as f:
        config_doc = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return bench, cell, config_doc, traffic


def per_layer_metrics(bench: dict, workload: str) -> list:
    """The per-layer metrics that list this cell."""
    return [m for m in bench["per_layer"] if workload in m["workloads"]]


def end_to_end_metrics(bench: dict, workload: str) -> list:
    return [m for m in bench["end_to_end"] if workload in m.get("workloads", (workload,))]


def kernel_ms_per_gb(tr, in_bytes: int):
    """The device's kernel time in the traced window (memory copies and sets
    left out), ms per GB (1e9 bytes) of input served; None with no kernel."""
    t = tr.device_s(category="kernel") if tr is not None and in_bytes else 0.0
    return t * 1e3 / (in_bytes / 1e9) if t > 0 else None


def service_config(config_doc: dict, control: bool):
    """The program's AppConfig from the configuration's keys (and, for the
    control, its control's keys on top)."""
    from datacomp_tpu_torch.config import load_config

    sections = {k: dict(config_doc.get(k, {})) for k in ("compression", "device")}
    if control:
        for k in sections:
            sections[k].update(config_doc["control"].get(k, {}))
    return load_config(**sections)


# -- traffic -------------------------------------------------------------------


def schedule(traffic: dict) -> list:
    """The file index of each request of the window: the files in the
    table's order, round after round, for the traffic's ``rounds``."""
    return list(range(len(traffic["files"]))) * int(traffic["rounds"])


def container_subblock(compression) -> int:
    """The sub-block a container of the configuration records: its
    ``subblock_symbols`` in format 2, none (0) in format 1."""
    return compression.subblock_symbols if compression.format_version >= 2 else 0


def container_sizes(data, name: str, chunk_bytes: int, subblock: int, rule: str,
                    version: int = 2) -> tuple:
    """(bytes of the format-``version`` `.dcz`, bytes of its progress
    sidecar) of the file ``data``: each chunk's payload from its histogram
    and the codebook rule's lengths (in format 2 raw where coding does not
    shrink it), and the footer and sidecar from their fixed fields and gap
    arrays.  Format 1's footer has no sub-block field and its chunk records
    no gap count and no gap array; the sidecar's records always carry a gap
    count, and a gap array only in format 2."""
    from .reference import code_lengths

    v2 = version >= 2
    record = 4 + 8 + 4 + 8 + 4 + 32 + 512  # a chunk's fixed fields, digest and lengths
    payload = footer = sidecar = 0
    for off in range(0, data.size, chunk_bytes):
        x = data[off : off + chunk_bytes]
        hist = np.bincount(x, minlength=256)
        bits = int(hist @ code_lengths(hist, rule))
        raw = v2 and bits >= 8 * x.size
        payload += x.size if raw else (bits + 7) // 8
        gaps = 4 * -(-x.size // subblock) if v2 and not raw else 0
        footer += record + (4 + gaps if v2 else 0)
        sidecar += record + 4 + gaps
    head = 4 * 3 + len(name.encode()) + 8 + 8 + 4
    return payload + head + 32 + (4 if v2 else 0) + 4 + footer + 8, head + 4 + sidecar


def reckon_writes(traffic: dict, requests: list, sizes: list) -> dict:
    """Bytes the run writes: the corpus, a warm-up round, the window's
    requests, each its `.dcz` and sidecar (``sizes``, by file) and the
    restored file, and the judge's restore of one tampered `.dcz` (at most
    the largest file)."""
    files = traffic["files"]

    def request(i: int) -> int:
        return sum(sizes[i]) + int(files[i]["bytes"])

    corpus = sum(int(f["bytes"]) for f in files)
    setup = corpus + sum(request(i) for i in range(len(files)))
    window = sum(request(i) for i in requests)
    judged = max(int(f["bytes"]) for f in files)
    return {"setup": setup, "window": window, "judge": judged,
            "total": setup + window + judged, "cap": int(traffic["max_write_bytes"])}


# -- set-up --------------------------------------------------------------------


def write_corpus(workdir: str, traffic: dict, datas: list) -> tuple:
    """The files on disk, flushed, so that no write-back of theirs falls in
    the window; returns (paths, mtimes in ms)."""
    paths, mtimes = [], []
    for f, data in zip(traffic["files"], datas):
        path = os.path.join(workdir, f["name"])
        with open(path, "wb") as out:
            out.write(memoryview(data))
            out.flush()
            os.fsync(out.fileno())
        paths.append(path)
        mtimes.append(int(os.path.getmtime(path) * 1000))
    return paths, mtimes


def link_probe(torch, dev) -> dict:
    """Pageable copies of 64 MiB each way, the second of two (MB/s)."""
    n = 64 << 20
    src = torch.from_numpy(np.ones(n, np.uint8))
    rates = {}
    for _ in range(2):
        t = time.perf_counter()
        d = src.to(dev)
        torch.cuda.synchronize(dev)
        rates["h2d_MBps"] = round(n / 1e6 / (time.perf_counter() - t), 1)
        t = time.perf_counter()
        d.cpu()
        torch.cuda.synchronize(dev)
        rates["d2h_MBps"] = round(n / 1e6 / (time.perf_counter() - t), 1)
    return rates


def remove(*paths) -> None:
    for p in paths:
        try:
            os.remove(p)
        except FileNotFoundError:
            pass


# -- the run -------------------------------------------------------------------


class Served:
    """The window's requests: times, stage sums and captured outputs."""

    def __init__(self):
        self.compress_s = self.restore_s = 0.0
        self.in_bytes = self.out_bytes = 0
        self.stage_ms = {"compress": {}, "restore": {}}
        self.captures: list = []  # (file index, capture or None)
        self.times: list = []  # (file index, compress s, restore s)
        self.failed = 0

    def add_stages(self, phase: str, metrics) -> None:
        for stage, v in metrics.as_dict().items():
            self.stage_ms[phase][stage] = self.stage_ms[phase].get(stage, 0.0) + v["ms"]


def serve(svc, paths: list, requests: list, workdir: str, mark, served: Served | None,
          capture, seconds: float = float("inf"), keep: int = -1) -> float:
    """Serve ``requests`` (file indices) back to back, each timed from its
    start, starting none once ``seconds`` have passed; the ``.dcz`` of
    request ``keep`` stays as ``kept.dcz``.  Returns the window's seconds."""
    t0 = time.perf_counter()
    for k, i in enumerate(requests):
        start = time.perf_counter()
        if start - t0 >= seconds:
            log(f"--seconds ran out after {k} of {len(requests)} requests")
            break
        dcz = os.path.join(workdir, f"req{k}.dcz")
        back = os.path.join(workdir, f"req{k}.out")
        got = None
        try:
            with mark("compress"):
                svc.compress(paths[i], dcz)
            done_c = time.perf_counter()
            if served is not None:
                served.add_stages("compress", svc.get_last_stage_metrics())
            restored = None
            try:
                with mark("restore"):
                    svc.decompress(dcz, back)
                restored = back
            except Exception:  # noqa: BLE001 - a failed restore is counted, the run goes on
                log(f"request {k} restore failed: {traceback.format_exc(limit=3)}")
            done_r = time.perf_counter()
            if served is not None:
                served.add_stages("restore", svc.get_last_stage_metrics())
                got = capture(dcz, restored)
                if restored is None:
                    got["failed"] = True
                    served.failed += 1
        except Exception:  # noqa: BLE001 - a failed compress is counted, the run goes on
            log(f"request {k} compress failed: {traceback.format_exc(limit=3)}")
            done_c = done_r = time.perf_counter()
            if served is not None:
                served.failed += 1
        if served is not None:
            size = os.path.getsize(paths[i])
            served.times.append((i, done_c - start, done_r - done_c))
            served.compress_s += done_c - start
            served.restore_s += done_r - done_c
            served.in_bytes += size
            served.out_bytes += size
            served.captures.append((i, got))
        if k == keep and os.path.exists(dcz):
            os.replace(dcz, os.path.join(workdir, "kept.dcz"))
        remove(dcz, back, dcz + ".partial")
    return time.perf_counter() - t0


def run_cell(workload: str, bench: dict, config_doc: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, device: str = "cuda", control: bool = False) -> dict:
    """Set-up, window and judge of one run; returns the result line's dict
    (the ``checks`` key last)."""
    import torch

    from datacomp_tpu_torch import ops
    from datacomp_tpu_torch.services import gpu_service
    from datacomp_tpu_torch.services.gpu_service import GpuCompressionService

    from . import corpus, judge, readers
    from .reference import expected_file

    marks = {"imports": host.process_age_s()}
    cfg = service_config(config_doc, control)
    chunk_bytes = cfg.chunk_size_bytes
    version = cfg.compression.format_version
    # the traffic is laid out in the configured sub-blocks whatever the
    # format, so every format serves the same bytes for a seed
    subblock = cfg.compression.subblock_symbols
    stored_subblock = container_subblock(cfg.compression)
    requests = schedule(traffic)
    # the request whose `.dcz` the judge restores with one stored digest flipped
    judge_rng = np.random.default_rng([seed, 1])
    keep = int(judge_rng.integers(len(traffic["files"])))
    log(f"{workload} seed {seed}: {len(requests)} requests back to back, at most {seconds} s"
        f"{' (control: ' + config_doc['control']['why'] + ')' if control else ''}")
    datas = corpus.make_corpus(traffic, seed, chunk_bytes, subblock)
    marks["corpus_made"] = host.process_age_s()
    sizes = [container_sizes(d, f["name"], chunk_bytes, stored_subblock,
                             config_doc["codebook_rule"], version)
             for d, f in zip(datas, traffic["files"])]
    writes = reckon_writes(traffic, requests, sizes)
    log(f"reckoned writes {writes}")
    if writes["total"] > writes["cap"]:
        raise SystemExit(f"the run would write {writes['total']} bytes, over its cap "
                         f"{writes['cap']}: serve fewer rounds")
    io_start = host.io_bytes()
    workdir = tempfile.mkdtemp(prefix="dczbench-")
    log(f"files under {workdir} ({host.fs_of(workdir)})")
    cuda = device == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    try:
        svc = GpuCompressionService(cfg, device=str(dev))
        if not svc.is_available():
            raise RuntimeError("the service's device probe failed")
        marks["service"] = host.process_age_s()
        paths, mtimes = write_corpus(workdir, traffic, datas)
        marks["corpus_written"] = host.process_age_s()
        if cuda:
            log(f"link probe, pageable 64 MiB: {link_probe(torch, dev)}")
        # warm-up: every file once, so every shape the window uses is built
        serve(svc, paths, list(range(len(paths))), workdir, _no_mark, None, None)
        ops.reset_counters()
        gpu_service.host_encode_routes.reset()
        gpu_service.host_decode_routes.reset()
        # the program's set-up ends here; the host probe and the profiler's
        # start are the harness's own, and a cell's trace-0 run starts the
        # profiler only where an end-to-end metric is read from the trace
        setup_s = host.process_age_s()
        marks["warmed_up"] = setup_s
        facts = host.Facts(_smi_index() if cuda else None)
        e2e = end_to_end_metrics(bench, workload)
        traced = trace or any(m["source"] == "device_trace" for m in e2e)
        profiler = _profiler(torch, cuda, host_side=trace) if traced else None
        if profiler is not None:
            profiler.start()
        mark = torch.profiler.record_function if trace else _no_mark
        served = Served()
        marks["window"] = host.process_age_s()
        with mark("window"):
            window_s = serve(svc, paths, requests, workdir, mark, served, judge.capture,
                             seconds, keep)
        if cuda:
            torch.cuda.synchronize(dev)
        tr = None
        if profiler is not None:
            profiler.stop()
            trace_path = os.path.join(workdir, "trace.json")
            profiler.export_chrome_trace(trace_path)
            from .trace import Trace

            tr = Trace(trace_path)
            remove(trace_path)
        moved = facts.finish()
        memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        counts = {op: [a.value, b.value] for op, (a, b) in ops.COUNTERS.items()
                  if a.value or b.value}
        counts["host_routes"] = [gpu_service.host_encode_routes.value,
                                 gpu_service.host_decode_routes.value]
        faults_verify = judge.verify_faults(svc.decompress, os.path.join(workdir, "kept.dcz"),
                                            os.path.join(workdir, "kept.out"), judge_rng)
        svc.close()
        del svc
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # -- judge: the plain reference over each distinct file, after the window
        t_judge = time.perf_counter()
        rule = config_doc["codebook_rule"]
        with ThreadPoolExecutor(max_workers=max(1, min(8, len(os.sched_getaffinity(0))))) as pool:
            expected = [expected_file(d, chunk_bytes, rule, stored_subblock, pool, version)
                        for d in datas]
        faults = judge.judge(served.captures, expected, [f["name"] for f in traffic["files"]],
                             mtimes, version)
        faults["verify_faults"] = faults_verify
        judged_s = time.perf_counter() - t_judge
        del datas
        work = fingerprint(served, counts)
        log(f"work fingerprint {work}")
        log(f"{len(served.captures)} requests in {window_s:.3f} s, set-up {setup_s:.3f} s "
            f"(process age at {json.dumps({k: round(v, 3) for k, v in marks.items()})}), "
            f"judged in {judged_s:.3f} s")
        log(f"host facts over the window {json.dumps(moved)}")
        log(f"MB/s by file, compress / restore {by_file(served, traffic)}")
        log("request seconds, compress / restore "
            f"{[[round(c, 4), round(r, 4)] for _, c, r in served.times]}")
        log(f"compress stage ms summed {served.stage_ms['compress']}")
        log(f"restore stage ms summed {served.stage_ms['restore']}")

        device_info = {"platform": "gpu" if cuda else "cpu",
                       "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                       "count": 1, "memory_peak_bytes": int(memory_peak)}
        result = {"correct": not any(faults.values()), "attempted": len(served.captures),
                  "failed": served.failed}
        if trace:
            window = readers.Window(stage_ms=served.stage_ms,
                                    phase_bytes={"compress": served.in_bytes,
                                                 "restore": served.out_bytes},
                                    phase_s={"compress": served.compress_s,
                                             "restore": served.restore_s},
                                    chunks=[c for i, _ in served.captures
                                            for c in expected[i]["chunks"]],
                                    trace=tr)
            metrics = {}
            for m in per_layer_metrics(bench, workload):
                value = readers.load(m["name"])(window)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            result["metrics"] = metrics
            device_info.update(busy_s=tr.busy_s() if tr else 0.0,
                               window_s=tr.window_s() if tr else window_s)
            result["device"] = device_info
            if tr is not None:
                result["breakdown"] = {"device_ops": tr.top_device_ops(),
                                       "idle_gaps": tr.idle_gaps()}
        else:
            values = {"compress_MBps": served.in_bytes / 1e6 / served.compress_s,
                      "decompress_MBps": served.out_bytes / 1e6 / served.restore_s,
                      "setup_s": setup_s,
                      "kernel_ms_per_GB": kernel_ms_per_gb(tr, served.in_bytes)}
            units = {m["name"]: m["unit"] for m in e2e}
            result["metrics"] = {k: {"value": values[k], "unit": u} for k, u in units.items()
                                 if values.get(k) is not None}
            result["device"] = device_info
        io_end = host.io_bytes()
        log("this run wrote "
            f"{ {k: io_end.get(k, 0) - io_start.get(k, 0) for k in io_end} } bytes "
            f"(/proc/self/io), reckoned at most {writes['total']}")
        result["work"] = work
        result["checks"] = {k: {"value": v, "limit": 0} for k, v in faults.items()}
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def fingerprint(served: Served, counts: dict) -> dict:
    """The window's work, equal for every seed: bytes in and out, raw chunks,
    coded chunks by depth, and kernel launches and plain calls by op."""
    depths: dict = {}
    raw = comp = 0
    for _, got in served.captures:
        if got is None or "error" in got["container"]:
            continue
        for c in got["container"]["chunks"]:
            comp += c["size"]
            d = int(c["lengths"].max())
            if d == 0:
                raw += 1
            else:
                depths[d] = depths.get(d, 0) + 1
    return {"requests": len(served.captures), "input_bytes": served.in_bytes,
            "compressed_bytes": comp, "raw_chunks": raw,
            "chunks_by_depth": dict(sorted(depths.items())), "launches_and_plain_calls": counts}


def by_file(served: Served, traffic: dict) -> dict:
    """Each file's compress and restore MB/s over its requests."""
    out = {}
    for i, f in enumerate(traffic["files"]):
        mine = [(c, r) for j, c, r in served.times if j == i]
        if mine:
            mb = int(f["bytes"]) * len(mine) / 1e6
            out[f["name"]] = [round(mb / sum(c for c, _ in mine), 1),
                              round(mb / sum(r for _, r in mine), 1)]
    return out


def _smi_index() -> int:
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    return int(first) if first.isdigit() else 0


def _no_mark(_name: str):
    return contextlib.nullcontext()


def _profiler(torch, cuda: bool, host_side: bool = True):
    """The window's profiler; without ``host_side`` it records the device's
    operations alone (all a trace-0 run reads from it)."""
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CPU] if host_side or not cuda else []) + \
        ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts, acc_events=True)


# -- entry ---------------------------------------------------------------------


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m dczbench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="run the configuration's control, which must come out incorrect")
    return p.parse_args(argv)


def main(argv=None) -> int:
    ages = {"main": host.process_age_s()}
    args = parse_args(argv)
    bench, cell, config_doc, traffic = load_cell(args.workload)
    binding = host.bind_to_card()
    log(f"host: {host.cpu_model()}; card {binding['card']} on NUMA node "
        f"{binding['numa_node']}; {binding['how']}: cores {binding['cores']} "
        f"(given {binding['given']})")
    import torch

    ages["torch"] = host.process_age_s()
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"needs {cell['chips']} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}")
        return 1
    ages["cuda"] = host.process_age_s()
    card = host.card_readings(_smi_index())
    ages["nvidia_smi"] = host.process_age_s()
    ages = {k: round(v, 3) for k, v in ages.items()}
    log(f"card: {torch.cuda.get_device_name(0)}, {card}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; process age at {json.dumps(ages)}")
    result = run_cell(args.workload, bench, config_doc, traffic, args.seed, args.seconds,
                      bool(args.trace), control=args.control)
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: no result")
        return 1
    for name, c in result["checks"].items():
        log(f"check {name} = {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
