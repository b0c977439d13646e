"""Interactive terminal application — the reference's windowed app, the port
of ``datacomp_tpu/ui/app.py``.

Four views with the same responsibilities as the JavaFX app
(``ui/DataCompApp.java`` + ``MainViewController`` navigation between
``ui/{Dashboard,Compress,Benchmark,Settings}Controller``):

* **Dashboard** — system/device info, recent ops, throughput sparkline
  (live via the MetricsService listener, like ``DashboardController:70``);
* **Compress** — input/output fields, background compress/decompress with
  live progress %, MB/s and ETA (``CompressController:257-269``), stage
  breakdown after completion (``displayStageMetrics:491``);
* **Benchmark** — runs the port's suite (host codec against the GPU
  service) in a worker thread, shows the comparison
  (``BenchmarkController.handleRunBenchmark:66``);
* **Settings** — edit chunk size / format / codebook mode / backend and
  persist to ``datacomp.toml`` (the reference's Settings view was in-memory
  only, ``SettingsController:25``).

The view renderers are pure (state → list[str]) and the key handler is a
plain state machine, so everything is unit-testable without a TTY; a thin
curses driver (``run_app``) does the painting.  Backends: ``auto`` (the
factory's rule), ``cpu`` (the host codec) and ``gpu`` (the GPU service,
which raises without a CUDA device unless ``device.platform=cpu``).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

from ..config import load_config
from ..models import MetricsService
from .dashboard import render_dashboard, sparkline

VIEWS = ("Dashboard", "Compress", "Benchmark", "Settings")

SETTINGS_FIELDS = [
    ("chunk_size_mb", "Chunk size (MB)", ("1", "4", "8", "16", "32", "64")),
    ("format_version", "Container format", ("1", "2")),
    ("codebook_mode", "Codebook mode", ("java", "fast", "device")),
    ("backend", "Backend", ("auto", "cpu", "gpu")),
    ("theme", "Theme", ("dark", "light")),
]


@dataclass
class OpStatus:
    running: bool = False
    label: str = ""
    frac: float = 0.0
    started: float = 0.0
    total_bytes: int = 0
    message: str = ""
    stages: str = ""


@dataclass
class AppState:
    view: int = 0
    quit: bool = False
    # compress view
    input_path: str = ""
    output_path: str = ""
    field_focus: int = 0  # 0=input, 1=output
    op: OpStatus = field(default_factory=OpStatus)
    # benchmark view
    bench_running: bool = False
    bench_text: str = ""
    # settings view
    settings: dict = field(
        default_factory=lambda: {
            "chunk_size_mb": "16",
            "format_version": "2",
            "codebook_mode": "java",
            "backend": "auto",
            "theme": "dark",
        }
    )
    settings_focus: int = 0
    settings_saved: str = ""


def _auto_output(path: str) -> str:
    """Derive the output path like the reference's auto-fill
    (``CompressController:184-203``): append .dcz, or strip it."""
    if path.endswith(".dcz"):
        return path[: -len(".dcz")] + ".out"
    return path + ".dcz"


def _make_service(state: AppState):
    comp = {
        "chunk_size_mb": int(state.settings["chunk_size_mb"]),
        "format_version": int(state.settings["format_version"]),
        "codebook_mode": state.settings["codebook_mode"],
    }
    cfg = load_config(compression=comp)
    backend = state.settings["backend"]
    if backend == "cpu":
        from ..services import CpuCompressionService

        return CpuCompressionService(cfg)
    if backend == "gpu":
        from ..services import GpuCompressionService

        return GpuCompressionService(cfg)
    from ..services import create_compression_service

    return create_compression_service(cfg)


def start_operation(state: AppState, decompress: bool = False) -> Optional[threading.Thread]:
    """Kick off compress/decompress on a worker thread (the reference runs a
    javafx Task, ``CompressController:249-314``).  Returns the thread."""
    if state.op.running:
        return None
    src = os.path.expanduser(state.input_path.strip())
    if not src or not os.path.isfile(src):
        state.op.message = f"input not found: {src or '(empty)'}"
        return None
    dst = os.path.expanduser(state.output_path.strip()) or _auto_output(src)
    state.output_path = dst
    op = state.op = OpStatus(
        running=True,
        label="Decompressing" if decompress else "Compressing",
        started=time.perf_counter(),
        total_bytes=os.path.getsize(src),
    )

    def progress(frac: float) -> None:
        op.frac = frac

    def work() -> None:
        svc = None
        try:
            svc = _make_service(state)
            if decompress:
                svc.decompress(src, dst, progress)
            else:
                svc.compress(src, dst, progress)
            out_size = os.path.getsize(dst)
            dt = time.perf_counter() - op.started
            ratio = ""
            if not decompress and op.total_bytes:
                ratio = f", ratio {out_size / op.total_bytes * 100:.1f}%"
            op.message = (
                f"done: {out_size:,} B in {dt:.2f}s "
                f"({op.total_bytes / 1e6 / max(dt, 1e-9):.1f} MB/s{ratio})"
            )
            op.stages = svc.get_last_stage_metrics().summary()
        except Exception as e:  # noqa: BLE001 — the view reports the error
            op.message = f"error: {e}"
        finally:
            op.running = False
            if svc is not None:
                svc.close()

    t = threading.Thread(target=work, daemon=True)
    t.start()
    return t


def start_benchmark(state: AppState) -> Optional[threading.Thread]:
    if state.bench_running:
        return None
    state.bench_running = True
    state.bench_text = "running benchmark suite…"

    def work() -> None:
        try:
            from ..benchmark.suite import BenchmarkSuite

            cfg = load_config(
                compression={"chunk_size_mb": int(state.settings["chunk_size_mb"])},
                benchmark={"warmup_iterations": 1, "measurement_iterations": 2},
            )
            suite = BenchmarkSuite(cfg)
            results = suite.run_full_suite(size_mb=8)
            state.bench_text = suite.format_results(results, "console")
        except Exception as e:  # noqa: BLE001 — the view reports the error
            state.bench_text = f"benchmark failed: {e}"
        finally:
            state.bench_running = False

    t = threading.Thread(target=work, daemon=True)
    t.start()
    return t


def save_settings(state: AppState, path: str = "datacomp.toml") -> None:
    """Persist the Settings view to TOML (the reference never persisted,
    ``SettingsController:25`` — parity+)."""
    body = (
        "[datacomp.compression]\n"
        f"chunk-size-mb = {int(state.settings['chunk_size_mb'])}\n"
        f"format-version = {int(state.settings['format_version'])}\n"
        f"codebook-mode = \"{state.settings['codebook_mode']}\"\n"
    )
    with open(path, "w") as f:
        f.write(body)
    state.settings_saved = f"saved to {os.path.abspath(path)}"


# ---------------------------------------------------------------------------
# Pure view renderers
# ---------------------------------------------------------------------------


def _bar(frac: float, width: int = 40) -> str:
    done = int(frac * width)
    return "[" + "#" * done + "-" * (width - done) + f"] {int(frac * 100):3d}%"


def render_compress(state: AppState, width: int = 78) -> List[str]:
    op = state.op
    mark = ["  ", "  "]
    mark[state.field_focus] = "> "
    lines = [
        "Compress / Decompress",
        "-" * width,
        f"{mark[0]}Input : {state.input_path or '(type a path, TAB switches fields)'}",
        f"{mark[1]}Output: {state.output_path or '(auto: input + .dcz)'}",
        "",
        "ENTER = compress   d = decompress   TAB = switch field",
    ]
    if op.running or op.frac > 0:
        elapsed = time.perf_counter() - op.started if op.started else 0.0
        line = f"{op.label}: {_bar(op.frac)}"
        if op.total_bytes and op.frac > 0 and elapsed > 0.05:
            mbps = op.frac * op.total_bytes / 1e6 / elapsed
            remaining = elapsed * (1 - op.frac) / max(op.frac, 1e-9)
            line += f"  {mbps:7.1f} MB/s  ETA {int(remaining) // 60}:{int(remaining) % 60:02d}"
        lines += ["", line]
    if op.message:
        lines += ["", op.message]
    if op.stages and not op.running:
        lines += [""] + op.stages.splitlines()
    return lines


def render_benchmark(state: AppState, width: int = 78) -> List[str]:
    lines = ["Benchmark", "-" * width, "ENTER = run suite (8 MB generated file)"]
    if state.bench_running:
        lines += ["", "… running (the kernels build on first use)"]
    if state.bench_text:
        lines += [""] + state.bench_text.splitlines()
    return lines


def render_settings(state: AppState, width: int = 78) -> List[str]:
    lines = [
        "Settings",
        "-" * width,
        "UP/DOWN = field   LEFT/RIGHT = value   s = save to datacomp.toml",
        "",
    ]
    for i, (key, label, choices) in enumerate(SETTINGS_FIELDS):
        mark = "> " if i == state.settings_focus else "  "
        val = state.settings[key]
        opts = "  ".join(f"[{c}]" if c == val else c for c in choices)
        lines.append(f"{mark}{label:<18} {opts}")
    if state.settings_saved:
        lines += ["", state.settings_saved]
    return lines


def render_view(state: AppState, width: int = 78) -> List[str]:
    tabs = "  ".join(
        (f"[{i + 1}:{name}]" if i == state.view else f" {i + 1}:{name} ")
        for i, name in enumerate(VIEWS)
    )
    header = ["datacomp-tpu (PyTorch/CUDA) — " + tabs + "   (q quits)", "=" * width]
    if state.view == 0:
        ms = MetricsService.get_instance()
        body = render_dashboard(ms).splitlines()
        tp = [m.throughput_mbps for m in ms.get_recent()]
        if tp:
            body.append("live: " + sparkline(tp))
    elif state.view == 1:
        body = render_compress(state, width)
    elif state.view == 2:
        body = render_benchmark(state, width)
    else:
        body = render_settings(state, width)
    return header + body


# ---------------------------------------------------------------------------
# Key handling (plain state machine — no curses dependency)
# ---------------------------------------------------------------------------

KEY_UP, KEY_DOWN, KEY_LEFT, KEY_RIGHT, KEY_TAB, KEY_ENTER, KEY_BACKSPACE = (
    "UP", "DOWN", "LEFT", "RIGHT", "TAB", "ENTER", "BACKSPACE",
)


def handle_key(state: AppState, key) -> AppState:
    """Apply one key press.  ``key`` is a single character or one of the
    KEY_* tokens."""
    if key == "q" and state.view != 1:
        state.quit = True
        return state
    if isinstance(key, str) and len(key) == 1 and key in "1234":
        state.view = int(key) - 1
        return state
    if state.view == 1:  # compress
        if key == KEY_TAB:
            state.field_focus ^= 1
        elif key == KEY_ENTER:
            start_operation(state, decompress=False)
        elif key == "d" and not state.op.running:
            start_operation(state, decompress=True)
        elif key == KEY_BACKSPACE:
            if state.field_focus == 0:
                state.input_path = state.input_path[:-1]
            else:
                state.output_path = state.output_path[:-1]
        elif key == "q":
            state.quit = True
        elif isinstance(key, str) and len(key) == 1 and key.isprintable():
            if state.field_focus == 0:
                state.input_path += key
            else:
                state.output_path += key
    elif state.view == 2:  # benchmark
        if key == KEY_ENTER:
            start_benchmark(state)
    elif state.view == 3:  # settings
        nf = len(SETTINGS_FIELDS)
        if key == KEY_UP:
            state.settings_focus = (state.settings_focus - 1) % nf
        elif key == KEY_DOWN:
            state.settings_focus = (state.settings_focus + 1) % nf
        elif key in (KEY_LEFT, KEY_RIGHT):
            fkey, _, choices = SETTINGS_FIELDS[state.settings_focus]
            cur = choices.index(state.settings[fkey]) if state.settings[fkey] in choices else 0
            step = 1 if key == KEY_RIGHT else -1
            state.settings[fkey] = choices[(cur + step) % len(choices)]
            state.settings_saved = ""
        elif key == "s":
            save_settings(state)
    return state


# ---------------------------------------------------------------------------
# Curses driver
# ---------------------------------------------------------------------------


def run_app() -> int:
    """Run the interactive terminal app (``dcz ui``)."""
    import curses

    state = AppState()

    def main(scr):
        curses.curs_set(0)
        scr.timeout(120)  # repaint for live progress
        keymap = {
            curses.KEY_UP: KEY_UP,
            curses.KEY_DOWN: KEY_DOWN,
            curses.KEY_LEFT: KEY_LEFT,
            curses.KEY_RIGHT: KEY_RIGHT,
            9: KEY_TAB,
            10: KEY_ENTER,
            13: KEY_ENTER,
            curses.KEY_BACKSPACE: KEY_BACKSPACE,
            127: KEY_BACKSPACE,
        }
        while not state.quit:
            h, w = scr.getmaxyx()
            scr.erase()
            for y, line in enumerate(render_view(state, width=min(w - 1, 100))):
                if y >= h - 1:
                    break
                scr.addnstr(y, 0, line, w - 1)
            scr.refresh()
            ch = scr.getch()
            if ch == -1:
                continue
            key = keymap.get(ch)
            if key is None and 32 <= ch < 127:
                key = chr(ch)
            if key is not None:
                handle_key(state, key)
        return 0

    return curses.wrapper(main)
