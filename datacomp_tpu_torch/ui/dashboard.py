"""Dashboard: system/device info, recent-operation stats and a throughput
sparkline — the port of ``datacomp_tpu/ui/dashboard.py``, the terminal/HTML
re-expression of the reference's JavaFX dashboard
(``ui/DashboardController.java``: system/GPU info panel, last-op stats,
10-row metrics table, throughput line chart fed by the MetricsService
listener).  The device lines read ``torch.cuda``; everything else is the JAX
package's, under the port's title."""

from __future__ import annotations

import html
import os
import platform
from typing import List, Optional

import torch

from ..models import CompressionMetrics, MetricsService

SPARK = "▁▂▃▄▅▆▇█"
TITLE = "datacomp-tpu (PyTorch/CUDA) dashboard"


def device_info_lines() -> List[str]:
    lines = [
        f"Host:      {platform.node()}  ({platform.system()} {platform.machine()})",
        f"Python:    {platform.python_version()}  CPUs: {os.cpu_count()}",
    ]
    if torch.cuda.is_available():
        count = torch.cuda.device_count()
        for i in range(min(count, 8)):
            p = torch.cuda.get_device_properties(i)
            lines.append(
                f"Device:    {p.name} (sm_{p.major}{p.minor}, {p.multi_processor_count} SMs, "
                f"{p.total_memory / 2**30:.1f} GiB, id={i})"
            )
        if count > 8:
            lines.append(f"           … and {count - 8} more")
    else:
        lines.append("Device:    no CUDA devices available")
    lines.append(f"Backend:   torch {torch.__version__}, CUDA {torch.version.cuda}")
    from .. import native

    if native.is_available():
        lines.append("Native:    C++ codec available")
    else:
        lines.append(f"Native:    C++ codec unavailable ({native.build_error()})")
    return lines


def sparkline(values: List[float], width: int = 40) -> str:
    if not values:
        return ""
    values = values[-width:]
    hi = max(values) or 1.0
    return "".join(SPARK[min(int(v / hi * (len(SPARK) - 1)), len(SPARK) - 1)] for v in values)


def _rows(metrics: List[CompressionMetrics], n: int = 10):
    return [
        (
            m.file_name[-28:],
            m.operation.value,
            f"{m.original_size / 1e6:.1f} MB",
            f"{m.throughput_mbps:.1f} MB/s",
            f"{m.compression_ratio * 100:.1f}%",
            m.backend,
        )
        for m in metrics[-n:]
    ]


def render_dashboard(service: Optional[MetricsService] = None) -> str:
    ms = service or MetricsService.get_instance()
    recent = ms.get_recent()
    out = [TITLE, "=" * 72]
    out += device_info_lines()
    out.append("-" * 72)
    last = ms.get_last()
    if last is None:
        out.append("No operations recorded this session.")
    else:
        out.append(
            f"Last op:   {last.operation.value} {last.file_name} "
            f"{last.original_size:,} B @ {last.throughput_mbps:.1f} MB/s [{last.backend}]"
        )
        out.append(
            f"Averages:  {ms.average_throughput_mbps():.1f} MB/s over {len(recent)} ops"
        )
        out.append("")
        out.append(f"{'file':<28} {'op':<14} {'size':>9} {'speed':>11} {'ratio':>7} {'dev':>4}")
        for r in _rows(recent):
            out.append(f"{r[0]:<28} {r[1]:<14} {r[2]:>9} {r[3]:>11} {r[4]:>7} {r[5]:>4}")
        tp = [m.throughput_mbps for m in recent]
        out.append("")
        out.append(f"Throughput history: {sparkline(tp)}")
    out.append("=" * 72)
    return "\n".join(out)


_THEME_DARK = "--bg:#14151a;--fg:#e6e6e6;--accent:#4a9eff;--border:#333"
_THEME_LIGHT = "--bg:#f7f7f5;--fg:#1a1a1a;--accent:#1761c7;--border:#c8c8c4"


def _theme_css(theme: str) -> str:
    """Dark / light / auto palettes (parity with the reference's
    ``dark-theme.css`` / ``light-theme.css`` pair and the Settings live theme
    switch, ``ui/SettingsController.java:222-245``)."""
    if theme == "light":
        return f":root{{{_THEME_LIGHT}}}"
    if theme == "auto":
        return (
            f":root{{{_THEME_LIGHT}}}"
            f"@media (prefers-color-scheme: dark){{:root{{{_THEME_DARK}}}}}"
        )
    return f":root{{{_THEME_DARK}}}"


def export_html(
    path: str, service: Optional[MetricsService] = None, theme: str = "dark"
) -> None:
    """Static HTML report (replaces the JavaFX charts with a self-contained
    page; no external assets).  ``theme``: dark | light | auto."""
    if theme not in ("dark", "light", "auto"):
        raise ValueError(f"unknown theme {theme!r} (dark|light|auto)")
    ms = service or MetricsService.get_instance()
    recent = ms.get_recent()
    rows = "".join(
        "<tr>" + "".join(f"<td>{html.escape(str(c))}</td>" for c in r) + "</tr>"
        for r in _rows(recent, n=50)
    )
    tp = [m.throughput_mbps for m in recent]
    hi = max(tp) if tp else 1.0
    bars = "".join(
        f'<div class="bar" style="height:{max(v / hi * 100, 2):.0f}%" title="{v:.1f} MB/s"></div>'
        for v in tp[-50:]
    )
    info = "<br>".join(html.escape(line) for line in device_info_lines())
    doc = f"""<!doctype html><html><head><meta charset="utf-8">
<title>{TITLE}</title><style>
{_theme_css(theme)}
body{{font-family:monospace;background:var(--bg);color:var(--fg);margin:2em}}
table{{border-collapse:collapse;width:100%}}td,th{{border:1px solid var(--border);padding:4px 8px}}
.chart{{display:flex;align-items:flex-end;height:120px;gap:2px;margin:1em 0}}
.bar{{flex:1;background:var(--accent);min-width:4px}}
h1{{color:var(--accent)}}</style></head><body>
<h1>{TITLE}</h1>
<p>{info}</p>
<div class="chart">{bars}</div>
<table><tr><th>file</th><th>op</th><th>size</th><th>speed</th><th>ratio</th><th>backend</th></tr>
{rows}</table></body></html>"""
    with open(path, "w") as f:
        f.write(doc)
