"""Terminal/HTML surfaces of the port (counterpart of ``datacomp_tpu/ui``),
replacing the reference's JavaFX GUI (``ui/``)."""

from .dashboard import render_dashboard, export_html, sparkline

__all__ = ["render_dashboard", "export_html", "sparkline"]
