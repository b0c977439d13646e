"""The pipeline workers' waits for their chunks' SHA-256 in compress calls:
``wait`` spans whose parent is a ``job`` span, ms a MB of input.  None where
the program records no such span (a version that hashes on the worker)."""

from dczbench import spans as program_spans


def read(run):
    spans = program_spans.recorded()
    mb = run.phase_bytes["compress"] / 1e6
    if not spans or not mb:
        return None
    compresses = {s.request for s in spans if s.name == "compress"}
    jobs = {s.span_id for s in spans if s.name == "job" and s.request in compresses}
    waits = [s.end_ns - s.start_ns for s in spans if s.name == "wait" and s.parent in jobs]
    if not waits:
        return None
    return sum(waits) / 1e6 / mb
