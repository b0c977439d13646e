"""The host decode route of restore calls, ms a MB restored: the program's
``host_decode`` spans (the host codec's bit decoding of each chunk the card's
decoder does not take), summed over threads.  None where the program records
no such span."""

from dczbench import spans as program_spans


def read(run):
    spans = program_spans.recorded()
    mb = run.phase_bytes["restore"] / 1e6
    if not spans or not mb:
        return None
    restores = {s.request for s in spans if s.name == program_spans.REQUEST["restore"]}
    ns = [s.end_ns - s.start_ns for s in spans
          if s.name == "host_decode" and s.request in restores]
    return sum(ns) / 1e6 / mb if ns else None
