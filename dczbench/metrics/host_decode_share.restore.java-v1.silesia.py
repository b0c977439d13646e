"""Share (%) of the bytes restored that took the host decode route: the
bytes of the program's ``host_decode`` spans in restore calls over the bytes
restored; 0.0 where the program records spans but opened none of these, None
where it records no spans."""

from dczbench import spans as program_spans


def read(run):
    spans = program_spans.recorded()
    restored = run.phase_bytes["restore"]
    if not spans or not restored:
        return None
    restores = {s.request for s in spans if s.name == program_spans.REQUEST["restore"]}
    routed = sum(s.nbytes for s in spans if s.name == "host_decode" and s.request in restores)
    return 100.0 * routed / restored
