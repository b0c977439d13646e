"""Share (%) of the compress calls' time in which the card ran no kernel,
copy or fill (profiler trace)."""

from dczbench.readers import idle_pct


def read(run):
    return idle_pct(run, "compress")
