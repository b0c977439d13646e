"""Share (%) of the card's idle time in compress calls with no layer span
open: the program's glue, or time outside the program."""

from dczbench.spans import unspanned_pct


def read(run):
    return unspanned_pct(run, "compress")
