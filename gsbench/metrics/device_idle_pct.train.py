"""Share of the traced stretch's wall time in which nothing ran on the
device (1 minus the union of kernels, copies and sets)."""
from gsbench.metrics._read import idle_pct


def read(run):
    return idle_pct(run, "train")
