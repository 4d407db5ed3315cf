"""Host waits a training view: the program's ``HOST_WAITS`` marks counted inside
each traced ``step`` span (the epoch's read-back runs outside them)."""
from gsbench.metrics._spans import waits_per_view


def read(run):
    return waits_per_view(run, "train")
