"""Host waits a frame: the program's ``HOST_WAITS`` marks counted inside
each traced ``eval`` span."""
from gsbench.metrics._spans import waits_per_view


def read(run):
    return waits_per_view(run, "serve")
