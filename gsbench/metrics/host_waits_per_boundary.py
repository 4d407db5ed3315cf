"""Host waits in the traced ``epoch_boundary``: the program's
``HOST_WAITS`` marks counted inside its ``boundary`` span."""
from gsbench.metrics._boundary import waits


def read(run):
    return waits(run)
