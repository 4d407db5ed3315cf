"""Training views completed over the window's whole time, epoch
boundaries included."""
from gsbench.metrics._read import rate


def read(run):
    return rate(run, "train")
