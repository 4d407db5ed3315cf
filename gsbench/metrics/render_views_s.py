"""Frames rendered over the window's whole time."""
from gsbench.metrics._read import rate


def read(run):
    return rate(run, "serve")
