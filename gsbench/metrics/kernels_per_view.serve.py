"""Device activities (kernels, copies, sets) per view in the traced
stretch."""
from gsbench.metrics._read import kernels_per_view


def read(run):
    return kernels_per_view(run, "serve")
