"""Autograd's device self time a training view: the program's ``backward``
span (the loss's ``backward()`` call) less the raster backward inside it."""
from gsbench.metrics._spans import stage_ms


def read(run):
    return stage_ms(run, "train", "backward")
