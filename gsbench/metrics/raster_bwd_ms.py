"""The raster backward's device self time a training view: the program's
``raster_bwd`` span (ops/raster._Rasterize.backward) inside each traced
``backward``."""
from gsbench.metrics._spans import stage_ms


def read(run):
    return stage_ms(run, "train", "raster_bwd")
