"""The raster forward's device self time a training view: the program's
``raster_fwd`` span (ops/raster.rasterize) inside each traced ``step``."""
from gsbench.metrics._spans import stage_ms


def read(run):
    return stage_ms(run, "train", "raster_fwd")
