"""The raster forward's device self time a frame: the program's
``raster_fwd`` span (ops/raster.rasterize) inside each traced ``eval``."""
from gsbench.metrics._spans import stage_ms


def read(run):
    return stage_ms(run, "serve", "raster_fwd")
