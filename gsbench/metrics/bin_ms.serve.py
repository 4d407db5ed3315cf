"""Binning's device self time a frame: the program's ``bin`` span
(ops/binning.build_tile_table) inside each traced ``eval``."""
from gsbench.metrics._spans import stage_ms


def read(run):
    return stage_ms(run, "serve", "bin")
