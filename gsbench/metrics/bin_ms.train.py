"""Binning's device self time a training view: the program's ``bin`` span
(ops/binning.build_tile_table) inside each traced ``step``."""
from gsbench.metrics._spans import stage_ms


def read(run):
    return stage_ms(run, "train", "bin")
