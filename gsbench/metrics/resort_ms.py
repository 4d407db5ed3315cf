"""The Morton resort's device time in the traced ``epoch_boundary``: the
program's ``resort`` span (training/densify.spatial_refine: the live
points' codes, one stable sort, every parameter and moment moved), in
ms."""
from gsbench.metrics._boundary import stage_ms


def read(run):
    return stage_ms(run, "resort")
