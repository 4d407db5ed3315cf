"""Densify's device self time in the traced ``epoch_boundary``: the
program's ``densify`` span (training/densify.densify_step: the taming
selection, split and clone, the 'weight' prune, the opacity decay), in
ms."""
from gsbench.metrics._boundary import stage_ms


def read(run):
    return stage_ms(run, "densify")
