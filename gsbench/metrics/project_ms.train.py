"""Projection's device self time a training view: the program's ``project``
span (render._project) inside each traced ``step``."""
from gsbench.metrics._spans import stage_ms


def read(run):
    return stage_ms(run, "train", "project")
