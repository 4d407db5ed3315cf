"""Projection's device self time a frame: the program's ``project`` span
(render._project) inside each traced ``eval``."""
from gsbench.metrics._spans import stage_ms


def read(run):
    return stage_ms(run, "serve", "project")
