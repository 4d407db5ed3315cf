"""Cull, gather and SH's device self time a frame: the program's
``preprocess`` span (render.render_preprocess) inside each traced
``eval``."""
from gsbench.metrics._spans import stage_ms


def read(run):
    return stage_ms(run, "serve", "preprocess")
