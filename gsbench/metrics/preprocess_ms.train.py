"""Cull, gather and SH's device self time a training view: the program's
``preprocess`` span (render.render_preprocess) inside each traced
``step``."""
from gsbench.metrics._spans import stage_ms


def read(run):
    return stage_ms(run, "train", "preprocess")
