"""Sparse Adam's device self time a training view: the program's ``adam``
span (training/trainer._adam_update) inside each traced ``step``."""
from gsbench.metrics._spans import stage_ms


def read(run):
    return stage_ms(run, "train", "adam")
