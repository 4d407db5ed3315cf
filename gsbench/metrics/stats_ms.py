"""The statistics' device self time a training view: the program's
``stats`` span (trainer.view_raster_stats and statistics.update_stats)
inside each traced ``step``; only a statistics epoch's steps have one."""
from gsbench.metrics._spans import stage_ms


def read(run):
    return stage_ms(run, "train", "stats")
