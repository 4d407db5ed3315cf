"""The chunk bounds' device self time a frame: the program's ``aabb`` span
(training/trainer.masked_chunk_aabb) inside each traced ``eval``."""
from gsbench.metrics._spans import stage_ms


def read(run):
    return stage_ms(run, "serve", "aabb")
