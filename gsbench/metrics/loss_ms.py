"""The loss's device self time a training view: the program's ``loss`` span
(training/trainer.view_loss) inside each traced ``step``."""
from gsbench.metrics._spans import stage_ms


def read(run):
    return stage_ms(run, "train", "loss")
