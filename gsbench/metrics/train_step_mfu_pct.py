"""The FP32 operations a training view needs (gsbench.work.train_step_ops)
at 67 TFLOP/s, over the untraced window's time per view."""
from gsbench import work
from gsbench.metrics._read import mfu_pct


def read(run):
    return mfu_pct(run, "train", work.train_step_ops)
