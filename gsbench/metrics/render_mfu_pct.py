"""The FP32 operations a rendered view needs (gsbench.work.render_ops) at
67 TFLOP/s, over the untraced window's time per view."""
from gsbench import work
from gsbench.metrics._read import mfu_pct


def read(run):
    return mfu_pct(run, "serve", work.render_ops)
