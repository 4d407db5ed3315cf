"""Helpers the readers of the traced epoch boundary share.

The densify mix profiles one ``epoch_boundary`` alone after its traced
views (``run.boundary_trace``).  The program records that call as a root
span ``boundary`` with the children ``densify`` (densify_step) and
``resort`` (spatial_refine), and counts its host reads inside them
(``litegs_torch.utils.profiling.RECORDER``).  Only the traced stretch runs
under the profiler, so the recorder's last ``boundary`` root is that
call.  A run without a traced boundary, or a program without those
spans, gives None.
"""
from __future__ import annotations


def _table(run):
    if not getattr(run, "boundary_trace", None):
        return None
    try:
        from litegs_torch.utils import profiling
        table = profiling.RECORDER.stage_table("boundary", last=1)
    except (ImportError, AttributeError):
        return None
    return table if table["roots"] == 1 else None


def stage_ms(run, stage: str):
    """The stage's device self time in the traced boundary, ms; None off
    the card."""
    if run.device.type != "cuda":
        return None
    table = _table(run)
    if table is None or table["device_ms"] is None:
        return None
    s = table["stages"].get(stage)
    return None if s is None else s["device_ms"]


def waits(run):
    """Host waits counted inside the traced boundary."""
    table = _table(run)
    if table is None:
        return None
    return sum(n for s in table["stages"].values()
               for n in s["waits"].values())
