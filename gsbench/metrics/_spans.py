"""Helpers the readers of the program's own spans share.

The port records spans and host waits inside its train step (root span
``step``) and eval render (root ``eval``) while a ``torch.profiler`` runs
(``litegs_torch.utils.profiling.RECORDER``).  In a run of the benchmark
only the traced stretch runs under the profiler, so the recorder's last
``trace["views"]`` roots are that stretch's views.  A program without the
recorder, or a stretch that recorded fewer roots, gives None.
"""
from __future__ import annotations

from gsbench.metrics._read import loop

ROOTS = {"train": "step", "serve": "eval"}


def _table(run, kind: str):
    t = getattr(run, "trace", None)
    if loop(run) != kind or not t or not t.get("views"):
        return None
    try:
        from litegs_torch.utils import profiling
        table = profiling.RECORDER.stage_table(ROOTS[kind], last=t["views"])
    except (ImportError, AttributeError):
        return None
    return table if table["roots"] == t["views"] else None


def stage_ms(run, kind: str, stage: str):
    """The stage's device self time (its spans' event time less their
    child spans'), ms a view; None off the card."""
    if run.device.type != "cuda":
        return None
    table = _table(run, kind)
    if table is None or table["device_ms"] is None:
        return None
    s = table["stages"].get(stage)
    return None if s is None else s["device_ms"] / table["roots"]


def waits_per_view(run, kind: str):
    """Host waits counted inside the root spans, a view."""
    table = _table(run, kind)
    if table is None:
        return None
    return sum(n for s in table["stages"].values()
               for n in s["waits"].values()) / table["roots"]
