"""Helpers the readers share."""
from __future__ import annotations


def loop(run) -> str:
    """The mix's kind of loop ("train", "serve"): its ``kind`` where it
    names one, else the module it runs (``loop``)."""
    return run.traffic.get("kind", run.traffic["loop"])


def rate(run, kind: str):
    """Views over the window's whole time, for the ``kind`` loop."""
    if loop(run) != kind:
        return None
    return run.window["views"] / run.window["seconds"]


def idle_pct(run, kind: str):
    t = getattr(run, "trace", None)
    if loop(run) != kind or not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernels_per_view(run, kind: str):
    t = getattr(run, "trace", None)
    if loop(run) != kind or not t or not t["kernels"]:
        return None
    return t["kernels"] / t["views"]


def roofline_pct(run, kind: str, fragment: str, cost):
    """100 x the traced views' bound (``cost(view work) -> (ops, bytes)``)
    over the device time of the kernels named with ``fragment``."""
    from gsbench import trace, work
    t = getattr(run, "trace", None)
    views = getattr(run, "work", None)
    if loop(run) != kind or not t or not views:
        return None
    spent = trace.kernel_seconds(t, fragment)
    if spent <= 0:
        return None
    return 100.0 * sum(work.bound_s(*cost(w)) for w in views) / spent


def mfu_pct(run, kind: str, ops_of):
    """100 x the FP32 operations a view needs (the traced views' mean) at
    the published peak, over the untraced window's time per view."""
    from gsbench import work
    views = getattr(run, "work", None)
    if loop(run) != kind or not views:
        return None
    ops = sum(ops_of(w) for w in views) / len(views)
    per_view = run.window["seconds"] / run.window["views"]
    return 100.0 * ops / work.PEAK_FP32 / per_view
