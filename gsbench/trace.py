"""Reading a ``torch.profiler`` trace of a short steady stretch: device
busy time (the union of every kernel, copy and set on the device), the
idle gaps and the host operator running in each, and device time by
kernel name."""
from __future__ import annotations

import contextlib
import time

NAME_CHARS = 160


@contextlib.contextmanager
def profiled(sync):
    """Profile the block (CPU and CUDA activity); yields a dict that gets
    ``prof`` and the block's host-clock ``wall_s`` (synchronized)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = {}
    with torch.profiler.profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        yield out
        sync()
        out["wall_s"] = time.perf_counter() - t0
    out["prof"] = prof


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _events(prof):
    """(device spans, host spans) as (start_us, end_us, name) from the
    profiler's raw records."""
    from torch.autograd import DeviceType
    dev, host = [], []
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        # no raw records: the (slower) parsed events
        for e in prof.events():
            item = (e.time_range.start, e.time_range.end, e.name)
            (dev if e.device_type == DeviceType.CUDA else host).append(item)
        return dev, host
    for e in raw:
        s = e.start_ns() / 1e3
        item = (s, s + e.duration_ns() / 1e3, e.name())
        (dev if e.device_type() == DeviceType.CUDA else host).append(item)
    return dev, host


def _host_at(host, t: float) -> str:
    """The innermost host operator running at ``t`` (the latest to start),
    else the last one to end before it."""
    cover = [h for h in host if h[0] <= t <= h[1]]
    if cover:
        return max(cover)[2]
    before = [h for h in host if h[1] < t]
    return "after " + max(before, key=lambda h: h[1])[2] if before else "-"


def summarize(prof, wall_s: float, top: int = 10) -> dict:
    """busy_s, window_s, kernels (device activities), kernel_s (device
    seconds by name), device_ops and idle_gaps (each the ``top`` longest,
    [name, seconds])."""
    dev, host = _events(prof)
    merged = _union([(s, e) for s, e, _ in dev])
    busy_us = sum(e - s for s, e in merged)
    by_name = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:top]
    idle = [[_host_at(host, 0.5 * (s + e)), length * 1e-6]
            for length, s, e in gaps]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # kernel names are C++ signatures: their first NAME_CHARS say which
    return {"busy_s": busy_us * 1e-6, "window_s": wall_s,
            "kernels": len(dev), "kernel_s": by_name,
            "device_ops": [[k[:NAME_CHARS], v] for k, v in ops],
            "idle_gaps": [[k[:NAME_CHARS], v] for k, v in idle]}


def kernel_seconds(summary: dict, fragment: str) -> float:
    """Device seconds of the kernels whose name holds ``fragment``."""
    return sum(v for k, v in summary["kernel_s"].items() if fragment in k)
