"""Profiling and tracing helpers (the port of
``litegs_tpu/utils/profiling.py``).

The reference marks its stages with NVTX ranges (nvtx.range_push in
litegs/render/__init__.py:34,56-63 and wrapper.py:680) and times with a
synchronised wall clock (trainer.py:206-208):

* ``annotate(name)`` -- a ``torch.profiler.record_function`` span, visible
  in a ``torch.profiler`` trace, plus an NVTX range when CUDA is present;
  nestable, nearly free when no profiler runs;
* ``trace(dir)`` -- profile the enclosed block (CPU and, with a card, CUDA
  activity) and write it to ``dir`` as a Chrome trace;
* ``timed(fn, n)`` -- wall-clock seconds per call with
  ``torch.cuda.synchronize`` around the calls.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def annotate(name: str):
    """A named span for the profiler (and NVTX on CUDA)."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()
        else:
            yield


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block; writes ``log_dir/trace.json`` (open it
    in chrome://tracing or Perfetto).  Yields the profiler, whose
    ``key_averages()`` sums the time by op and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(fn, *args, n: int = 1, **kwargs):
    """(mean seconds per call, last output) over ``n`` calls after one
    warm-up call, with a device sync after every call."""
    out = fn(*args, **kwargs)
    _sync()
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args, **kwargs)
        _sync()
    return (time.perf_counter() - t0) / n, out
