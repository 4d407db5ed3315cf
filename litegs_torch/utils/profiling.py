"""Spans and host-wait counts inside the program, and a trace exporter.

The reference marks its stages with NVTX ranges (nvtx.range_push in
litegs/render/__init__.py:34,56-63 and wrapper.py:680).  The port marks
them with spans that cost nothing unless someone is looking:

* ``span(name)`` -- a context manager around one stage.  It is **on**
  while a ``torch.profiler`` runs or inside :func:`recording`, and
  **off** otherwise: then it checks three flags and returns a shared null
  context.  On, it opens a host range of its name (under a profiler, so
  the stage shows on the trace's timeline beside its kernels, as a host
  operator) and appends a :class:`SpanRecord` to :data:`RECORDER`: name,
  parent, root index, host start and end, the host waits counted inside
  it and, where its root span's work runs on the card, a pair of timing
  events recorded on the current stream at entry and exit.  The events
  are resolved only when the recorder is read.  ``spanned(name)`` is the
  same span around a whole function.
* ``host_wait(site, n)`` -- marks a place where the host reads a value
  of the device and so waits for the device to drain its queue (an
  explicit read, ``nonzero``, CUDA ``bincount``, a pageable scalar copy to
  the device, ``repeat_interleave`` without ``output_size``).  Always
  counted in :data:`HOST_WAITS` by site; when on, also in the innermost
  open span's record.  A site counts the waits its call makes when its
  tensors live on the card, whichever device they are on.
* ``recording()`` -- turns the spans on for the enclosed block without a
  profiler; ``stage_table`` reads what they recorded.
* ``trace(dir)`` -- profiles the enclosed block and writes ``trace.json``
  (the profiler's timeline) and ``spans.json`` (the recorder's records).

A root span (one opened with no span open) takes the device its work
runs on from its ``device`` argument (the train step's and the eval
render's parameters); the spans under it inherit it.  Only a root on a
CUDA device records timing events, so a CPU run reports no device time,
whatever else in the process uses the card.

The recorder keeps one stack for the process: the program is single
threaded but for the autograd engine, whose thread runs while the thread
that called ``backward`` waits, so a span opened there takes as its
parent the span open on the caller's thread.  It keeps at most
:data:`MAX_RECORDS` records: a root span that opens when it holds that
many drops them first, so a profiler left running over a long session
(spans are on under any ``torch.profiler``) holds a bounded store.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import time
from typing import Optional

import torch

# host waits by site since the process started, spans on or off
HOST_WAITS: collections.Counter = collections.Counter()

_profiler_enabled = torch.autograd._profiler_enabled
# a span's range in the profiler's trace: a host operator
# (``RecordScope.FUNCTION``), where ``record_function``'s user annotation
# is mirrored by kineto onto the device's timeline as an activity of its
# own, which a trace's reader would count as device work
_HostRange = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()
# the records the recorder holds at most (two timing events each on the
# card): about 6,000 train steps of 11 spans
MAX_RECORDS = 1 << 16


class SpanRecord:
    """One span as it ran.  ``host_start_ns``/``host_end_ns`` are on the
    clock ``torch.profiler`` stamps host events with (Unix time, ns);
    ``events`` is the (entry, exit) pair of ``torch.cuda.Event`` or None
    off the card."""

    __slots__ = ("name", "parent", "root", "host_start_ns", "host_end_ns",
                 "waits", "events", "device_ms")

    def __init__(self, name, parent, root, events):
        self.name = name
        self.parent = parent          # index in RECORDER.records, or None
        self.root = root              # index of its outermost span
        self.host_start_ns = time.time_ns()
        self.host_end_ns = None
        self.waits = collections.Counter()
        self.events = events
        self.device_ms = None

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) * 1e-6

    def as_dict(self) -> dict:
        return {"name": self.name, "parent": self.parent, "root": self.root,
                "host_start_ns": self.host_start_ns,
                "host_end_ns": self.host_end_ns, "host_ms": self.host_ms,
                "device_ms": self.device_ms, "waits": dict(self.waits)}


class Recorder:
    """The records of every span that ran while on, in entry order."""

    def __init__(self):
        self.records: list[SpanRecord] = []
        self.stack: list[int] = []
        self.recording = 0

    def clear(self):
        self.records.clear()
        self.stack.clear()

    def resolve(self):
        """Fill every record's ``device_ms`` from its events (one device
        synchronize when any is unresolved)."""
        todo = [r for r in self.records
                if r.events is not None and r.device_ms is None
                and r.host_end_ns is not None]
        if todo:
            torch.cuda.synchronize()
            for r in todo:
                r.device_ms = r.events[0].elapsed_time(r.events[1])

    def stage_table(self, root: str, last: Optional[int] = None) -> dict:
        """Self times of the stages under the outermost spans named
        ``root`` (the last ``last`` of them, default all), summed over
        them.  Returns ``{"roots", "device_ms", "host_ms", "stages"}``:
        the roots' count and summed times, and per stage name its
        ``count``, ``device_ms`` and ``host_ms`` (self: its spans' times
        less their child spans') and ``waits`` by site; the roots' own
        self time is the stage ``"other"``, so the stages' times sum to
        the roots'.  ``device_ms`` is None where a record has no events
        (off the card)."""
        self.resolve()
        recs = self.records
        picked = [i for i, r in enumerate(recs)
                  if r.parent is None and r.name == root
                  and r.host_end_ns is not None]
        if last is not None:
            picked = picked[-last:] if last else []
        roots = set(picked)
        tree = [i for i, r in enumerate(recs) if r.root in roots]
        device = all(recs[i].device_ms is not None for i in tree)
        child_dev = collections.defaultdict(float)
        child_host = collections.defaultdict(float)
        for i in tree:
            r = recs[i]
            if r.parent is not None:
                child_host[r.parent] += r.host_ms
                if device:
                    child_dev[r.parent] += r.device_ms
        stages = {}
        for i in tree:
            r = recs[i]
            name = "other" if i in roots else r.name
            s = stages.setdefault(name, {"count": 0, "device_ms": 0.0,
                                         "host_ms": 0.0, "waits": {}})
            s["count"] += 1
            s["host_ms"] += r.host_ms - child_host[i]
            if device:
                s["device_ms"] += r.device_ms - child_dev[i]
            for site, n in r.waits.items():
                s["waits"][site] = s["waits"].get(site, 0) + n
        if not device:
            for s in stages.values():
                s["device_ms"] = None
        return {"roots": len(picked),
                "device_ms": (sum(recs[i].device_ms for i in picked)
                              if device else None),
                "host_ms": sum(recs[i].host_ms for i in picked),
                "stages": stages}


RECORDER = Recorder()


class _Span:
    __slots__ = ("name", "device", "index", "fn")

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = device

    def __enter__(self):
        rec = RECORDER
        if rec.stack:
            parent = rec.stack[-1]
            root = rec.records[parent].root
            cuda = rec.records[parent].events is not None
        else:
            if len(rec.records) >= MAX_RECORDS:
                rec.records.clear()
            parent, root = None, len(rec.records)
            cuda = (self.device is not None
                    and torch.device(self.device).type == "cuda")
        self.index = len(rec.records)
        events = None
        if cuda:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        rec.records.append(SpanRecord(self.name, parent, root, events))
        rec.stack.append(self.index)
        self.fn = (_HostRange(self.name) if _profiler_enabled() else None)
        if self.fn is not None:
            self.fn.__enter__()
        if events is not None:
            events[0].record()
        return self

    def __exit__(self, *exc):
        rec = RECORDER
        r = rec.records[self.index]
        if r.events is not None:
            r.events[1].record()
        r.host_end_ns = time.time_ns()
        rec.stack.pop()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


def _on() -> bool:
    return bool(RECORDER.stack or RECORDER.recording or _profiler_enabled())


def span(name: str, device=None):
    """A span named ``name`` around the ``with`` block: the shared null
    context when off (no profiler, no :func:`recording`, no open span).
    ``device`` is where the block's work runs; a root span records timing
    events only on a CUDA device, and a span under it inherits its."""
    if not _on():
        return _NULL
    return _Span(name, device)


def spanned(name: str, device=None):
    """Decorator: the function's call inside ``span(name)``.  ``device``,
    if given, maps the call's arguments to the device its work runs on,
    and is called only when the spans are on."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on():
                return fn(*args, **kwargs)
            where = None if device is None else device(*args, **kwargs)
            with _Span(name, where):
                return fn(*args, **kwargs)
        return call
    return wrap


def host_wait(site: str, n: int = 1):
    """Count ``n`` host waits at ``site`` (and in the innermost open
    span's record)."""
    HOST_WAITS[site] += n
    stack = RECORDER.stack
    if stack:
        RECORDER.records[stack[-1]].waits[site] += n


@contextlib.contextmanager
def recording():
    """Spans on for the block, without a profiler; the recorder starts
    empty.  Yields :data:`RECORDER`."""
    RECORDER.clear()
    RECORDER.recording += 1
    try:
        yield RECORDER
    finally:
        RECORDER.recording -= 1


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block; writes ``log_dir/trace.json`` (open it
    in chrome://tracing or Perfetto) and ``log_dir/spans.json`` (the
    block's span records, device times resolved).  Yields the profiler,
    whose ``key_averages()`` sums the time by op and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    RECORDER.clear()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    RECORDER.resolve()
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump([r.as_dict() for r in RECORDER.records], f)
