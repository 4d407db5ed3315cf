"""The readers of the traced epoch boundary (``densify_ms``,
``resort_ms``, ``host_waits_per_boundary``) and of the statistics span
(``stats_ms``) on the CPU, with a stand-in for the card's timing events:
each reads its span, and a program without the spans gives None without
raising."""
import types

import torch

from gsbench import run

NEW = ("densify_ms", "resort_ms", "stats_ms", "host_waits_per_boundary")


class _Tick:
    """A stand-in for ``torch.cuda.Event``: its time is the count of
    events recorded before it, in ms."""
    count = 0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = _Tick.count
        _Tick.count += 1

    def elapsed_time(self, end):
        return float(end.t - self.t)


def _run(device="cuda"):
    return types.SimpleNamespace(
        device=torch.device(device), traffic={"loop": "densify",
                                              "kind": "train"},
        trace={"views": 1}, boundary_trace={"busy_s": 1e-3})


def _read(state):
    return {m: run.reader(m).read(state) for m in NEW}


def _record(profiling, card):
    dev = torch.device("cuda" if card else "cpu")
    with profiling.recording():
        with profiling.span("step", dev):
            with profiling.span("stats"):
                profiling.host_wait("stats.mask", 8)
        with profiling.span("boundary", dev):
            with profiling.span("densify"):
                profiling.host_wait("densify.n_prune", 3)
                with profiling.span("inner"):
                    pass
            with profiling.span("resort"):
                pass


def test_readers_read_their_spans(monkeypatch):
    from litegs_torch.utils import profiling
    monkeypatch.setattr(torch.cuda, "Event", _Tick)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _Tick.count = 0
    _record(profiling, card=True)
    # step: 0 | stats 1-2 | 3; boundary: 4 | densify 5 (inner 6-7) 8 |
    # resort 9-10 | 11
    assert _read(_run()) == {"densify_ms": 2.0, "resort_ms": 1.0,
                             "stats_ms": 1.0, "host_waits_per_boundary": 3}
    # off the card only the count reads
    _record(profiling, card=False)
    assert _read(_run("cpu")) == {"densify_ms": None, "resort_ms": None,
                                  "stats_ms": None,
                                  "host_waits_per_boundary": 3}


def test_readers_give_none_without_the_spans(monkeypatch):
    from litegs_torch.utils import profiling
    monkeypatch.setattr(torch.cuda, "Event", _Tick)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    # a program whose step has no stats span and whose boundary no span
    with profiling.recording():
        with profiling.span("step", torch.device("cuda")):
            pass
    assert set(_read(_run()).values()) == {None}
    state = _run("cpu")
    del state.boundary_trace
    _record(profiling, card=False)
    assert _read(state)["host_waits_per_boundary"] is None
    monkeypatch.delattr(profiling, "RECORDER")
    assert set(_read(_run())).issubset(NEW)
    assert set(_read(_run()).values()) == {None}
