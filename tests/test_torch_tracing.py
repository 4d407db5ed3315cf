"""The port's spans and host-wait counter (``litegs_torch.utils.profiling``)
on the CPU at a tiny size: off they record nothing and cost one check, on
they partition each step and eval render into its stages, on the
profiler's clock, without changing what the step computes."""
import collections
import tracemalloc

import pytest
import torch

from litegs_torch import config
from litegs_torch.data import synthetic_train
from litegs_torch.training.trainer import Trainer, make_eval_render
from litegs_torch.utils import profiling

STAGES = ("preprocess", "project", "bin", "raster_fwd", "loss", "backward",
          "raster_bwd", "adam")
# the waits each step counts on the CPU path: the 'cuda' raster backend's
# plain versions split the table into one group of tiles forward and one
# backward (raster.groups: a nonzero, a copy, a sum and three
# repeat_interleave each)
STEP_WAITS = {"cull.nonzero": 1, "bin.sizes": 1,
              "raster.check_table": 1, "raster.groups": 12,
              "adam.chunk_mask": 1, "adam.lr_copy": 6}
EVAL_WAITS = {"cull.nonzero": 1, "bin.sizes": 1,
              "raster.check_table": 1, "raster.groups": 6}
H, W = 32, 48


@pytest.fixture(scope="module")
def task():
    return synthetic_train.make_task(n_points=300, n_frames=2, img_h=H,
                                     img_w=W, sh_degree=1, seed=0,
                                     device="cpu")


def _trainer(task):
    data, xyz, rgb = task
    tr = Trainer(config.ModelParams(sh_degree=1),
                 config.OptimizationParams(iterations=20),
                 config.PipelineParams(), config.DensifyParams(),
                 config.CapacityParams(1024), data, 1.0)
    return tr, tr.init_state(xyz, rgb), tr.init_stats()


def _eval(task, state):
    data = task[0]
    fn = make_eval_render(config.PipelineParams(), H, W, 1)
    return fn(state.params, state.active_count, data.view[0], data.proj[0],
              data.planes[0], data.center[0])


def test_spans_off_record_nothing_and_cost_one_check(task, monkeypatch):
    assert not torch.autograd._profiler_enabled()

    def refuse(*a, **k):
        raise AssertionError("called with the spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_HostRange", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    profiling.RECORDER.clear()
    tr, state, stats = _trainer(task)
    state, stats, _ = tr.run_epoch(state, stats, 10, frame_ids=[0, 1])
    _eval(task, state)
    assert profiling.RECORDER.records == []
    null = profiling.span("a")
    assert profiling.span("b") is null
    with profiling.span("c"):
        pass
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(2000):
            with profiling.span("step"):
                pass
        grew = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grew < 2000, grew


def _profiled_epoch(task):
    tr, state, stats = _trainer(task)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        state, stats, _ = tr.run_epoch(state, stats, 10, frame_ids=[0, 1])
    return prof, list(profiling.RECORDER.records)


def test_spans_under_the_profiler_partition_each_step(task):
    profiling.RECORDER.clear()
    prof, recs = _profiled_epoch(task)
    steps = [i for i, r in enumerate(recs) if r.name == "step"]
    assert len(steps) == 2
    assert all(recs[i].parent is None for i in steps)
    for i in steps:
        kids = [r for r in recs if r.root == i and r is not recs[i]]
        assert collections.Counter(r.name for r in kids) == {
            s: 1 for s in STAGES}
        by_name = {r.name: r for r in kids}
        for r in kids:
            want = "backward" if r.name == "raster_bwd" else "step"
            assert recs[r.parent].name == want, r.name
        assert by_name["raster_bwd"].parent == recs.index(
            by_name["backward"])
    # aabb runs once an epoch, outside the steps
    assert [r.name for r in recs if r.name == "aabb"] == ["aabb"]
    # each span is the profiler's own event, on the profiler's clock
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        events[e.name()].append(e.start_ns())
    for name in ("step", "aabb") + STAGES:
        got = sorted(events[name])
        mine = sorted(r.host_start_ns for r in recs if r.name == name)
        assert len(got) == len(mine), name
        for a, b in zip(got, mine):
            assert abs(a - b) < 1_000_000, (name, a - b)
    table = profiling.RECORDER.stage_table("step")
    assert table["roots"] == 2 and table["device_ms"] is None
    assert set(table["stages"]) == set(STAGES) | {"other"}
    parts = sum(s["host_ms"] for s in table["stages"].values())
    assert parts == pytest.approx(table["host_ms"], rel=1e-9, abs=1e-9)
    assert all(s["host_ms"] >= 0 for s in table["stages"].values())
    one = profiling.RECORDER.stage_table("step", last=1)
    assert one["roots"] == 1
    assert one["host_ms"] == pytest.approx(recs[steps[-1]].host_ms)


def test_host_waits_fixed_per_step_and_per_render(task):
    tr, state, stats = _trainer(task)
    before = profiling.HOST_WAITS.copy()
    with profiling.recording() as rec:
        state, stats, _ = tr.run_epoch(state, stats, 10, frame_ids=[0, 1])
    got = profiling.HOST_WAITS - before
    want = collections.Counter({k: 2 * v for k, v in STEP_WAITS.items()})
    want["epoch.readback"] = 1
    assert got == want
    table = rec.stage_table("step")
    inside = collections.Counter()
    for s in table["stages"].values():
        inside.update(s["waits"])
    # the read-back runs once an epoch, outside the steps
    assert inside == want - collections.Counter({"epoch.readback": 1})
    assert table["stages"]["adam"]["waits"] == {"adam.chunk_mask": 2,
                                                "adam.lr_copy": 12}
    assert table["stages"]["raster_bwd"]["waits"] == {"raster.groups": 12}

    before = profiling.HOST_WAITS.copy()
    with profiling.recording() as rec:
        _eval(task, state)
    assert profiling.HOST_WAITS - before == EVAL_WAITS
    table = rec.stage_table("eval")
    assert table["roots"] == 1
    assert set(table["stages"]) == {"aabb", "preprocess", "project", "bin",
                                    "raster_fwd", "other"}
    inside = collections.Counter()
    for s in table["stages"].values():
        inside.update(s["waits"])
    assert inside == EVAL_WAITS


def test_step_is_bitwise_the_same_with_spans_on(task):
    out = []
    for on in (False, True):
        tr, state, stats = _trainer(task)
        if on:
            with profiling.recording():
                state, stats, _ = tr.run_epoch(state, stats, 10,
                                               frame_ids=[0, 1])
            assert profiling.RECORDER.records
        else:
            state, stats, _ = tr.run_epoch(state, stats, 10,
                                           frame_ids=[0, 1])
        out.append(state)
    off, on = out
    for k, v in off.params.fields().items():
        assert torch.equal(v, on.params.fields()[k]), k
        assert torch.equal(off.adam.exp_avg[k], on.adam.exp_avg[k]), k
        assert torch.equal(off.adam.exp_avg_sq[k], on.adam.exp_avg_sq[k]), k


def test_a_cpu_step_records_no_device_time_once_the_card_is_in_use(
        task, monkeypatch):
    """The root span decides from its own parameters: a CPU step records
    no timing events, even after something in the process has set up
    CUDA (the card, where there is one; a CUDA said to be in use, where
    there is none)."""
    if torch.cuda.is_available():
        torch.cuda.init()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)

    def refuse(*a, **k):
        raise AssertionError("a timing event for a CPU span")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    profiling.RECORDER.clear()
    _, recs = _profiled_epoch(task)
    assert recs and all(r.events is None for r in recs)
    assert profiling.RECORDER.stage_table("step")["device_ms"] is None
    with profiling.recording() as rec:
        _eval(task, _trainer(task)[1])
        with profiling.span("collective:all_reduce", torch.device("cpu")):
            pass
    assert rec.records and all(r.events is None for r in rec.records)


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


def test_the_root_span_fixes_the_device_its_children_inherit(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Tick)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with profiling.recording() as rec:
        with profiling.span("step", torch.device("cuda")):
            with profiling.span("bin"):
                pass
            with profiling.span("adam", torch.device("cpu")):
                pass
        with profiling.span("eval", torch.device("cpu")):
            with profiling.span("bin", torch.device("cuda")):
                pass
        with profiling.span("collective:all_reduce"):
            pass
    on = {(r.name, r.root): r.events is not None for r in rec.records}
    assert on == {("step", 0): True, ("bin", 0): True, ("adam", 0): True,
                  ("eval", 3): False, ("bin", 3): False,
                  ("collective:all_reduce", 5): False}
    table = rec.stage_table("step")
    # step: entry 0, bin 1-2, adam 3-4, exit 5
    assert table["device_ms"] == 5.0
    assert {k: s["device_ms"] for k, s in table["stages"].items()} == {
        "other": 3.0, "bin": 1.0, "adam": 1.0}
    assert rec.stage_table("eval")["device_ms"] is None


def test_the_recorder_holds_a_bounded_store(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 5)
    with profiling.recording() as rec:
        for i in range(4):
            with profiling.span(f"root{i}"):
                with profiling.span("stage"):
                    pass
            assert len(rec.records) <= 6
    # the fourth root found six records and dropped them
    assert [(r.name, r.parent, r.root) for r in rec.records] == [
        ("root3", None, 0), ("stage", 0, 0)]
    assert rec.stage_table("root3")["roots"] == 1


# the waits one statistics epoch's boundary counts on the taming path: the
# prune count, the two draws' copies, the copies' ids and the pruned count
BOUNDARY_WAITS = {"densify.prune_num": 1, "densify.draws": 2,
                  "densify.copies": 1, "densify.n_prune": 1}


def _densify_trainer(task):
    """A trainer whose epoch 2 collects statistics and ends in an
    event."""
    data, xyz, rgb = task
    tr = Trainer(config.ModelParams(sh_degree=1),
                 config.OptimizationParams(iterations=20),
                 config.PipelineParams(),
                 config.DensifyParams(densify_from=0, densify_until=8,
                                      densification_interval=2,
                                      target_primitives=900),
                 config.CapacityParams(1024), data, 1.0)
    return tr, tr.init_state(xyz, rgb), tr.init_stats()


def test_statistics_steps_and_the_boundary_record_their_spans(task):
    tr, state, stats = _densify_trainer(task)
    before = profiling.HOST_WAITS.copy()
    with profiling.recording() as rec:
        state, stats, _ = tr.run_epoch(state, stats, 2, frame_ids=[0, 1])
        active = state.active_count
        state, stats = tr.epoch_boundary(state, stats, 2)
    got = profiling.HOST_WAITS - before
    assert state.active_count != active
    recs = rec.records
    steps = [i for i, r in enumerate(recs) if r.name == "step"]
    for i in steps:
        kids = {r.name: r for r in recs if r.parent == i}
        assert set(kids) == set(STAGES) - {"raster_bwd"} | {"stats"}
        assert kids["stats"].waits == {"stats.mask": 8}
    table = rec.stage_table("step")
    assert table["roots"] == 2 and table["stages"]["stats"]["count"] == 2
    bound = [i for i, r in enumerate(recs) if r.name == "boundary"]
    assert len(bound) == 1 and recs[bound[0]].parent is None
    assert [(r.name, r.parent) for r in recs if r.root == bound[0]] == [
        ("boundary", None), ("densify", bound[0]), ("resort", bound[0])]
    table = rec.stage_table("boundary", last=1)
    assert table["roots"] == 1 and table["device_ms"] is None
    assert set(table["stages"]) == {"densify", "resort", "other"}
    assert table["stages"]["densify"]["waits"] == BOUNDARY_WAITS
    assert table["stages"]["resort"]["waits"] == {}
    # every densify.* mark of the epoch and its boundary is inside it
    assert {k: n for k, n in got.items()
            if k.startswith("densify.")} == BOUNDARY_WAITS


def test_boundary_is_bitwise_the_same_with_spans_on(task):
    tr, state, stats = _densify_trainer(task)
    state, stats, _ = tr.run_epoch(state, stats, 2, frame_ids=[0, 1])
    draws = tr.generator.get_state()
    profiling.RECORDER.clear()
    off, s_off = tr.epoch_boundary(state, stats, 2)
    assert profiling.RECORDER.records == []
    # the same inputs and draws again, spans on
    tr.generator.set_state(draws)
    with profiling.recording() as rec:
        on, s_on = tr.epoch_boundary(state, stats, 2)
    assert rec.stage_table("boundary")["roots"] == 1
    assert off.active_count == on.active_count != state.active_count
    for k, v in off.params.fields().items():
        assert torch.equal(v, on.params.fields()[k]), k
        assert torch.equal(off.adam.exp_avg[k], on.adam.exp_avg[k]), k
        assert torch.equal(off.adam.exp_avg_sq[k], on.adam.exp_avg_sq[k]), k
    for a, b in zip(s_off, s_on):
        assert torch.equal(a, b)
