"""The densification phase: ``Trainer.run_epoch`` and ``epoch_boundary``
from a statistics epoch of LiteGS's taming ramp, the statistics, densify
and the Morton resort included.

Set-up hands the Trainer what a run holds at the start of the mix's
``start_epoch``: the ramp starts from ``init_primitives`` (the SfM
points), and the live primitives are the ramp's target after the last
event before that epoch, trimmed to whole chunks, at the configuration's
capacity; the scene is made at that count.  The check steps are the
epoch's first ``check_steps`` views, through ``train.setup``; the
statistics compared are the first step's, as the gradient is.

The window runs whole periods: the rest of a statistics epoch, its
``epoch_boundary`` (densify, then the resort), and the plain epochs up to
the next statistics epoch.  It ends at the period end nearest to
``--seconds``, the next period taken to last as long as the last one.
It counts every view
over all of its time, less the host copies taken around its first
``epoch_boundary``: that call's inputs (parameters, moments, statistics,
live count, the Trainer's generator) and outputs, which the reference
replays and compares.  With ``--trace 1`` the next statistics epoch runs
up to its last ``trace_views`` views, those are profiled, and then its
``epoch_boundary`` is profiled alone.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from .. import check as numbers
from ..reference import densify as ref_densify
from ..reference import statistics as ref_stats
from . import train
from .train import release, work  # noqa: F401  (this loop's own)


def _dp(config) -> dict:
    from litegs_torch import config as pcfg
    return dataclasses.asdict(dataclasses.replace(pcfg.DensifyParams(),
                                                  **config["densify"]))


def handover(config: dict, mix: dict, chunk: int = 128) -> int:
    """Live primitives at the start of ``start_epoch``: the ramp's target
    after the previous statistics epoch's event, trimmed to whole
    chunks."""
    dp = _dp(config)
    total = max(config["optimization"]["iterations"]
                // config["train_views"], 1)
    until = ref_densify.densify_until(dp, total)
    last = mix["start_epoch"] - dp["densification_interval"]
    target = ref_densify.ramp_target(dp, until, mix["init_primitives"], last)
    return int(target) // chunk * chunk


def setup(run):
    run.config = dict(run.config,
                      active_primitives=handover(run.config, run.traffic))
    train.setup(run)
    run.trainer.init_points_num = run.traffic["init_primitives"]
    run.prog["stats"] = _host(run.stats1._asdict())
    run.stats1 = run.event = None


def _host(d: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in d.items()}


def _snapshot(run) -> dict:
    s = run.state
    leaves = _host(s.params.fields())
    for m, d in zip(ref_densify.MOMENTS, s.adam):
        leaves.update({f"{m}.{k}": v for k, v in _host(d).items()})
    return {"leaves": leaves, "active": s.active_count}


def window(run):
    tr = run.trainer
    views, marks, periods, copies = 0, [], [], 0.0
    t0 = time.perf_counter()
    for epoch, frames, end in train._slices(run):
        run.state, run.stats, _ = tr.run_epoch(run.state, run.stats, epoch,
                                               frame_ids=frames)
        views += len(frames)
        first = end and run.event is None and tr.is_densify_active(epoch)
        if first:
            train._sync(run)
            t = time.perf_counter()
            run.event = {"before": dict(
                _snapshot(run), stats=_host(run.stats._asdict()),
                generator=tr.generator.get_state(), epoch=epoch)}
            copies += time.perf_counter() - t
        if end:
            run.state, run.stats = tr.epoch_boundary(run.state, run.stats,
                                                     epoch)
        if first:
            train._sync(run)
            t = time.perf_counter()
            run.event["after"] = _snapshot(run)
            copies += time.perf_counter() - t
        marks.append(time.perf_counter() - t0 - copies)
        if end and tr.is_densify_active(epoch + 1):
            periods.append(marks[-1])
            last = periods[-1] - (periods[-2] if len(periods) > 1 else 0.0)
            if periods[-1] + last / 2 >= run.seconds:
                break
    train._sync(run)
    run.window = {"views": views,
                  "seconds": time.perf_counter() - t0 - copies,
                  "slice_ends_s": marks, "period_ends_s": periods,
                  "copies_s": copies}


def traced(run):
    """The next statistics epoch up to its last ``trace_views`` views
    untraced, those views profiled (``train.traced``), then its
    ``epoch_boundary`` profiled alone."""
    from .. import trace
    tr = run.trainer
    nv = run.config["train_views"]
    k = run.traffic["trace_views"]
    train._advance(run)
    if run.pos or not tr.is_densify_active(run.epoch):
        raise RuntimeError("the traced stretch starts a statistics epoch")
    head = run.perm[:nv - k]
    if head:
        run.state, run.stats, _ = tr.run_epoch(run.state, run.stats,
                                               run.epoch, frame_ids=head)
    run.pos = nv - k
    train.traced(run)
    run.pos = nv
    with trace.profiled(lambda: train._sync(run)) as out:
        run.state, run.stats = tr.epoch_boundary(run.state, run.stats,
                                                 run.epoch)
    run.boundary_trace = trace.summarize(out["prof"], out["wall_s"])


def replay(run, fault=None, box="live") -> dict:
    """The reference's replay of the window's first ``epoch_boundary``
    from the copies of its inputs."""
    b = run.event["before"]
    dev = run.device
    dp = dataclasses.asdict(run.dp)
    total = max(run.op.iterations // run.config["train_views"], 1)
    return ref_densify.event(
        {k: v.to(dev) for k, v in b["leaves"].items()},
        {k: v.to(dev, torch.float32) for k, v in b["stats"].items()},
        b["active"], b["epoch"], dp, ref_densify.densify_until(dp, total),
        run.traffic["init_primitives"], run.spatial_scale,
        run.pp.cluster_size, b["generator"], fault=fault, box=box)


def _event_numbers(after: dict, ref: dict, dev) -> dict:
    return numbers.event_numbers(
        {k: v.to(dev) for k, v in after["leaves"].items()}, after["active"],
        ref["leaves"], ref["active"])


def _reference_stats(run, **kw):
    stats = ref_stats.zeros(run.capacity, run.device,
                            kw.pop("dtype", torch.float32))
    ref = train.reference_steps(run, first_stats=stats, **kw)
    ref["stats"] = {k: v.float().cpu() for k, v in stats.items()}
    return ref


def check(run):
    run.ref = ref = _reference_stats(run)
    out = numbers.train_numbers(run.prog, ref)
    out.update(numbers.stats_numbers(run.prog["stats"], ref["stats"]))
    run.ref_event = truth = replay(run)
    after = run.event["after"]
    out.update(_event_numbers(after, truth, run.device))
    # the same replay with the resort's box over every slot of the
    # capacity, parked ones included: where this agrees and the replay
    # does not, the resort alone differs
    witness = _event_numbers(after, replay(run, box="capacity"), run.device)
    grad = {k: v / (1 - train.ref_train.BETA1)
            for k, v in run.prog["m1"].items()}
    b = run.event["before"]
    run.detail = {
        "grad": numbers.leaf_gaps(grad, ref["grad"]),
        "step": numbers.leaf_gaps(run.prog["delta"], ref["delta"]),
        "loss": numbers.loss_gaps(run.prog, ref),
        "stats": numbers.field_gaps(run.prog["stats"], ref["stats"]),
        "event": {"epoch": b["epoch"], "active_before": b["active"],
                  "appended": truth["appended"], "pruned": truth["pruned"],
                  "active_after": after["active"],
                  "reference_active_after": truth["active"],
                  "mismatch_share_box_over_capacity":
                  witness["event_mismatch_share"]},
        "copies_s": run.window["copies_s"]}
    return out


# what put in the program's place has to fail the cell's numbers: the
# control (statistics accumulated in bfloat16) and the planted faults
VARIANTS = ("bfloat16_stats", "field_halved", "half_batch",
            "colour_grad_doubled") + ref_densify.FAULTS


def readings(run, variants=VARIANTS) -> dict:
    """The program's numbers (``program``) and each variant's, from one
    run of set-up and a window of one period."""
    run.seconds = 0.0
    setup(run)
    window(run)
    release(run)
    out = {"program": check(run)}
    truth, sound = run.ref, run.ref_event
    for v in variants:
        prog = {"losses": truth["losses"], "delta": truth["delta"],
                "m1": {k: g * (1 - train.ref_train.BETA1)
                       for k, g in truth["grad"].items()},
                "stats": truth["stats"]}
        event = sound
        if v in ("bfloat16_stats", "half_batch", "colour_grad_doubled"):
            r = (_reference_stats(run, dtype=torch.bfloat16)
                 if v == "bfloat16_stats"
                 else _reference_stats(run, fault=v))
            prog.update(losses=r["losses"], delta=r["delta"],
                        stats=r["stats"],
                        m1={k: g * (1 - train.ref_train.BETA1)
                            for k, g in r["grad"].items()})
        elif v == "field_halved":
            prog["stats"] = dict(truth["stats"],
                                 weight_sum=truth["stats"]["weight_sum"] / 2)
        else:
            event = replay(run, fault=v)
        nums = numbers.train_numbers(prog, truth)
        nums.update(numbers.stats_numbers(prog["stats"], truth["stats"]))
        nums.update(numbers.event_numbers(event["leaves"], event["active"],
                                          sound["leaves"], sound["active"]))
        out[v] = nums
    return out
