"""The training mix: ``litegs_torch.training.trainer.Trainer`` over the
scene, from the configuration's protocol epoch, on the Trainer's own
frame permutation.

Set-up builds one Trainer and its state, drives it through the mix's
``check_steps`` first steps (one frame each, through ``run_epoch``, the
window's own call) and hands it on to the window.  The window calls
``run_epoch`` on slices of the permutation of ``slice_share`` of an
epoch and ``epoch_boundary`` at each epoch's end until ``--seconds`` have
passed; it counts every view over all of its time.  The reference then
follows the check steps from the same parameters, cameras and targets.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from .. import check as numbers
from .. import scene
from .. import work as counts
from ..reference import train as ref_train


def _sync(run):
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def _cam(cams: dict, i: int) -> dict:
    return {k: v[i] for k, v in cams.items()}


def inputs(run):
    """What the benchmark makes from the seed and hands to both sides:
    cameras, targets, the model, the frame order of the first epoch, and
    the configuration's parameter groups (the port's defaults otherwise)."""
    from litegs_torch import config as pcfg
    from litegs_torch.training.densify import densify_until_epoch

    cfg, mix, dev = run.config, run.traffic, run.device
    m = cfg["model"]
    h, w, nv = cfg["img_h"], cfg["img_w"], cfg["train_views"]
    centers = scene.capture_centers(nv, m["camera_radius"], m["camera_seed"])
    run.cams = scene.camera_tensors(centers, h, w, m["fov_deg"], dev)
    run.gts = scene.targets(nv, h, w, run.seed, dev)
    run.capacity = pcfg.auto_capacity(
        cfg["target_primitives"]).primitive_capacity
    run.active = cfg["active_primitives"]
    run.raw = scene.model(run.active, run.capacity, cfg["sh_degree"],
                          run.seed, m["extent"], dev, m)
    run.p0 = scene.to_host(run.raw)
    run.spatial_scale = scene.spatial_lr_scale(centers)
    run.lp = pcfg.ModelParams(sh_degree=cfg["sh_degree"])
    run.op = dataclasses.replace(pcfg.OptimizationParams(),
                                 **cfg["optimization"])
    run.pp = pcfg.PipelineParams(tile_size=tuple(cfg["tile_size"]))
    run.dp = dataclasses.replace(pcfg.DensifyParams(), **cfg["densify"])
    start = mix["start_epoch"]
    total = max(run.op.iterations // nv, 1)
    run.epoch = (densify_until_epoch(run.dp, total)
                 if start == "densify_until" else int(start))
    run.step0 = run.epoch * nv
    # the Trainer's generator (seeded with the seed) draws the order
    run.generator = torch.Generator().manual_seed(run.seed)
    run.perm = torch.randperm(nv, generator=run.generator).tolist()
    run.check_frames = run.perm[:mix["check_steps"]]
    run.check_gts = [run.gts[i].detach().cpu().clone()
                     for i in run.check_frames]


def setup(run):
    from litegs_torch import config as pcfg
    from litegs_torch.scene.gaussians import GaussianModel
    from litegs_torch.training import statistics
    from litegs_torch.training.optimizer import init_adam
    from litegs_torch.training.trainer import CameraBatch, TrainState, Trainer

    inputs(run)
    data = CameraBatch(view=run.cams["view"], proj=run.cams["proj"],
                       planes=run.cams["planes"], center=run.cams["center"],
                       images=run.gts)
    trainer = Trainer(run.lp, run.op, run.pp, run.dp,
                      pcfg.CapacityParams(run.capacity), data,
                      run.spatial_scale, seed=run.seed)
    # the Trainer's own generator draws every epoch's order; the first
    # is the one inputs() drew from an identical generator
    if torch.randperm(run.config["train_views"],
                      generator=trainer.generator).tolist() != run.perm:
        raise RuntimeError("the Trainer's generator is not seeded with the "
                           "seed")
    # the Trainer is handed a model and never builds one: the densify
    # budget's ramp starts from the primitives it was handed
    trainer.init_points_num = run.active
    params = GaussianModel(**run.raw)
    run.raw = None
    state = TrainState(params=params, adam=init_adam(params),
                       active_count=run.active, step=run.step0)
    stats = statistics.init_stats(run.capacity, run.device)
    losses = []
    for i, f in enumerate(run.check_frames):
        state, stats, met = trainer.run_epoch(state, stats, run.epoch,
                                              frame_ids=[f])
        losses.append(met["loss"])
        if i == 0:
            m1 = {kk: v.detach().cpu().clone()
                  for kk, v in state.adam.exp_avg.items()}
            # the first step's statistics (update_stats returns new
            # tensors: later steps leave these as they are)
            run.stats1 = stats
    p3 = {kk: v.detach().cpu() for kk, v in state.params.fields().items()}
    run.prog = {"losses": losses, "m1": m1,
                "delta": {kk: p3[kk] - run.p0[kk] for kk in p3}}
    run.trainer, run.state, run.stats = trainer, state, stats
    run.pos = len(run.check_frames)      # next frame of run.perm
    _sync(run)


def _advance(run):
    """Once an epoch's frames are all taken, start the next epoch on the
    Trainer's next permutation (drawn after the epoch's boundary, as
    ``Trainer.run_epoch`` draws it)."""
    nv = run.config["train_views"]
    if run.pos >= nv:
        run.epoch += 1
        run.perm = torch.randperm(nv, generator=run.trainer.generator).tolist()
        run.pos = 0


def _slices(run):
    """The window's calls: (epoch, frames, epoch ends after them).  A
    second call after a first that stopped on an epoch's end begins with
    the next epoch."""
    nv = run.config["train_views"]
    size = max(1, math.ceil(nv * run.traffic["slice_share"]))
    while True:
        _advance(run)
        frames = run.perm[run.pos:run.pos + size]
        run.pos += len(frames)
        yield run.epoch, frames, run.pos >= nv


def window(run):
    tr = run.trainer
    views, marks = 0, []
    t0 = time.perf_counter()
    for epoch, frames, end in _slices(run):
        run.state, run.stats, _ = tr.run_epoch(run.state, run.stats, epoch,
                                               frame_ids=frames)
        views += len(frames)
        if end:
            run.state, run.stats = tr.epoch_boundary(run.state, run.stats,
                                                     epoch)
        marks.append(time.perf_counter() - t0)
        if marks[-1] >= run.seconds:
            break
    _sync(run)
    run.window = {"views": views, "seconds": time.perf_counter() - t0,
                  "slice_ends_s": marks}


def traced(run):
    """Profile ``trace_views`` more steps; keep the parameters they start
    from and their frames for the work counts."""
    from .. import trace
    k = run.traffic["trace_views"]
    nv = run.config["train_views"]
    frames = [run.perm[(run.pos + i) % nv] for i in range(k)]
    run.trace_frames = frames
    run.trace_raw = {kk: v.detach().cpu().clone()
                     for kk, v in run.state.params.fields().items()}
    run.trace_active = run.state.active_count
    with trace.profiled(lambda: _sync(run)) as out:
        run.state, run.stats, _ = run.trainer.run_epoch(
            run.state, run.stats, run.epoch, frame_ids=frames)
    run.trace = trace.summarize(out["prof"], out["wall_s"])
    run.trace["views"] = k


def release(run):
    for name in ("trainer", "state", "stats", "gts"):
        setattr(run, name, None)


def _ref_cfg(run):
    cfg = run.config
    return dict(sh_degree=cfg["sh_degree"], img_h=cfg["img_h"],
                img_w=cfg["img_w"], tile=tuple(cfg["tile_size"]),
                chunk=run.pp.cluster_size)


def reference_steps(run, low=None, fault=None, first_stats=None):
    """The reference's check steps from the benchmark's parameters:
    {"losses", "grad", "delta"}; ``first_stats``
    (``reference.statistics.zeros``) gets the first step's statistics."""
    op = run.op
    opt = {k: getattr(op, k) for k in (
        "position_lr_init", "position_lr_final", "position_lr_max_steps",
        "scaling_lr", "rotation_lr", "feature_lr", "opacity_lr",
        "lambda_dssim")}
    raw = {k: v.to(run.device, copy=True) for k, v in run.p0.items()}
    cams = [_cam(run.cams, f) for f in run.check_frames]
    gts = [g.to(run.device) for g in run.check_gts]
    losses, first = ref_train.run_steps(
        raw, run.active, cams, gts, run.step0, opt=opt,
        spatial_scale=run.spatial_scale, max_pairs=run.max_pairs, low=low,
        fault=fault, first_stats=first_stats, **_ref_cfg(run))
    delta = {k: raw[k].cpu() - run.p0[k] for k in raw}
    return {"losses": losses, "grad": {k: v.cpu() for k, v in first.items()},
            "delta": delta}


def check(run):
    ref = reference_steps(run)
    grad = {k: v / (1 - ref_train.BETA1) for k, v in run.prog["m1"].items()}
    run.detail = {"grad": numbers.leaf_gaps(grad, ref["grad"]),
                  "step": numbers.leaf_gaps(run.prog["delta"], ref["delta"]),
                  "loss": numbers.loss_gaps(run.prog, ref)}
    return numbers.train_numbers(run.prog, ref)


def work(run):
    """Per traced view: the work counts of its frame at the traced
    stretch's starting parameters."""
    raw = {k: v.to(run.device) for k, v in run.trace_raw.items()}
    c = _ref_cfg(run)
    return [counts.count_view(raw, run.trace_active, _cam(run.cams, f),
                            c["sh_degree"], c["img_h"], c["img_w"],
                            c["tile"], c["chunk"], run.max_pairs)
            for f in run.trace_frames]
