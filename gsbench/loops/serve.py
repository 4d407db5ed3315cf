"""The viewer mix: ``make_eval_render`` over a flight of novel poses, one
client in a closed loop.

Each frame is timed from its call to a ``torch.cuda.synchronize()``.  The
frames compared with the reference are ``check_frames`` drawn from the
seed among the flight's first pass, and the slowest frame of the window;
the program's images of them are held as it returned them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import check as numbers
from .. import scene
from .. import work as counts
from ..reference import render as R


def _sync(run):
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def inputs(run):
    """The flight's cameras, the model, and the frames compared."""
    from litegs_torch import config as pcfg

    cfg, mix, dev = run.config, run.traffic, run.device
    m = cfg["model"]
    h, w = cfg["img_h"], cfg["img_w"]
    n = mix["poses"]
    centers = scene.orbit_centers(n, m["camera_radius"], run.seed)
    run.cams = scene.camera_tensors(centers, h, w, m["fov_deg"], dev)
    cap = pcfg.auto_capacity(cfg["target_primitives"]).primitive_capacity
    run.active = cfg["active_primitives"]
    raw = scene.model(run.active, cap, cfg["sh_degree"], run.seed,
                      m["extent"], dev, m)
    run.p0 = scene.to_host(raw)
    run.raw = raw
    run.pp = pcfg.PipelineParams(tile_size=tuple(cfg["tile_size"]))
    rng = np.random.default_rng(run.seed)
    run.check_frames = sorted(int(i) for i in rng.choice(
        min(n, 60), mix["check_frames"], replace=False))


def setup(run):
    from litegs_torch.scene.gaussians import GaussianModel
    from litegs_torch.training.trainer import make_eval_render

    inputs(run)
    cfg = run.config
    run.params = GaussianModel(**run.raw)
    run.raw = None
    run.render = make_eval_render(run.pp, cfg["img_h"], cfg["img_w"],
                                  cfg["sh_degree"])
    for i in range(run.traffic["warmup_frames"]):
        _frame(run, i)
    _sync(run)


def _frame(run, i: int):
    c = run.cams
    img, _ = run.render(run.params, run.active, c["view"][i], c["proj"][i],
                        c["planes"][i], c["center"][i])
    return img


def window(run):
    n = run.traffic["poses"]
    lat, kept, slowest = [], {}, (-1.0, None, None)
    t0 = time.perf_counter()
    i = 0
    while True:
        f = i % n
        t = time.perf_counter()
        img = _frame(run, f)
        _sync(run)
        dt = time.perf_counter() - t
        lat.append(dt)
        if i in run.check_frames:
            kept[f] = img
        if dt > slowest[0]:
            slowest = (dt, f, img)
        i += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.window = {"views": i, "seconds": time.perf_counter() - t0,
                  "latencies": lat}
    kept.setdefault(slowest[1], slowest[2])
    run.kept = {f: img.detach() for f, img in kept.items()}


def traced(run):
    from .. import trace
    k = run.traffic["trace_views"]
    n = run.traffic["poses"]
    run.trace_frames = [(run.window["views"] + j) % n for j in range(k)]
    with trace.profiled(lambda: _sync(run)) as out:
        for f in run.trace_frames:
            _frame(run, f)
    run.trace = trace.summarize(out["prof"], out["wall_s"])
    run.trace["views"] = k


def release(run):
    run.kept = {f: img.cpu() for f, img in run.kept.items()}
    run.params = run.render = None


def reference_images(run, frames, low=None):
    raw = {k: v.to(run.device, copy=True) for k, v in run.p0.items()}
    cfg = run.config
    th, tw = cfg["tile_size"]
    out = []
    for f in frames:
        cam = {k: v[f] for k, v in run.cams.items()}
        img, _ = R.render(raw, run.active, cam, cfg["sh_degree"], cfg["img_h"],
                          cfg["img_w"], th, tw, run.pp.cluster_size,
                          run.max_pairs, low=low)
        out.append(img.cpu())
    return out


def check(run):
    frames = sorted(run.kept)
    return numbers.image_numbers([run.kept[f] for f in frames],
                                 reference_images(run, frames))


def work(run):
    raw = {k: v.to(run.device, copy=True) for k, v in run.p0.items()}
    cfg = run.config
    return [counts.count_view(raw, run.active,
                              {k: v[f] for k, v in run.cams.items()},
                              cfg["sh_degree"], cfg["img_h"], cfg["img_w"],
                              tuple(cfg["tile_size"]), run.pp.cluster_size,
                              run.max_pairs)
            for f in run.trace_frames]
