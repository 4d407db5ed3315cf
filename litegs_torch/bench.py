"""The port's headline benchmark: train iterations per second at garden
scale on one card (the port of the root ``bench.py``).

    python -m litegs_torch.bench

Mirrors the reference's aggressive protocol scale (BASELINE.md: MipNeRF-360
garden, 1M primitives, images_4 ~1.1 Mpix, 10k iterations in 53 s on an RTX
3090, ~189 train iterations/s) on a procedurally generated scene of the
same compute shape: 1M gaussians filling the frustum (log-scales shrunk by
0.7, SH degree 3), 840x1296 frames with random targets, the full forward,
backward and sparse-Adam step, steady state (no statistics collection, the
reference's non-densify-epoch hot loop).

Prints ONE JSON line on stdout, with the root script's keys per mode and
its numbers unrounded (the root script rounds them to 2 and 4 places):

* train (default): ``{"metric": "train_iters_per_sec", "value", "unit":
  "iters/s", "vs_baseline" (value / 189), "mpix_per_sec",
  "pct_of_baseline"}``;
* ``BENCH_MODE=render``: ``render_mpix_per_sec`` through
  ``make_eval_render``, against 245 Mpix/s;
* ``BENCH_B`` = B > 1: ``train_views_per_sec`` through
  ``make_batch_train_step`` (B views per step, one raster launch), against
  189.

Diagnostics go to stderr: device, raster backend, sizes, tile, iterations,
elapsed time, final loss, peak device memory and the card's name and power
limit.  Knobs (environment): ``BENCH_POINTS``, ``BENCH_H``, ``BENCH_W``,
``BENCH_ITERS``, ``BENCH_FRAMES`` (4), ``BENCH_TILE`` (``32x24``, height x
width), ``BENCH_MODE``, ``BENCH_B``, ``BENCH_PERFRAME`` (per-frame ms lines)
and ``BENCH_BACKEND`` (``cuda``, the hand-written kernels, or ``torch``,
the plain version).  On the card the defaults are 1,000,000 points,
840x1296, 60 iterations and ``cuda``; with ``device="cpu"`` they are
20,000 points, 128x256, 3 iterations and ``torch``.

The root script first probes each frame's table sizes to pick capacity
buckets for its compiled step (and reads ``BENCH_MARGIN`` for them).  The
port sizes its buffers from the data and cannot overflow
(``training/trainer.py``), so it has no probe, does not read
``BENCH_MARGIN`` and reports no ``overflow``.  Steps are timed with the
host clock between two ``torch.cuda.synchronize()`` calls; the timed loop
reads nothing back to the host beyond what the step itself does.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from . import config as cfg
from .data import synthetic
from .scene import create_gaussians, pad_params
from .scene.gaussians import GaussianModel
from .training import statistics
from .training.optimizer import init_adam
from .training.trainer import (CameraBatch, TrainState,
                               camera_batch_from_frames,
                               make_batch_train_step, make_eval_render,
                               make_train_step, masked_chunk_aabb)
from .utils import resolve_device

BASELINE_ITERS_PER_SEC = 189.0  # RTX 3090, garden @1M prims (BASELINE.md)
BASELINE_RENDER_MPIX = 245.0    # RTX 3090, effective fwd+bwd Mpix/s
SH_DEGREE = 3


class Workload(NamedTuple):
    params: GaussianModel   # padded to a multiple of 128 * 128 points
    active_count: int       # the live points (n_points)
    batch: CameraBatch      # n_frames cameras and random targets
    origin: torch.Tensor    # masked_chunk_aabb of the live chunks
    extend: torch.Tensor


def make_workload(n_points: int, img_h: int, img_w: int, n_frames: int,
                  device="cuda") -> Workload:
    """The root bench's scene: ``make_gaussian_cloud(n_points, seed=0)``
    at SH degree 3 with log-scales - 0.7, padded to a multiple of 128 *
    128; ``make_cameras(n_frames, img_h, img_w, seed=0)`` with targets
    from ``default_rng(1)``; the chunk bounds of the live points."""
    dev = resolve_device(device)
    cam, frames = synthetic.make_cameras(n_frames, img_h, img_w, seed=0)
    xyz, rgb = synthetic.make_gaussian_cloud(n_points, seed=0)
    params = create_gaussians(xyz, rgb, SH_DEGREE, device=dev)
    # garden-like screen footprint (~3-5 table entries per visible point)
    with torch.no_grad():
        params.scale -= 0.7
    params = pad_params(params, cfg.round_up(n_points, 128 * 128))
    gt = np.random.default_rng(1).random(
        (n_frames, 3, img_h, img_w)).astype(np.float32)
    batch = camera_batch_from_frames(cam, frames, gt, device=dev)
    with torch.no_grad():
        origin, extend = masked_chunk_aabb(params, n_points,
                                           cfg.PipelineParams.cluster_size)
    return Workload(params, n_points, batch, origin, extend)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(device="cuda") -> dict:
    """Run the benchmark on ``device``; prints and returns the result."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    env = os.environ.get
    n_points = int(env("BENCH_POINTS", 1_000_000 if on_card else 20_000))
    img_h = int(env("BENCH_H", 840 if on_card else 128))
    img_w = int(env("BENCH_W", 1296 if on_card else 256))
    n_iters = int(env("BENCH_ITERS", 60 if on_card else 3))
    backend = env("BENCH_BACKEND", "cuda" if on_card else "torch")
    n_frames = int(env("BENCH_FRAMES", 4))
    th, tw = map(int, env("BENCH_TILE", "32x24").split("x"))
    mode = env("BENCH_MODE", "train")
    bviews = int(env("BENCH_B", "1"))
    if mode != "render" and bviews > 1 and n_frames % bviews:
        raise ValueError(f"BENCH_FRAMES={n_frames} is not a multiple of "
                         f"BENCH_B={bviews}")

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    w = make_workload(n_points, img_h, img_w, n_frames, dev)
    b = w.batch
    pp = cfg.PipelineParams(raster_backend=backend, tile_size=(th, tw))
    lp = cfg.ModelParams(sh_degree=SH_DEGREE)
    op = cfg.OptimizationParams()
    caps = cfg.CapacityParams(w.params.capacity)
    state = TrainState(params=w.params, adam=init_adam(w.params),
                       active_count=w.active_count, step=0)
    stats = statistics.init_stats(caps.primitive_capacity, dev)
    step_fn = make_train_step(lp, op, pp, caps, img_h, img_w,
                              spatial_lr_scale=1.0, sh_degree=SH_DEGREE,
                              collect_stats=False)

    def run(i):
        nonlocal state, stats
        f = i % n_frames
        state, stats, metrics = step_fn(
            state, stats, w.origin, w.extend, b.view[f], b.proj[f],
            b.planes[f], b.center[f], b.images[f])
        return metrics

    # warm-up: frame 0, then every frame once
    m = run(0)
    sync()
    for i in range(1, n_frames + 1):
        m = run(i)
    sync()

    def report(result: dict, elapsed: float, iters: int, metrics: dict):
        mem = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
               "peak" if on_card else "n/a (CPU)")
        print(f"[bench] device={dev} raster={backend} points={n_points} "
              f"img={img_h}x{img_w} tile={th}x{tw} frames={n_frames} "
              f"iters={iters} elapsed={elapsed:.3f}s "
              f"loss={float(metrics['loss']):.4f} "
              f"sizes={metrics['sizes'].tolist()} mem={mem}",
              file=sys.stderr)
        if on_card:
            print(f"[bench] card: {card_line()}", file=sys.stderr)
        print(json.dumps(result))
        return result

    if mode == "render":
        # forward-only throughput (BASELINE's 'rasterize Mpix/s per chip')
        ev = make_eval_render(pp, img_h, img_w, SH_DEGREE)
        ev(state.params, state.active_count, b.view[0], b.proj[0],
           b.planes[0], b.center[0])
        sync()
        t0 = time.perf_counter()
        for i in range(n_iters):
            f = i % n_frames
            ev(state.params, state.active_count, b.view[f], b.proj[f],
               b.planes[f], b.center[f])
        sync()
        elapsed = time.perf_counter() - t0
        mpix = img_h * img_w * n_iters / elapsed / 1e6
        return report({"metric": "render_mpix_per_sec", "value": mpix,
                       "unit": "Mpix/s",
                       "vs_baseline": mpix / BASELINE_RENDER_MPIX},
                      elapsed, n_iters, m)

    if bviews > 1:
        # B views per optimizer step through ONE raster launch; reports
        # views/s so the number stays comparable with the reference's
        # one-view-per-iteration loop
        bstep = make_batch_train_step(
            lp, op, pp, caps, img_h, img_w, spatial_lr_scale=1.0,
            sh_degree=SH_DEGREE, batch_views=bviews, collect_stats=False)

        def runb(i):
            nonlocal state, stats
            f = (i * bviews) % n_frames
            sl = slice(f, f + bviews)
            state, stats, metrics = bstep(
                state, stats, w.origin, w.extend, b.view[sl], b.proj[sl],
                b.planes[sl], b.center[sl], b.images[sl])
            return metrics

        m = runb(0)
        sync()
        for i in range(1, n_frames // bviews + 1):
            m = runb(i)
        sync()
        t0 = time.perf_counter()
        for i in range(n_iters):
            m = runb(i)
        sync()
        elapsed = time.perf_counter() - t0
        vps = n_iters * bviews / elapsed
        print(f"[bench] B={bviews}: {elapsed / n_iters * 1e3:.1f} ms/step "
              f"({bviews} views) = {vps:.2f} views/s", file=sys.stderr)
        return report({"metric": "train_views_per_sec", "value": vps,
                       "unit": "views/s",
                       "vs_baseline": vps / BASELINE_ITERS_PER_SEC},
                      elapsed, n_iters, m)

    t0 = time.perf_counter()
    for i in range(n_iters):
        m = run(i)
    t_enq = time.perf_counter() - t0
    sync()
    elapsed = time.perf_counter() - t0

    if env("BENCH_PERFRAME"):
        # diagnostic: steady-state ms/step per frame
        reps = max(4, n_iters // n_frames)
        for f in range(n_frames):
            for _ in range(2):
                run(f)
            sync()
            tf = time.perf_counter()
            for _ in range(reps):
                mf = run(f)
            sync()
            ms = (time.perf_counter() - tf) / reps
            print(f"[bench] frame {f}: {ms * 1e3:.1f} ms/step (sizes "
                  f"{mf['sizes'].tolist()})", file=sys.stderr)
        print(f"[bench] enqueue loop {t_enq * 1e3 / n_iters:.1f} ms/iter "
              f"(drain {(elapsed - t_enq) * 1e3 / n_iters:.1f})",
              file=sys.stderr)

    iters_per_sec = n_iters / elapsed
    return report({
        "metric": "train_iters_per_sec",
        "value": iters_per_sec,
        "unit": "iters/s",
        "vs_baseline": iters_per_sec / BASELINE_ITERS_PER_SEC,
        "mpix_per_sec": iters_per_sec * img_h * img_w / 1e6,
        "pct_of_baseline": 100.0 * iters_per_sec / BASELINE_ITERS_PER_SEC,
    }, elapsed, n_iters, m)


if __name__ == "__main__":
    main()
