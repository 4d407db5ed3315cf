"""Drive litegs_torch on one NVIDIA card: build, check, render, score, train.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc).  Phases, each of which
stops the script with a nonzero exit when it fails:

  0. versions and the card's name and power limit;
  1. build every kernel from litegs_torch/csrc (nvcc, sm_90a, one process
     per source, in parallel);
  2. each kernel against its plain PyTorch version: the raster kernels on
     small seeded scenes at the five supported tile sizes (the forward at
     max |diff| <= 1e-4, the backward with seeded cotangents, with and
     without statistics, at the bars in BWD_TOL); the four stream_gather
     kernels on seeded expansions and block gathers, equal exactly (with
     S not a multiple of 4 and attrs 4 bytes off 16-byte alignment, A =
     1, 3, 12 and 16, more steps than the asynchronous-copy kernel's
     persistent grid has blocks, a partial last step, int64 offsets past
     2^31 and below 0), the asynchronous-copy kernel on every step of
     those cases also against the plain model of its blocks
     (window_block_plain), slots past the total included;
  3. the serving path at full width -- 1,000,000 gaussians, SH degree 3,
     840x1296 images, 8x16 tiles, 4 views -- through
     evaluation.prepare_model / render_views / score_split, with every
     kernel's launch count read around that run (the default binning
     route, 'keys', runs its count, emit and ranges kernels once each per
     view, its sort's two kernels once a pass, and no plain version), the forward kernel held against its plain
     version on a sample of tiles of each view, and per view times (CUDA
     events, median of 5 after a warm-up); then the binning routes on view
     0: the tables of the default route, the window route, the
     asynchronous-copy route and the prefix route identical in every field
     to the non-streaming table, a render through each route with its
     launches counted, gather_blocks building the
     128-aligned copy of the table, expand_window_kernel and
     expand_window_async_kernel held to the plain models of their blocks
     (window_step_plain, window_block_plain) on sampled steps of both
     expansions, each stream_gather kernel's time alone and per call beside
     its plain version, one PyTorch call and its bytes bound, the window
     calls' remaining torch ops timed alone, gather_blocks also at the
     JAX package's own shape (scripts/debug_stream.py: 8 rows of 4,063,232
     items, 18,342 runs); then the 'keys' route alone on a view of the
     6M serving cell's shape (6,000,000 points from
     data.synthetic, 840x1296, 8x16 tiles): its table, and its plain
     version's run on the card, equal to the non-streaming table, the
     route and each step (count, scan, emit, sort, ranges) timed beside
     its bytes bound and the 'window' route;
  4. the training path on the same scene: make_train_step from the
     sh_0-perturbed model toward the unperturbed model's renders -- steady
     steps, then statistics steps, a taming densify step and the Morton
     resort, then steps on the grown model -- with the launch counts read
     around each window; per-step times, a per-stage split of one step,
     the backward kernel alone and against its plain version on sampled
     tiles of a real view; the streaming routes again on the trained
     model's view 0;
  5. the Trainer through its own API on the small synthetic task of
     tests/test_training.py, at that file's PSNR bars;
  6. the command line on a COLMAP scene at full width: ground-truth renders
     of the serving scene for 10 cameras written as a binary COLMAP scene
     (200,000 seed points, PNG images) under build/; python -m
     litegs_torch.example_train's main trains it (--eval: 8 train and 2
     test frames, SH 3, 1,000,000 target primitives, 8 epochs with two
     densify events, a checkpoint at epoch 2, a ply at 3, test PSNR at 3
     and 7); example_metrics scores the finish ply (its test PSNR within
     0.01 dB of training's last); a resume from the epoch-2 checkpoint
     restores the saved state bit for bit and finishes; a pose leg resumes
     a checkpoint of the ground-truth gaussians with noisy extrinsics and
     refines them at tests/test_pose.py's bars, writing viewproj.npz; the
     raster and binning kernels' launches are read around each leg (0
     plain calls); then one learnable-pose step at 96x128 with the 'cuda'
     backend held to the 'torch' backend's extr gradient;
  7. batched views on the serving scene: render_batch at B = 2 and 4 (one
     forward launch over a merged B x T tile grid whose tile rows wrap per
     view) bit-equal to B single renders (images, tile outputs,
     primitive_visible, sizes), the merged backward at BWD_TOL of the B
     single backwards with frag_count equal, both merged kernels timed
     against the sum of their single launches; one make_batch_train_step
     at B = 2 against the mean of two single-view losses through the same
     sparse Adam (parameters within 1e-5 of each field's largest value,
     moments at the gradient bar); ms per step and per view, device busy
     time and kernels per step at B = 1, 2 and 4; and example_train
     --batch_views 2 on phase 6's COLMAP scene beside phase 6's B = 1 run;
     every launch counted;
  8. evaluation and data parallelism on the serving scene: LPIPS-vgg with
     seeded random weights through LPIPS_WEIGHTS (a 3x128x160 crop on the
     card within 1e-4 relative of the CPU module in float64, ms per
     full-width pair, score_split's LPIPS over the 4 views and its
     seconds); on an NCCL group of one rank, 8 make_parallel_train_step
     steps (float32 wire, sharded statistics) each within PAR_TOL of
     make_train_step's update from the same state, the bf16 wire's losses
     within 1e-3 relative of the float32 wire's, ms per step both ways and
     the all-reduce spans' own time at both wire dtypes; the sharded
     densify bit-equal to densify_step on the run's statistics and the
     time of its 32 bisection rounds; then torchrun --nproc_per_node 1
     python -m litegs_torch.example_train --parallel on, on phase 6's
     COLMAP scene at phase 6's depth, its test PSNR within 0.5 dB of
     phase 6's Trainer run and its finish ply written by rank 0;
  9. the port's bench line: litegs_torch.bench's main in process at its
     defaults (1,000,000 points, 840x1296, 4 frames, 32x24 tiles, 60
     iterations) in train mode, render mode and at BENCH_B=2, each run's
     one stdout line held to the keys of the root bench.py's json.dumps
     dict of that mode (read from its source), its value finite and
     positive, and every launch of the path's kernels counted (0 plain
     calls);
 10. the speed challenge: litegs_torch.challenge_train at its 5,000
     iterations on phase 6's COLMAP scene with phase 6's other flags, then
     litegs_torch.challenge_eval on its model: the output JSON's four keys,
     a positive train time, a test PSNR no more than 1 dB below phase 6's,
     every launch counted;
 11. convergence checks and ablation sweeps: (a) litegs_torch.
     synthetic_convergence's main in process with CONVERGENCE_r5.md's
     command (1.2M-point ground truth, a 150,000-point init densified
     toward 1,000,000, 10 frames, SH 3, 32x24 tiles) at 840x1296 and cut
     to 2,000 iterations: its final active count at least 95 % of the
     target, its final train PSNR 10 dB above epoch 0's, every loss
     finite, the trajectory, it/s and peak memory printed, every launch
     counted; (b) ablations_densify's two variants and (c)
     ablations_culling's three on phase 6's COLMAP scene, each variant a
     child process checked by its exit code and printed lines (official
     ADC changes its primitive count; the plain raster path's test PSNR
     within 0.1 dB of the kernels'; culling off printed beside them); (d)
     torchrun --nproc_per_node 1 -m litegs_torch.convergence_parallel at
     48 iterations: exit 0 and four rows;
 12. a JSON line with one record per kernel, the card's name and power
     limit as nvidia-smi prints them, and as the last line
     {"ok": true, "device": {...}}.

It imports neither JAX nor litegs_tpu.
"""
from __future__ import annotations

import ast
import contextlib
import io
import json
import math
import os
import re
import shutil
import signal
import statistics
import struct
import subprocess
import sys
import time

import numpy as np

TOL = 1e-4              # forward kernel vs plain version, max |diff|
# backward kernel vs plain version: per-point gradients and err_sum as
# max |diff| / max |plain| (the scaled bar of tests/test_raster_pallas.py),
# weight_sum absolute, frag_count absolute (counts), err_square_sum
# scaled.  err_square_sum's bar is new: a square doubles the relative error
# of each pair's opacity gradient, and the kernel carries its prefix in
# float32 where the plain version sums it in float64.
BWD_TOL = {"grad": 3e-4, "weight_sum": 2e-3, "frag_count": 0.5,
           "err_square_sum": 1e-3}
# frag_count on a real view: a pixel whose transmittance crosses 1/8192
# within float32 rounding may stop one entry apart in the kernel (a
# sequential float32 product) and the plain version (a float64 log-sum),
# as the forward's 1e-4 bar allows for its colours.  There the counts may
# differ in total by STOP_FLIP_RATE of the contributing pairs (one in
# 100,000); a stop rule that differed would miss by about one pair per
# pixel.  On the seeded scenes of phase 2 the counts must be equal.
STOP_FLIP_RATE = 1e-5
TILE_SIZES = ((8, 16), (16, 16), (16, 32), (32, 24), (32, 32))
N_POINTS = 1_000_000
IMG_H, IMG_W = 840, 1296
N_VIEWS = 4
SH_DEGREE = 3
REPEATS = 5
SAMPLE_TILES = 64
# profiler windows a kernel's time alone may take (kernel_device_ms)
PROFILE_WINDOWS = 3
# training phase: steps per window, the warm-up steps left out of the
# per-step median, the sh_0 perturbation, and growth room
STEADY_STEPS = 24
WARMUP_STEPS = 4
STATS_STEPS = 4
GROWN_STEPS = 4
SH0_NOISE = 0.3
CAPACITY_FACTOR = 1.6
# densify ramp: at epoch 1 of [0, 2) the taming target is halfway from the
# model's 1M primitives to TARGET_PRIMITIVES, i.e. about 1.2M
TARGET_PRIMITIVES = 1_400_000
BASELINE_ITS = 189.0    # reference LiteGS, garden, RTX 3090 (BASELINE.md)
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per (entry, pixel) pair the raster kernels walk: two
# subtractions, nine multiplies and two adds for the exponent, the exp and
# the opacity product (the forward's blend of contributing pairs is not
# counted, so its bound is a lower bound)
OPS_PER_PAIR = 15
# the backward's further operations per contributing pair (raster_bwd.cu):
# clamp, w, c.dC (2C), prefix (2), d_alpha (4), dpw, d_color (C), d_mean
# (8), d_inv_cov (9), the T update and its test (3) -- about 40 at C = 3 --
# plus one add per reduced column (K) for the sum over the tile's pixels
OPS_PER_CONTRIB_BWD = 40
# FP32 operations of the per-warp cull's box for one entry of a tile
# (raster_common.cuh::warp_mask: shrink, determinant, level, two radii;
# each logarithm, division and square root counted as one, the block
# compares left out)
OPS_PER_CULL = 20

FWD_RECORD = {"name": "raster_forward", "route": "cuda",
              "source": "litegs_torch/csrc/raster_fwd.cu",
              "replaces": "litegs_tpu/ops/raster_pallas.py:296"}
BWD_RECORD = {"name": "raster_backward", "route": "cuda",
              "source": "litegs_torch/csrc/raster_bwd.cu",
              "replaces": "litegs_tpu/ops/raster_pallas.py:384"}
KEYS_RECORD = {"name": "bin_count_kernel, bin_emit_kernel, "
               "bin_sort_count_kernel, bin_sort_scatter_kernel, "
               "bin_ranges_kernel (the 'keys' binning route)",
               "route": "cuda", "source": "litegs_torch/csrc/binning.cu",
               "replaces": None}
# the view the 'keys' route is timed on alone: the 6M serving cell's shape
# (6,000,000 points in a ball of radius 1.5, log-scales of the density's
# spacing less 1 with a spread of 0.5 an axis, 55% opaque at logit 3 and
# the rest at -2.5, SH 0), one camera of synthetic.make_cameras at
# IMG_H x IMG_W, 8x16 tiles, made from KEYS_SEED
KEYS_POINTS = 6_000_000
KEYS_SEED = 7
SG_SOURCE = "litegs_torch/csrc/stream_gather.cu"
SG_RECORDS = {
    "expand_prefix_kernel": {
        "name": "expand_prefix_kernel", "route": "cuda", "source": SG_SOURCE,
        "replaces": "litegs_tpu/ops/stream_gather.py:68"},
    "expand_window_kernel": {
        "name": "expand_window_kernel", "route": "cuda", "source": SG_SOURCE,
        "replaces": "litegs_tpu/ops/stream_gather.py:166"},
    "expand_window_async_kernel": {
        "name": "expand_window_async_kernel", "route": "cuda",
        "source": SG_SOURCE,
        "replaces": "litegs_tpu/ops/stream_gather.py:341"},
    "gather_blocks_kernel": {
        "name": "gather_blocks_kernel", "route": "cuda", "source": SG_SOURCE,
        "replaces": "litegs_tpu/ops/stream_gather.py:382"},
}
# COLMAP phase: cameras, seed points, epochs of the training run and of
# the pose leg (tests/test_pose.py's 20), and the image size of the
# learnable-pose step held between the two backends
COLMAP_VIEWS = 10
COLMAP_SEED_POINTS = 200_000
COLMAP_TARGET = 1_000_000
COLMAP_EPOCHS = 8
POSE_EPOCHS = 20
POSE_STEP_HW = (96, 128)
COLMAP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_colmap")
# batched views (phase 7): the batch sizes held to single views and timed,
# the timed steps per batch size, the warm-up steps left out of their
# median, and the steps profiled
BATCH_SIZES = (2, 4)
BATCH_STEPS = 8
BATCH_WARMUP = 2
BATCH_PROFILE_STEPS = 4
# evaluation and data parallelism (phase 8): the LPIPS crop held to the
# CPU module in float64 and its relative bar; the data-parallel steps and
# the per-field bar of each update against make_train_step's (w = 1 and
# wsum = 1 make the mean exact, so 0 is expected but for the backward
# kernel's atomics, which may add in another order), the bf16 wire's
# relative bar on the losses, the profiled steps per wire dtype, and the
# bar on the torchrun CLI's test PSNR against phase 6's Trainer
LPIPS_CROP = (128, 160)
LPIPS_RTOL = 1e-4
PAR_STEPS = 8
PAR_TOL = 1e-5
BF16_LOSS_RTOL = 1e-3
PAR_PROFILE_STEPS = 2
CLI_PSNR_TOL = 0.5
PAR_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "build", "chip_smoke_parallel")
# the bench (phase 9): its modes (label, environment, metric), the
# iterations and frames of its defaults, and the root bench.py whose
# json.dumps keys each line must carry
BENCH_MODES = (("train", {}, "train_iters_per_sec"),
               ("render", {"BENCH_MODE": "render"}, "render_mpix_per_sec"),
               ("B=2", {"BENCH_B": "2"}, "train_views_per_sec"))
BENCH_ITERS = 60
BENCH_FRAMES = 4
ROOT_BENCH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "bench.py")
# the speed challenge (phase 10): its iterations, and how far its test
# PSNR may fall below phase 6's 64-step run
CHALLENGE_ITERS = 5000
CHALLENGE_PSNR_TOL = 1.0
# convergence and ablations (phase 11): CONVERGENCE_r5.md's command
# (densify 150k toward 1M), run at IMG_H x IMG_W instead of its 256x384
# and cut from 6,000 iterations to CONV_ITERS; its bars (a final active
# count of CONV_ACTIVE_SHARE of the target, a train PSNR CONV_PSNR_GAIN dB
# above epoch 0's); the culling ablation's iterations (2 epochs, before
# densify_from) and its bar between the plain raster path and the kernels;
# the data-parallel convergence check's iterations, and each child's
# time limit
CONV_ARGV = ["--points", "1200000", "--init_points", "150000",
             "--color_freq", "3.0", "--target", "1000000", "--frames", "10",
             "--sh_degree", "3", "--tile", "32x24", "--static_caps"]
CONV_R5_HW, CONV_R5_ITERS = (256, 384), 6000
CONV_ITERS = 2000
CONV_ACTIVE_SHARE = 0.95
CONV_PSNR_GAIN = 10.0
CULLING_ITERS = 16
SCRIPT_RASTER_TOL = 0.1
PAR_CONV_ITERS = 48
CHILD_TIMEOUT = 600
# integer operations per output slot of an expansion beside its A copies:
# the binary search over a window of 640-768 starts (10 steps of about 4)
# and the rank
OPS_PER_SLOT = 45


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, repeats: int = REPEATS) -> float:
    """Median milliseconds of ``fn()`` on the current stream (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Marks:
    """Named CUDA events recorded in order on the current stream."""

    def __init__(self):
        self.events = []

    def mark(self, name: str):
        import torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def split(self) -> list[tuple[str, float]]:
        """(name, ms since the previous mark) for every mark after the
        first; synchronises."""
        self.events[-1][1].synchronize()
        return [(name, prev.elapsed_time(ev)) for (_, prev), (name, ev)
                in zip(self.events, self.events[1:])]


def screen_gaussians(rng, n, img_h, img_w, scale_px, graze=False):
    """Random gaussians directly in screen space (numpy): mean_pix, inv_cov,
    color, opacity, view_z, ndc.  ``graze``: each centre is moved so that
    its alpha >= 1/256 region ends within 0.05 pixel of a column (and for
    half of them a row) of pixel centres on an 8-pixel boundary, the edges
    of the raster kernels' warp blocks, where their per-warp cull
    decides."""
    mx = rng.uniform(-8, img_w + 8, n)
    my = rng.uniform(-8, img_h + 8, n)
    theta = rng.uniform(0, 2 * np.pi, n)
    s1 = rng.uniform(*scale_px, n)
    s2 = rng.uniform(*scale_px, n)
    ct, st = np.cos(theta), np.sin(theta)
    a = ct * ct * s1 * s1 + st * st * s2 * s2
    b = ct * st * (s1 * s1 - s2 * s2)
    c = st * st * s1 * s1 + ct * ct * s2 * s2
    det = a * c - b * b
    inv = np.stack([c / det, -b / det, a / det])
    color = rng.random((3, n))
    opacity = rng.uniform(0.02, 0.99, n)
    if graze:
        # the region's extent along x and y: sqrt(t a), sqrt(t c) for the
        # covariance [[a, b], [b, c]], t = 2 ln(256 o)
        t = 2 * np.log(256 * opacity)
        side = rng.choice([-1.0, 1.0], n)
        edge = 8 * rng.integers(0, img_w // 8 + 1, n) - rng.integers(0, 2, n)
        mx = edge + side * (np.sqrt(t * a) + rng.uniform(-0.05, 0.05, n))
        edge = 8 * rng.integers(0, img_h // 8 + 1, n) - rng.integers(0, 2, n)
        my = np.where(rng.random(n) < 0.5, my, edge + side * (
            np.sqrt(t * c) + rng.uniform(-0.05, 0.05, n)))
    view_z = rng.uniform(0.5, 10.0, n)
    ndc = np.stack([(mx + 0.5) / img_w * 2 - 1, (my + 0.5) / img_h * 2 - 1,
                    np.full(n, 0.5), np.ones(n)])
    f = np.float32
    return (np.stack([mx, my]).astype(f), inv.astype(f), color.astype(f),
            opacity.astype(f), view_z.astype(f), ndc.astype(f))


def max_diff(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def check_backward(got, want, where: str, flip_rate: float = 0.0):
    """Hold the backward kernel's PointGrads to the plain version's at the
    BWD_TOL bars, frag_count in total within flip_rate of the contributing
    pairs; returns (the largest absolute difference over the gradients and
    the other statistics, the pairs counted by one side only)."""
    worst, flips = 0.0, 0.0
    for field in got._fields:
        a, b = getattr(got, field), getattr(want, field)
        if b is None:
            continue
        if field == "frag_count":
            flips = float((a - b).abs().double().sum())
            allowed = BWD_TOL[field] + flip_rate * float(b.double().sum())
            if not flips <= allowed:
                fail(f"raster backward {where}: {flips} contributing pairs "
                     f"counted by one side only, {allowed} allowed")
            continue
        d = max_diff(a, b)
        worst = max(worst, d)
        scale = float(b.abs().max()) if b.numel() else 0.0
        bar = (BWD_TOL[field] if field == "weight_sum" else
               BWD_TOL.get(field, BWD_TOL["grad"]) * scale + 1e-12)
        if not d <= bar:
            fail(f"raster backward {where} {field}: max|diff| {d} against "
                 f"max|plain| {scale}")
    return worst, flips


def phase_kernels(dev, img_h: int = 96, img_w: int = 128):
    """Both raster kernels vs their plain versions at every tile size;
    returns the largest differences seen (forward, backward)."""
    import torch
    from litegs_torch.ops import binning, raster_cuda
    worst, worst_bwd = 0.0, 0.0
    cases = (("shallow", 60, (1.0, 8.0), False),
             ("deep", 400, (6.0, 16.0), True),
             ("sparse", 4, (0.5, 2.0), True),
             ("grazing", 500, (0.5, 6.0), True))
    for k, (tile_h, tile_w) in enumerate(TILE_SIZES):
        tiles_x = -(-img_w // tile_w)
        for j, (name, n, spx, depth) in enumerate(cases):
            if name == "deep":
                # more than one batch of entries of either kernel (256 and
                # 128 entries) in the deepest tile
                n = n * max(tile_h * tile_w, 384) // 128
            rng = np.random.default_rng(100 * k + j)
            mean, inv, color, op, z, ndc = [
                torch.from_numpy(x).to(dev) for x in
                screen_gaussians(rng, n, img_h, img_w, spx,
                                 graze=name == "grazing")]
            if depth:
                color = torch.cat([color, z[None]])
            table = binning.build_tile_table(
                ndc, z, inv, op, torch.ones(n, dtype=torch.bool, device=dev),
                img_h, img_w, tile_h, tile_w)
            args = (mean, inv, color, op, table.sorted_point,
                    table.tile_start, table.tile_count, tiles_x, tile_h,
                    tile_w)
            col, trans = raster_cuda.raster_forward(*args)
            col_p, trans_p = raster_cuda.raster_forward_plain(*args)
            d = max(max_diff(col, col_p), max_diff(trans, trans_p))
            worst = max(worst, d)
            cnt = table.tile_count
            cot = [torch.from_numpy(rng.standard_normal(
                tuple(t.shape)).astype(np.float32)).to(dev)
                for t in (col, trans)]
            d_bwd = 0.0
            for with_stats in (False, True):
                got = raster_cuda.raster_backward(*args, col, trans, *cot,
                                                  with_stats=with_stats)
                want = raster_cuda.raster_backward_plain(
                    *args, col, trans, *cot, with_stats=with_stats)
                d_bwd = max(d_bwd, check_backward(
                    got, want, f"{tile_h}x{tile_w} {name} "
                               f"stats={int(with_stats)}")[0])
            worst_bwd = max(worst_bwd, d_bwd)
            print(f"kernel {tile_h}x{tile_w} {name:7s} depth={int(depth)} "
                  f"entries={table.num_entries} max_tile={int(cnt.max())} "
                  f"empty_tiles={int((cnt == 0).sum())}/{cnt.numel()} "
                  f"saturated_px={int((trans <= 1 / 8192).sum())} "
                  f"max|diff| fwd={d:.3e} bwd={d_bwd:.3e}")
            if not d <= TOL:
                fail(f"raster kernel {tile_h}x{tile_w} {name}: {d} > {TOL}")
            if name == "deep" and not (int(cnt.max()) > 256 and
                                       bool((trans <= 1 / 8192).any())):
                fail("deep case covers neither several batches nor the "
                     "early exit")
            if name == "sparse" and not bool((cnt == 0).any()):
                fail("sparse case has no empty tile")
    return worst, worst_bwd


def exact_diff(got, want, what: str) -> float:
    """max |got - want| of two tensors that must be equal exactly."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {tuple(got.shape)} {got.dtype} against "
             f"{tuple(want.shape)} {want.dtype}")
    if torch.equal(got, want):
        return 0.0
    d = float((got.double() - want.double()).abs().max())
    fail(f"{what}: differs from the plain version, max|diff| {d}")


def stream_cases():
    """Seeded inputs of the expansions: (name, attrs, counts, out_len,
    window_items, slots_per_step, counts > 0 form a prefix).  The first
    five are the cases of tests/test_stream_gather.py."""
    rng = np.random.default_rng(0)
    counts = rng.integers(1, 5, 300).astype(np.int32)
    counts[200:] = 0
    yield ("oracle", rng.random((16, 300)).astype(np.float32), counts, 1024,
           256, 256, True)
    yield ("one item spanning blocks",
           np.arange(151, dtype=np.float32)[None].repeat(8, 0),
           np.r_[np.full(1, 200), np.ones(150)].astype(np.int32), 512, 256,
           128, True)
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 4, 700).astype(np.int32)
    counts[rng.random(700) < 0.4] = 0
    total = int(counts.sum())
    yield ("zero counts anywhere", rng.standard_normal((8, 700)).astype(
        np.float32), counts, (total + 255) // 256 * 256 + 256, 256, 128,
        False)
    rng = np.random.default_rng(5)
    counts = rng.integers(1, 5, 2000).astype(np.int32)
    total = int(counts.sum())
    yield ("multi-slot steps", rng.standard_normal((16, 2000)).astype(
        np.float32), counts, (total + 511) // 512 * 512 + 512, 640, 512,
        True)
    yield ("all-zero counts", np.ones((4, 300), np.float32),
           np.zeros(300, np.int32), None, 256, 256, True)
    yield ("one item, 70,000 slots, exact length",
           np.arange(12, dtype=np.float32)[:, None].repeat(5, 1),
           np.array([0, 70000, 0, 0, 0], np.int32), None, 256, 512, False)
    rng = np.random.default_rng(6)
    yield ("int32 rows, odd sizes", rng.integers(
        -2 ** 31, 2 ** 31 - 1, (3, 1001)).astype(np.int32),
        rng.integers(1, 90, 1001).astype(np.int32), 30001, 384, 200, True)


def layout_cases():
    """stream_cases' tuples with one more field, the word offset of attrs
    in its buffer, for the layouts the window kernels branch on: S not a
    multiple of 4 with attrs 4 bytes off a 16-byte boundary (word copies),
    A = 1, 3, 12 and 16, a partial last step, and more steps than the
    asynchronous-copy kernel's persistent grid has blocks (at most 16 a
    multiprocessor, 132 of them)."""
    for case in stream_cases():
        yield (*case, 0)
    rng = np.random.default_rng(21)
    for a in (1, 3, 12, 16):
        counts = rng.integers(0, 4, 2003).astype(np.int32)
        yield (f"A={a}, S=4k+3, attrs off 16 bytes", rng.standard_normal(
            (a, 2003)).astype(np.float32), counts, None, 640, 512, False, 1)
    counts = rng.integers(0, 4, 4096).astype(np.int32)
    yield ("A=12, S=4k, a 77-slot last step", rng.integers(
        -2 ** 31, 2 ** 31 - 1, (12, 4096)).astype(np.int32), counts,
        int(counts.sum()) // 512 * 512 + 77, 640, 512, False, 0)
    counts = rng.integers(1, 3, 300_000).astype(np.int32)
    yield ("3,500+ steps of 128 slots", rng.standard_normal(
        (3, 300_000)).astype(np.float32), counts, None, 256, 128, True, 0)


def device_rows(attrs, dev, offset: int):
    """attrs as a contiguous [A, S] view that starts ``offset`` words into
    a flat buffer on ``dev``."""
    import torch
    src = torch.from_numpy(attrs)
    flat = torch.empty(src.numel() + offset, dtype=src.dtype, device=dev)
    rows = flat[offset:].view(src.shape)
    rows.copy_(src)
    return rows


def check_async_model(got, attrs, counts, window: int, step: int,
                      what: str, blocks=None, walk: int = 1):
    """Hold expand_window_async_kernel's output (out, rank, total, ok) to
    window_block_plain, the plain model of its persistent blocks: every
    step (``blocks`` None), or ``walk`` steps from each of ``blocks``
    spread over the expansion; every slot of a step, those past the total
    included."""
    import torch
    from litegs_torch.ops import stream_gather as sg
    cum = torch.cumsum(counts, 0).cpu()
    out, rank = got[0], got[1]
    n_slots = rank.shape[0]
    n_steps = -(-n_slots // step)
    starts = ([0] if blocks is None else sorted(set(
        np.linspace(0, n_steps - 1, blocks).astype(int))))
    walk = n_steps if blocks is None else walk
    attrs_cpu = attrs.cpu()
    out, rank = out.cpu(), rank.cpu()
    for b0 in starts:
        plans = sg.window_block_plain(cum, int(b0),
                                      min(int(b0) + walk, n_steps), window,
                                      step, n_slots)
        for b, (_, _, ok, owner, want_rank) in enumerate(plans, int(b0)):
            s0 = b * step
            if not ok:
                fail(f"{what}: the block model finds step {b} outside its "
                     "window")
            if not (torch.equal(rank[s0:s0 + step], want_rank)
                    and torch.equal(out[:, s0:s0 + step],
                                    attrs_cpu[:, owner])):
                fail(f"{what}: step {b} differs from the block model")


def gather_cases():
    """(what, attrs [A, S], src_lo, word offset of attrs): float32 and
    int32 rows with offsets past S and below 0; A = 1, 3, 12 and 16 with S
    = 4k + 1 and attrs 4 bytes off a 16-byte boundary; int64 offsets past
    2^31 and far below 0; 40,000 runs, more than one sweep of the
    persistent grid."""
    rng = np.random.default_rng(1)
    for dtype, n in ((np.float32, 700), (np.int32, 129)):
        yield (f"{dtype.__name__} S={n}",
               (rng.random((8, n)) * 1000).astype(dtype),
               np.r_[np.sort(rng.integers(0, n - 1, 4)), n - 40, n + 500,
                     -3].astype(np.int32), 0)
    for a in (1, 3, 12, 16):
        n = 4 * 333 + 1
        yield (f"A={a} off 16 bytes", rng.standard_normal((a, n)).astype(
            np.float32), rng.integers(-200, n + 200, 37).astype(np.int32), 1)
    n = 5000
    yield ("int64 offsets", rng.standard_normal((3, n)).astype(np.float32),
           np.r_[rng.integers(0, n, 9), 2 ** 31, 2 ** 40 + 3, -2 ** 31 - 5,
                 -2 ** 40, n - 1].astype(np.int64), 0)
    n = 5_000_000
    yield ("40,000 runs", rng.integers(-2 ** 31, 2 ** 31 - 1, (1, n)).astype(
        np.int32), np.sort(rng.integers(0, n, 40_000)).astype(np.int32), 0)


def phase_stream_kernels(dev):
    """The four stream_gather kernels against their plain versions on
    seeded cases, equal exactly, and the asynchronous-copy kernel against
    the plain model of its blocks; returns the largest difference seen per
    kernel (0.0, or the script has stopped)."""
    import torch
    from litegs_torch.ops import stream_gather as sg
    worst = dict.fromkeys(sg.LAUNCHES, 0.0)
    for name, attrs_np, counts, out_len, window, step, prefix, offset in \
            layout_cases():
        attrs = device_rows(attrs_np, dev, offset)
        counts = torch.from_numpy(counts).to(dev)
        want = sg.expand_attrs_windowed_plain(attrs, counts, out_len, window,
                                              step)
        total = int(want[2])
        live = min(total, want[0].shape[1])
        if not bool(want[3]):
            fail(f"stream case {name}: its window does not hold")
        runs = {"expand_window_kernel": lambda: sg.expand_attrs_windowed(
                    attrs, counts, out_len, window, step),
                "expand_window_async_kernel":
                    lambda: sg.expand_attrs_windowed(
                        attrs, counts, out_len, window, step, dma=True)}
        if prefix:
            runs["expand_prefix_kernel"] = lambda: sg.expand_attrs(
                attrs, counts, out_len)
        for kernel, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            if int(got[2]) != total or (len(got) == 4 and not bool(got[3])):
                fail(f"{kernel} on {name}: total {int(got[2])} ok "
                     f"{got[3:]} against total {total}")
            what = f"{kernel} on {name}"
            worst[kernel] = max(
                worst[kernel],
                exact_diff(got[0][:, :live], want[0][:, :live], what),
                exact_diff(got[1][:live], want[1][:live], what + " rank"))
            if kernel == "expand_window_async_kernel":
                check_async_model(got, attrs, counts, window, step, what)
        print(f"stream kernel case {name:38s} rows={attrs.shape[0]} "
              f"items={attrs.shape[1]} slots={want[0].shape[1]} "
              f"live={live} attrs offset {offset}: {', '.join(runs)} equal "
              "to plain; the async kernel equal to its block model on "
              "every slot")
    # the window check: a run of empty items longer than the window
    counts = torch.zeros(1024, dtype=torch.int32, device=dev)
    counts[0], counts[600] = 1, 300
    attrs = torch.arange(8 * 1024, dtype=torch.float32,
                         device=dev).reshape(8, 1024)
    for dma in (False, True):
        ok = sg.expand_attrs_windowed(attrs, counts, 512, 256, 128,
                                      dma=dma)[3]
        torch.cuda.synchronize()
        if bool(ok):
            fail("a window overrun was not flagged")
    for what, attrs, src_lo, offset in gather_cases():
        attrs = device_rows(attrs, dev, offset)
        src_lo = torch.from_numpy(src_lo).to(dev)
        before = sg.LAUNCHES["gather_blocks_kernel"]
        got = sg.gather_blocks(attrs, src_lo)
        torch.cuda.synchronize()
        if sg.LAUNCHES["gather_blocks_kernel"] != before + 1:
            fail(f"gather_blocks on {what}: not one launch")
        worst["gather_blocks_kernel"] = max(
            worst["gather_blocks_kernel"],
            exact_diff(got, sg.gather_blocks_plain(attrs, src_lo),
                       f"gather_blocks_kernel on {what}"))
        print(f"stream kernel case gather {what}: rows={attrs.shape[0]} "
              f"items={attrs.shape[1]} runs={src_lo.numel()} "
              f"({src_lo.dtype}): equal to plain")
    print("stream kernel cases: overrun flagged by both window kernels")
    return worst


def reset_binning_counts():
    from litegs_torch.ops import binning, binning_cuda
    from litegs_torch.ops import stream_gather as sg
    sg.reset_counts()
    binning_cuda.reset_counts()
    binning.PLAIN_CALLS = 0


def keys_launches_ok(launches: dict, views: int) -> bool:
    """The 'keys' route's launches for ``views`` views with entries: count,
    emit and ranges once a view, the sort's two kernels alike, one to
    eight passes a view."""
    sort = launches["bin_sort_count_kernel"]
    return (launches["bin_count_kernel"] == launches["bin_emit_kernel"]
            == launches["bin_ranges_kernel"] == views
            and launches["bin_sort_scatter_kernel"] == sort
            and views <= sort <= 8 * views)


# each 'keys' kernel's launches on the paths check_binning_counts checked
KEYS_PATH_LAUNCHES: dict = {}


def check_binning_counts(what: str, views: int) -> int:
    """The default binning route ('keys'): its kernels launched for each
    view binned (keys_launches_ok), no stream_gather kernel and no plain
    version; the launches are added to KEYS_PATH_LAUNCHES.  Returns the
    views binned."""
    from litegs_torch.ops import binning, binning_cuda
    from litegs_torch.ops import stream_gather as sg
    keys = binning_cuda.LAUNCHES
    others = {k: v for k, v in sg.LAUNCHES.items() if v}
    if not keys_launches_ok(keys, views) or others:
        fail(f"{what}: the binning kernels launched {keys} for {views} "
             f"views, stream_gather kernels {others}")
    plain = sg.PLAIN_CALLS + binning.PLAIN_CALLS
    if plain != 0:
        fail(f"{what}: the plain binning versions ran {plain} times")
    for k, v in keys.items():
        KEYS_PATH_LAUNCHES[k] = KEYS_PATH_LAUNCHES.get(k, 0) + v
    return keys["bin_count_kernel"]


def view_binning_inputs(params, active, batch, i, sh_degree, pp):
    """The arguments build_tile_table gets for view i of the batch."""
    import torch
    from litegs_torch.render import _project, render_preprocess
    from litegs_torch.training.trainer import masked_chunk_aabb
    img_h, img_w = batch.images.shape[-2:]
    with torch.no_grad():
        origin, extend = masked_chunk_aabb(params, active, pp.cluster_size)
        culled = render_preprocess(params, origin, extend, batch.planes[i],
                                   batch.center[i], sh_degree, pp)
        view_pos, ndc, inv_cov = _project(culled, batch.view[i],
                                          batch.proj[i], img_h, img_w)
    return (ndc.detach(), view_pos[2].detach(), inv_cov.detach(),
            culled.opacity.detach(), culled.valid, img_h, img_w,
            *pp.tile_size)


def kernel_device_ms(fn, kernel: str, repeats: int = REPEATS):
    """Mean device milliseconds of the kernel named ``kernel`` alone, over
    ``repeats`` calls of ``fn`` under torch.profiler (``fn`` also runs its
    wrapper's torch ops, which time_ms includes and this leaves out).

    The profiler has once returned a window without this kernel's records
    (1 of 10 whole runs; the kernel ran, its launches counted): such a
    window is profiled again, up to PROFILE_WINDOWS in all, and each miss
    is printed with the device records the window did hold.  The script
    stops if no window reports the kernel: the call's time is no stand-in
    for the kernel's."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    for window in range(1, PROFILE_WINDOWS + 1):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(repeats):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        us = [e.self_device_time_total for e in device if kernel in e.key]
        if us and sum(us) > 0:
            return sum(us) / repeats / 1e3
        print(f"torch.profiler window {window} of {PROFILE_WINDOWS} held no "
              f"device time for {kernel}; its device records: "
              f"{[(e.key[:60], e.count) for e in device]}")
    fail(f"torch.profiler reported no device time for {kernel} in "
         f"{PROFILE_WINDOWS} windows")


def check_block_model(got, attrs, counts, window: int, step: int,
                      what: str, steps: int = 32):
    """Hold expand_window_kernel's output (out, rank, total, ok) to
    window_step_plain, the plain model of one of its blocks, on ``steps``
    steps spread over the expansion: every slot of a step, those past the
    total included."""
    import torch
    from litegs_torch.ops import stream_gather as sg
    cum = torch.cumsum(counts, 0).cpu()
    out, rank = got[0], got[1]
    n_slots = rank.shape[0]
    n_steps = -(-n_slots // step)
    for b in sorted(set(np.linspace(0, n_steps - 1, steps).astype(int))):
        _, ok, owner, want_rank = sg.window_step_plain(cum, int(b), window,
                                                       step, n_slots)
        s0 = int(b) * step
        if not ok:
            fail(f"{what}: the block model finds step {b} outside its "
                 "window")
        owner = owner.to(attrs.device)
        if not (torch.equal(rank[s0:s0 + step].cpu(), want_rank)
                and torch.equal(out[:, s0:s0 + step], attrs[:, owner])):
            fail(f"{what}: step {b} differs from the block model")


def bytes_bound(nbytes: int, ops: int):
    ms = 1e3 * max(ops / PEAK_FP32, nbytes / PEAK_BYTES)
    return ms, ("operations" if ops / PEAK_FP32 >= nbytes / PEAK_BYTES
                else "bytes")


def phase_stream_routes(dev, label: str, params, active: int, batch,
                        sh_degree: int, timed: bool):
    """The binning routes at full width on view 0: every route's table
    identical to the non-streaming table with its launches counted, the
    window check's margin, a view that emits no row, gather_blocks
    building the table's 128-aligned copy, and (``timed``) each
    stream_gather kernel's numbers.  Returns
    ({kernel: launches counted here}, {kernel: record} when timed)."""
    import torch
    from litegs_torch import config
    from litegs_torch.ops import binning, binning_cuda
    from litegs_torch.ops import stream_gather as sg

    pp = config.PipelineParams()
    args = view_binning_inputs(params, active, batch, 0, sh_degree, pp)

    # ---- every route's table against the non-streaming table, with its ----
    # ---- launches counted (the stream_gather kernels' own path: their
    # routes are reached only through build_tile_table's argument); the
    # window route's expansion inputs are kept for the timings ----
    off = binning.build_tile_table(*args, stream=False)
    seen = []
    real = sg.expand_attrs_windowed

    def spy(attrs, counts, *a, **k):
        seen.append((attrs, counts, k["window_items"], k["slots_per_step"]))
        return real(attrs, counts, *a, **k)

    launches = dict.fromkeys(sg.LAUNCHES, 0)
    for route, expect in (
            (None, None),
            (True, {"expand_window_kernel": 2}),
            ("async", {"expand_window_async_kernel": 2}),
            ("prefix", {"expand_prefix_kernel": 1,
                        "expand_window_kernel": 1})):
        if route is True:
            sg.expand_attrs_windowed = spy
        reset_binning_counts()
        try:
            on = binning.build_tile_table(*args, stream=route)
        finally:
            sg.expand_attrs_windowed = real
        got = {k: v for k, v in {**sg.LAUNCHES,
                                 **binning_cuda.LAUNCHES}.items() if v}
        plain = sg.PLAIN_CALLS + binning.PLAIN_CALLS
        if route is None:          # the 'keys' kernels only
            ok = (keys_launches_ok(binning_cuda.LAUNCHES, 1)
                  and not any(sg.LAUNCHES.values()))
        else:
            ok = got == expect
        if not ok or plain:
            fail(f"{label}: build_tile_table(stream={route!r}) launched "
                 f"{got} and made {plain} plain calls")
        if route is not None:      # the default route counts on its path
            for k, v in got.items():
                launches[k] += v
        for field in off._fields:
            a, b = getattr(off, field), getattr(on, field)
            same = torch.equal(a, b) if torch.is_tensor(a) else a == b
            if not same:
                fail(f"{label}: table field {field} of stream={route!r} "
                     "differs from the non-streaming table")
    print(f"{label} view 0: rows={off.num_rows} entries={off.num_entries}; "
          "tables of the default route ('keys') and of stream=True / "
          "'async' / 'prefix' identical to stream=False in every field")

    # ---- the margin of the window check: the most items any step's ----
    # ---- owners span, beside what the window holds ----
    for n, (attrs, counts, window, step) in enumerate(seen, 1):
        cum = torch.cumsum(counts, 0)
        lo, hi = sg.step_owners(cum, cum[-1], int(cum[-1]), step)
        span = int((hi - lo).max())
        empty = int((counts[:int(hi.max()) + 1] == 0).sum())
        print(f"{label} expansion {n}: largest owner span of a {step}-slot "
              f"step {span} items, the window check allows {window}; "
              f"{empty} items with count 0 before the last owner")
        if span > window:
            fail(f"{label} expansion {n}: span {span} > window {window}")

    # ---- a view whose points survive culling and emit no tile row: ----
    # ---- every route returns the empty table and launches nothing ----
    none_valid = (*args[:4], torch.zeros_like(args[4]), *args[5:])
    for route in (None, False, True, "async", "prefix"):
        reset_binning_counts()
        table = binning.build_tile_table(*none_valid, stream=route)
        counted = {"bin_count_kernel": 1} if route is None else {}
        got = {k: v for k, v in binning_cuda.LAUNCHES.items() if v}
        if (table.num_rows or table.num_entries or table.sorted_point.numel()
                or int(table.tile_count.sum()) or sg.PLAIN_CALLS
                or binning.PLAIN_CALLS or any(sg.LAUNCHES.values())
                or got != counted):
            fail(f"{label}: a view without rows, stream={route!r}: "
                 f"rows={table.num_rows} entries={table.num_entries} "
                 f"launches={sg.LAUNCHES} {got} plain calls="
                 f"{sg.PLAIN_CALLS + binning.PLAIN_CALLS}")
    print(f"{label} view 0 with no valid point: the empty table from the "
          "default route and from every other")

    # ---- the 128-aligned copy of the table ----
    blocks = (off.tile_count + 127) // 128
    src_lo = (torch.repeat_interleave(off.tile_start, blocks)
              + 128 * (torch.arange(int(blocks.sum()), device=dev)
                       - torch.repeat_interleave(
                           torch.cumsum(blocks, 0) - blocks, blocks))
              ).to(torch.int32)
    table_row = off.sorted_point[None]
    sg.reset_counts()
    aligned = sg.gather_blocks(table_row, src_lo)
    launches["gather_blocks_kernel"] += sg.LAUNCHES["gather_blocks_kernel"]
    if sg.PLAIN_CALLS or launches["gather_blocks_kernel"] != 1:
        fail(f"{label}: gather_blocks did not launch its kernel once")
    worst = dict.fromkeys(sg.LAUNCHES, 0.0)
    worst["gather_blocks_kernel"] = exact_diff(
        aligned, sg.gather_blocks_plain(table_row, src_lo),
        f"{label}: gather_blocks_kernel on the table's aligned copy")
    print(f"{label} view 0: aligned copy of sorted_point: "
          f"{src_lo.numel()} blocks of 128 equal to plain; launches "
          f"counted here {launches}")

    if not timed:
        return launches, None

    # ---- each kernel at the shapes of the two expansions ----
    records = {}
    for n, (attrs, counts, window, step) in enumerate(seen, 1):
        a, items = attrs.shape
        want = sg.expand_attrs_windowed_plain(attrs, counts, None, window,
                                              step)
        slots = want[0].shape[1]
        nbytes = 4 * (a * items + items + (a + 1) * slots)
        bound_ms, bound_by = bytes_bound(nbytes, OPS_PER_SLOT * slots)
        # timed with the length given, so that no call waits on the host
        runs = {
            "expand_prefix_kernel": lambda: sg.expand_attrs(attrs, counts,
                                                            slots),
            "expand_window_kernel": lambda: sg.expand_attrs_windowed(
                attrs, counts, slots, window, step),
            "expand_window_async_kernel": lambda: sg.expand_attrs_windowed(
                attrs, counts, slots, window, step, dma=True)}
        plain_ms = time_ms(lambda: sg.expand_attrs_windowed_plain(
            attrs, counts, slots, window, step))
        library_ms = time_ms(lambda: torch.repeat_interleave(
            attrs, counts, dim=1, output_size=slots))

        def prelude():
            sg._window_prelude(attrs, counts, slots)

        # the window kernels' calls run no torch op beside these
        prelude_ms = time_ms(prelude)
        line = []
        for kernel, run in runs.items():
            got = run()
            what = f"{label}: {kernel} on expansion {n}"
            worst[kernel] = max(worst[kernel],
                                exact_diff(got[0], want[0], what),
                                exact_diff(got[1], want[1], what + " rank"))
            if kernel == "expand_window_kernel":
                check_block_model(got, attrs, counts, window, step, what)
            if kernel == "expand_window_async_kernel":
                check_async_model(got, attrs, counts, window, step, what,
                                  blocks=32, walk=4)
            call_ms = time_ms(run)
            ms = kernel_device_ms(run, kernel)
            line.append(f"{kernel} {ms:.4f} ms alone ({bound_ms / ms:.1%} "
                        f"of the bound), {call_ms:.4f} ms its call "
                        f"({bound_ms / call_ms:.1%})")
            # the record of the prefix kernel is the first expansion (where
            # its contract holds and the 'prefix' route runs it), of the
            # window kernels the second and larger one
            if (n == 1) == (kernel == "expand_prefix_kernel"):
                records[kernel] = dict(
                    SG_RECORDS[kernel], ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library_ms)
        print(f"{label} expansion {n}: rows={a} items={items} slots={slots}"
              f" window={window}+128 step={step} bytes={nbytes} "
              f"bound_ms={bound_ms:.4f} ({bound_by}); "
              + ", ".join(line) + f"; a window kernel's call runs beside "
              f"its launch only the prefix sum, its two outputs and the ok "
              f"byte, {prelude_ms:.4f} ms; plain {plain_ms:.4f} ms; "
              f"torch.repeat_interleave {library_ms:.4f} ms "
              f"({bound_ms / library_ms:.1%} of the bound)")
    nb = src_lo.numel()
    idx = (src_lo.long()[:, None]
           + torch.arange(128, device=dev)).flatten().clamp(
               max=table_row.shape[1] - 1)
    nbytes = 4 * (table_row.numel() + nb + nb * 128)
    bound_ms, bound_by = bytes_bound(nbytes, nb * 128)
    call_ms = time_ms(lambda: sg.gather_blocks(table_row, src_lo))
    ms = kernel_device_ms(lambda: sg.gather_blocks(table_row, src_lo),
                          "gather_blocks_kernel")
    records["gather_blocks_kernel"] = dict(
        SG_RECORDS["gather_blocks_kernel"],
        ms=ms,
        plain_ms=time_ms(lambda: sg.gather_blocks_plain(table_row, src_lo)),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(lambda: table_row[:, idx]))
    r = records["gather_blocks_kernel"]
    print(f"{label} aligned copy: rows=1 items={table_row.shape[1]} "
          f"blocks={nb} bytes={nbytes} bound_ms={bound_ms:.4f} ({bound_by})"
          f"; gather_blocks_kernel {r['ms']:.4f} ms alone "
          f"({bound_ms / r['ms']:.1%} of the bound), {call_ms:.4f} ms its "
          f"call (one launch); plain {r['plain_ms']:.4f} ms; one indexing "
          f"call {r['library_ms']:.4f} ms")
    gather_at_jax_shape(dev, label)
    for kernel, rec in records.items():
        rec["max_abs_err"] = worst[kernel]
    return launches, records


def keys_view(dev):
    """build_tile_table's arguments for the 6M view KEYS_POINTS / KEYS_SEED
    describe, built by the port's own generator and preprocessing."""
    import torch
    from litegs_torch import config
    from litegs_torch.data import synthetic
    from litegs_torch.scene.gaussians import GaussianModel
    from litegs_torch.scene.morton import spatial_sort_indices
    from litegs_torch.training.trainer import camera_batch_from_frames
    from litegs_torch.utils import sh as sh_utils
    n, extent = KEYS_POINTS, 1.5
    xyz, rgb = synthetic.make_gaussian_cloud(n, seed=KEYS_SEED,
                                             extent=extent)
    xyz = torch.from_numpy(xyz).to(dev).T.contiguous()
    g = torch.Generator(device=dev).manual_seed(KEYS_SEED)
    spacing = (4.0 / 3.0 * math.pi * extent ** 3 / n) ** (1.0 / 3.0)
    scale = math.log(spacing) - 1.0 + 0.5 * torch.randn(
        (3, n), generator=g, device=dev)
    rot = torch.randn((4, n), generator=g, device=dev)
    rot = rot / torch.linalg.vector_norm(rot, dim=0, keepdim=True)
    opaque = torch.rand(n, generator=g, device=dev) < 0.55
    logit = torch.where(opaque, 3.0, -2.5) + torch.randn(
        n, generator=g, device=dev)
    sh_0 = sh_utils.rgb_to_sh0(torch.from_numpy(rgb).to(dev).T)[None]
    order = spatial_sort_indices(xyz)
    params = GaussianModel(
        xyz=xyz[:, order], scale=scale[:, order], rot=rot[:, order],
        sh_0=sh_0[..., order].contiguous(),
        sh_rest=torch.zeros((0, n), device=dev), opacity=logit[None, order])
    cam, frames = synthetic.make_cameras(1, IMG_H, IMG_W, seed=KEYS_SEED)
    batch = camera_batch_from_frames(
        cam, frames, np.zeros((1, 3, IMG_H, IMG_W), np.float32), device=dev)
    args = view_binning_inputs(params, n, batch, 0, 0,
                               config.PipelineParams(tile_size=(8, 16)))
    del params
    return args


def table_diff(a, b) -> dict:
    """Each field's largest absolute difference between two tables (inf
    where the dtypes or shapes differ)."""
    import torch
    out = {}
    for field in a._fields:
        x, y = getattr(a, field), getattr(b, field)
        if not torch.is_tensor(x):
            out[field] = abs(x - y)
        elif x.dtype != y.dtype or x.shape != y.shape:
            out[field] = math.inf
        elif x.numel():
            out[field] = int((x.long() - y.long()).abs().max())
        else:
            out[field] = 0
    return out


def keys_steps(args):
    """The 'keys' route's steps on one view, each a callable, and its bytes
    bound: each input read and each output written once."""
    import torch
    from litegs_torch.ops import binning
    from litegs_torch.ops import binning_cuda as bc
    ndc, z, inv, op, valid, h, w, th, tw = args
    geom = bc.Geometry(h, w, th, tw)
    tiles = math.ceil(h / th) * math.ceil(w / tw)
    inputs = bc.point_inputs(ndc, z, inv, op, valid)
    entries, totals = bc.count(inputs, geom)
    ends = torch.cumsum(entries, 0, dtype=torch.int32)
    rows, e, z_lo, z_hi = totals.tolist()
    z_min, zb, key_bits = binning._key_layout(0xFFFFFFFF - z_lo, z_hi, tiles)
    keys, points = bc.emit(inputs, geom, entries, ends, z_min, zb, e)
    skeys, _ = bc.sort_pairs(keys.clone(), points.clone(), key_bits)
    m = z.shape[0]
    steps = {
        "count": lambda: bc.count(inputs, geom),
        "scan": lambda: torch.cumsum(entries, 0, dtype=torch.int32),
        "emit": lambda: bc.emit(inputs, geom, entries, ends, z_min, zb, e),
        "sort": lambda: bc.sort_pairs(keys.clone(), points.clone(),
                                      key_bits),
        "ranges": lambda: bc.ranges(skeys, zb, tiles),
    }
    # inputs: 7 float words and a bool a point; outputs: sorted_point,
    # sorted_tile, entry_valid, tile_start, tile_count, point_counts,
    # primitive_visible
    nbytes = 29 * m + 9 * e + 8 * tiles + 5 * m
    return steps, nbytes, key_bits


def phase_binning_keys(dev):
    """The 'keys' binning route alone on the 6M view of keys_view: its
    table equal to stream=False's field for field, and so is its plain
    version run on the card; the route and each of its steps timed (CUDA
    events, median of REPEATS) beside its bytes bound and the 'window'
    route, in the order keys, window, window, keys.  Returns the kernel
    record."""
    import torch
    from litegs_torch.ops import binning
    args = keys_view(dev)
    off = binning.build_tile_table(*args, stream=False)
    calls = binning.PLAIN_CALLS
    worst = 0
    for what, route in (("the kernels", lambda: binning.build_tile_table(
            *args)), ("the plain version", lambda: binning.
                      _table_by_keys_plain(*args))):
        diff = table_diff(off, route())
        worst = max(worst, *diff.values())
        if any(diff.values()):
            fail(f"6M view: the 'keys' route ({what}) differs from "
                 f"stream=False: {diff}")
    steps, nbytes, key_bits = keys_steps(args)
    step_ms = {k: time_ms(fn) for k, fn in steps.items()}
    times = {"keys": [], "window": []}
    for route in ("keys", "window", "window", "keys"):
        times[route].append(time_ms(lambda: binning.build_tile_table(
            *args, stream=route)))
    plain_ms = time_ms(lambda: binning._table_by_keys_plain(*args))
    binning.PLAIN_CALLS = calls
    bound_ms, bound_by = bytes_bound(nbytes, 0)
    ms = statistics.mean(times["keys"])
    m, r, e = int(args[1].shape[0]), off.num_rows, off.num_entries
    print(f"6M view (seed {KEYS_SEED}): M={m} R={r} E={e}, "
          f"{key_bits} key bits; the 'keys' route {times['keys'][0]:.3f} / "
          f"{times['keys'][1]:.3f} ms, the 'window' route "
          f"{times['window'][0]:.3f} / {times['window'][1]:.3f} ms; steps "
          + ", ".join(f"{k} {v:.4f}" for k, v in step_ms.items())
          + f" ms; bytes {nbytes} bound_ms={bound_ms:.4f} ({bound_by}), "
          f"{bound_ms / ms:.1%} of it; plain version on the card "
          f"{plain_ms:.3f} ms; tables equal to stream=False")
    del args, off
    torch.cuda.empty_cache()
    return dict(KEYS_RECORD, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                window_route_ms=statistics.mean(times["window"]),
                steps_ms=step_ms, m=m, r=r, e=e,
                key_bits=key_bits, max_abs_err=worst)


def gather_at_jax_shape(dev, label: str):
    """gather_blocks at the JAX package's own scale
    (scripts/debug_stream.py:90-105): 8 float32 rows of 4,063,232 items and
    18,342 sorted run offsets below 4,063,032, seeded as there; equal to
    its plain version, timed alone, per call, plain and as one indexing
    call beside its bytes bound."""
    import torch
    from litegs_torch.ops import stream_gather as sg
    rng = np.random.default_rng(0)
    row_cap, nb = 4_063_232, 2_347_776 // 128
    attrs = torch.from_numpy(rng.standard_normal(
        (8, row_cap)).astype(np.float32)).to(dev)
    lo_np = np.sort(rng.integers(0, row_cap - 200, nb))
    src_lo = torch.from_numpy(lo_np.astype(np.int32)).to(dev)
    # the items the runs cover: the input this gather needs
    covered = int(np.minimum(np.diff(lo_np, append=row_cap), 128).sum())
    exact_diff(sg.gather_blocks(attrs, src_lo),
               sg.gather_blocks_plain(attrs, src_lo),
               f"{label}: gather_blocks_kernel at the JAX shape")
    idx = (src_lo.long()[:, None]
           + torch.arange(128, device=dev)).flatten().clamp(max=row_cap - 1)
    nbytes = 4 * (8 * covered + nb + 8 * nb * 128)
    bound_ms, bound_by = bytes_bound(nbytes, 8 * nb * 128)
    ms = kernel_device_ms(lambda: sg.gather_blocks(attrs, src_lo),
                          "gather_blocks_kernel")
    call_ms = time_ms(lambda: sg.gather_blocks(attrs, src_lo))
    plain_ms = time_ms(lambda: sg.gather_blocks_plain(attrs, src_lo))
    library_ms = time_ms(lambda: attrs[:, idx])
    print(f"{label} gather_blocks at the JAX shape: rows=8 "
          f"items={row_cap} ({covered} covered by a run) blocks={nb} "
          f"bytes={nbytes} "
          f"bound_ms={bound_ms:.4f} ({bound_by}); gather_blocks_kernel "
          f"{ms:.4f} ms alone ({bound_ms / ms:.1%} of the bound), "
          f"{call_ms:.4f} ms its call; plain {plain_ms:.4f} ms; one "
          f"indexing call {library_ms:.4f} ms")


def make_scene(dev, n_points: int, sh_degree: int):
    import torch
    from litegs_torch.data import synthetic
    from litegs_torch.scene import create_gaussians
    xyz, rgb = synthetic.make_gaussian_cloud(n_points, seed=0)
    model = create_gaussians(xyz, rgb, sh_degree, device=dev)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        # garden-like screen footprint, as the JAX bench shrinks its splats
        model.scale -= 0.7
        # view-dependent colour, so the SH bands do real work
        model.sh_rest.copy_(torch.from_numpy(rng.normal(
            0.0, 0.05, tuple(model.sh_rest.shape)).astype(np.float32)))
    return model


def pair_counts(kargs) -> dict:
    """The work of one forward launch on the raster_forward arguments
    kargs, from its count outputs: ``walked``, the (entry, pixel) pairs up
    to and including each pixel's stop (or its tile's count), whatever the
    kernels skip -- the work of a kernel without the cull, which walks them
    all;
    ``evaluated``, the pairs of those that the per-warp cull did not skip;
    ``contributing``, the pairs with alpha >= 1/256 that the blend takes;
    ``entries``, each tile's entries up to its last pixel's stop, the ones
    any implementation must at least look at once."""
    import torch
    from litegs_torch.ops import raster_cuda
    tile_count, tile_h, tile_w = kargs[6], kargs[8], kargs[9]
    counts = torch.zeros((3, tile_count.numel(), tile_h * tile_w),
                         dtype=torch.int32, device=tile_count.device)
    raster_cuda.raster_forward(*kargs, walked=counts[0],
                               evaluated=counts[1], contributing=counts[2],
                               table_checked=True)
    out = dict(zip(("walked", "evaluated", "contributing"),
                   counts.sum((1, 2), dtype=torch.int64).tolist()))
    out["entries"] = int(counts[0].max(1).values.sum(dtype=torch.int64))
    return out


def raster_bounds(nbytes: int, pairs: dict, ops_per_contrib: int):
    """(bound ms, bound_by, walked bound ms) of a raster kernel that moves
    nbytes: the bound of the work the function needs -- ops_per_contrib
    operations for each contributing pair and the cull's for each entry up
    to its tile's last stop -- and, for comparison with kernels without
    the cull, the bound of every walked pair at OPS_PER_PAIR (plus the
    contributing pairs' further operations)."""
    needed, by = bytes_bound(nbytes, ops_per_contrib * pairs["contributing"]
                             + OPS_PER_CULL * pairs["entries"])
    walked, _ = bytes_bound(nbytes, OPS_PER_PAIR * pairs["walked"] + (
        ops_per_contrib - OPS_PER_PAIR) * pairs["contributing"])
    return needed, by, walked


def pair_line(pairs: dict, kernel_ms: float, bound_ms: float,
              bound_by: str, walked_ms: float) -> str:
    return (f"pairs_walked={pairs['walked']} "
            f"pairs_evaluated={pairs['evaluated']} "
            f"contributing_pairs={pairs['contributing']} "
            f"entries_to_stop={pairs['entries']} bound_ms={bound_ms:.4f} "
            f"({bound_by}) bound_share={bound_ms / kernel_ms:.4f} "
            f"bound_walked_ms={walked_ms:.4f} "
            f"bound_walked_share={walked_ms / kernel_ms:.4f}")


def sample_tiles(cnt, seed: int):
    """A count vector that keeps ~SAMPLE_TILES random non-empty tiles and
    the deepest one, and zeroes the rest."""
    import torch
    nonempty = torch.nonzero(cnt > 0).flatten().cpu().numpy()
    pick = np.random.default_rng(seed).choice(
        nonempty, min(SAMPLE_TILES - 1, len(nonempty)), replace=False)
    pick = np.unique(np.append(pick, int(cnt.argmax())))
    keep = torch.zeros_like(cnt)
    keep[torch.from_numpy(pick).to(cnt.device)] = 1
    return cnt * keep, len(pick)


def phase_serving(dev, prepared, active, img_h: int, img_w: int,
                  n_views: int, sh_degree: int):
    """Render and score at full width; returns (forward kernel record,
    camera batch holding the unperturbed model's renders)."""
    import torch
    from litegs_torch import config, evaluation
    from litegs_torch.data import synthetic
    from litegs_torch.ops import binning_cuda, raster_cuda, raster_plain
    from litegs_torch.render import render, render_preprocess
    from litegs_torch.training.trainer import (camera_batch_from_frames,
                                               make_eval_render,
                                               masked_chunk_aabb)

    cam, frames = synthetic.make_cameras(n_views, img_h, img_w, seed=0)
    pp = config.PipelineParams()
    rng = np.random.default_rng(2)
    noise = torch.from_numpy(rng.normal(
        0.0, 0.3, tuple(prepared.sh_0.shape)).astype(np.float32)).to(dev)
    perturbed = prepared.mapped(torch.clone)
    with torch.no_grad():
        perturbed.sh_0 += noise
    blank = camera_batch_from_frames(
        cam, frames, np.zeros((n_views, 3, img_h, img_w), np.float32),
        device=dev)

    # ---- the main path, with every kernel count read around it ----
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    raster_cuda.LAUNCHES = raster_cuda.LAUNCHES_BWD = 0
    raster_plain.CALLS = raster_plain.BACKWARD_CALLS = 0
    reset_binning_counts()
    t0 = time.perf_counter()
    gt = torch.stack([img for _, img in evaluation.render_views(
        prepared, active, blank, pp, sh_degree)])
    batch = blank._replace(images=gt)
    s_pert = evaluation.score_split(perturbed, active, batch, pp, sh_degree)
    s_self = evaluation.score_split(prepared, active, batch, pp, sh_degree)
    wall = time.perf_counter() - t0
    launches, launches_bwd = raster_cuda.LAUNCHES, raster_cuda.LAUNCHES_BWD
    plain_calls = raster_plain.CALLS + raster_plain.BACKWARD_CALLS
    bin_launches = dict(binning_cuda.LAUNCHES)
    views_rendered = n_views + s_pert["n_views"] + s_self["n_views"]
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
            else 0)
    print(f"serving path: {views_rendered} views rendered in {wall:.2f} s; "
          f"raster_forward launches={launches}, raster_backward "
          f"launches={launches_bwd}, plain calls={plain_calls}; "
          f"binning launches={bin_launches}")
    print(f"score perturbed sh_0: {json.dumps(s_pert)}")
    print(f"score self: {json.dumps(s_self)}")
    print(f"peak device memory: {peak / 2**30:.2f} GiB")
    if tuple(gt.shape) != (n_views, 3, img_h, img_w):
        fail(f"ground truth shape {tuple(gt.shape)}")
    if not bool(torch.isfinite(gt).all()) or not 0.01 < float(gt.mean()) < 1:
        fail(f"implausible renders: mean {float(gt.mean())}")
    if launches != views_rendered or launches_bwd != 0:
        fail(f"raster kernels launched {launches} / {launches_bwd} times "
             f"for {views_rendered} views rendered without gradients")
    if plain_calls != 0:
        fail(f"the plain raster versions ran {plain_calls} times on the "
             "serving path")
    binned = check_binning_counts("serving path", views_rendered)
    if not s_self["psnr"] >= 60.0:
        fail(f"self-score PSNR {s_self['psnr']} < 60 dB")
    if not (np.isfinite(s_pert["psnr"]) and 5.0 < s_pert["psnr"] < 60.0
            and 0.0 < s_pert["ssim"] < 1.0):
        fail(f"implausible perturbed score {s_pert}")

    # ---- per-view numbers (outside the counted run) ----
    fn = make_eval_render(pp, img_h, img_w, sh_degree)
    tile_h, tile_w = pp.tile_size
    tiles_x = -(-img_w // tile_w)
    npix = tile_h * tile_w
    record = None
    worst = 0.0
    for i in range(n_views):
        args = (prepared, active, batch.view[i], batch.proj[i],
                batch.planes[i], batch.center[i])
        render_ms = time_ms(lambda: fn(*args))
        with torch.no_grad():
            origin, extend = masked_chunk_aabb(prepared, active,
                                               pp.cluster_size)
            culled = render_preprocess(prepared, origin, extend,
                                       batch.planes[i], batch.center[i],
                                       sh_degree, pp)
            view = render(culled, batch.view[i], batch.proj[i], img_h,
                          img_w, pp)
        aux, table = view.aux, view.aux.table
        kargs = (aux.mean_pix.contiguous(), aux.inv_cov.contiguous(),
                 aux.color_chan.contiguous(), aux.opacity.contiguous(),
                 table.sorted_point, table.tile_start, table.tile_count,
                 tiles_x, tile_h, tile_w)
        # the kernel's launch alone, and with the table check the wrapper
        # runs when its caller has not checked the table (one host wait)
        kernel_ms = time_ms(lambda: raster_cuda.raster_forward(
            *kargs, table_checked=True))
        checked_ms = time_ms(lambda: raster_cuda.raster_forward(*kargs))
        pairs = pair_counts(kargs)
        m, nchan = aux.opacity.numel(), aux.color_chan.shape[0]
        tiles = table.tile_count.numel()
        nbytes = 4 * (m * (6 + nchan) + table.num_entries + 2 * tiles
                      + tiles * (nchan + 1) * npix)
        bound_ms, bound_by, walked_ms = raster_bounds(nbytes, pairs,
                                                      OPS_PER_PAIR)

        # the kernel against its plain version on a sample of this view's
        # tiles, the tile with the most entries among them
        cnt = table.tile_count
        sub, n_pick = sample_tiles(cnt, 10 + i)
        sargs = kargs[:6] + (sub,) + kargs[7:]
        col, trans = raster_cuda.raster_forward(*sargs)
        col_p, trans_p = raster_cuda.raster_forward_plain(*sargs)
        d = max(max_diff(col, col_p), max_diff(trans, trans_p))
        worst = max(worst, d)
        print(f"view {i}: visible={int(view.sizes[0])} "
              f"rows={int(view.sizes[1])} entries={int(view.sizes[2])} "
              f"max_tile={int(cnt.max())} render_ms={render_ms:.3f} "
              f"kernel_ms={kernel_ms:.3f} kernel_with_check_ms="
              f"{checked_ms:.3f} "
              + pair_line(pairs, kernel_ms, bound_ms, bound_by, walked_ms)
              + f" sample_tiles={n_pick} sample_entries={int(sub.sum())} "
              f"max|diff|={d:.3e}")
        if not d <= TOL:
            fail(f"raster kernel vs plain on view {i}'s sample: {d} > {TOL}")
        if i == 0:
            plain_ms = time_ms(
                lambda: raster_cuda.raster_forward_plain(*kargs))
            print(f"view 0: plain raster version {plain_ms:.3f} ms")
            record = dict(FWD_RECORD, ms=kernel_ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None)
    record["max_abs_err"] = worst
    return record, batch, binned


def profile_steps(fn, n_steps: int):
    """Run ``fn()`` (``n_steps`` steps) under torch.profiler: (wall ms,
    device busy ms, device kernels and copies, each per step, and the 8
    host operators with the most device time of their own kernels as
    (name, ms per step))."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    top = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda e: -e.self_device_time_total)[:8]
    return (wall_us / n_steps / 1e3, busy_us / n_steps / 1e3,
            sum(e.count for e in device) / n_steps,
            [(e.key, e.self_device_time_total / n_steps / 1e3) for e in top])


def chunk_snapshot(state, chunks, chunk_size: int):
    """Copies of every parameter and moment of the given chunks."""
    out = []
    for t in [*state.params.fields().values(), *state.adam.exp_avg.values(),
              *state.adam.exp_avg_sq.values()]:
        t = t.detach()
        out.append(t.reshape(*t.shape[:-1], -1, chunk_size)[..., chunks, :]
                   .clone())
    return out


def phase_training(dev, prepared, active: int, batch, sh_degree: int):
    """Train at full width through make_train_step; returns (forward
    launches, backward kernel record, views binned by the 'keys' kernels in
    the training windows, the launches the route checks counted on the
    trained model)."""
    import torch
    from litegs_torch import config, evaluation
    from litegs_torch.ops import binning, losses, raster, raster_cuda
    from litegs_torch.ops.projection import ndc_to_pixel
    from litegs_torch.render import _project, render, render_preprocess
    from litegs_torch.scene import pad_params
    from litegs_torch.training import densify, optimizer
    from litegs_torch.training import statistics as tstats
    from litegs_torch.training.trainer import (TrainState, make_train_step,
                                               masked_chunk_aabb)
    from litegs_torch.utils import math as um

    n_views, _, img_h, img_w = batch.images.shape
    pp = config.PipelineParams()
    lp = config.ModelParams(sh_degree=sh_degree)
    op = config.OptimizationParams()
    chunk = pp.cluster_size
    cap = config.round_up(int(active * CAPACITY_FACTOR), chunk)
    caps = config.CapacityParams(primitive_capacity=cap)
    rng = np.random.default_rng(3)
    model = prepared.mapped(torch.clone)
    with torch.no_grad():
        model.sh_0 += torch.from_numpy(rng.normal(
            0.0, SH0_NOISE, tuple(model.sh_0.shape)).astype(np.float32)
        ).to(dev)
    params = pad_params(model, cap)
    state = TrainState(params, optimizer.init_adam(params), active, 0)
    steady = make_train_step(lp, op, pp, caps, img_h, img_w, 1.0,
                             sh_degree, False)
    collect = make_train_step(lp, op, pp, caps, img_h, img_w, 1.0,
                              sh_degree, True)
    psnr0 = evaluation.score_split(state.params, active, batch, pp,
                                   sh_degree)["psnr"]

    def run(state, stats, fn, n_steps, step_ms=None, check_culled=False):
        """n_steps steps over the views in order, AABBs refreshed every
        len(views) steps (an epoch); returns (state, stats, losses)."""
        out = []
        for s in range(n_steps):
            i = s % n_views
            if i == 0:
                with torch.no_grad():
                    origin, extend = masked_chunk_aabb(
                        state.params, state.active_count, chunk)
            args = (origin, extend, batch.view[i], batch.proj[i],
                    batch.planes[i], batch.center[i], batch.images[i])
            culled = None
            if check_culled and s < n_views:
                vis = um.frustum_culling_aabb(batch.planes[i], origin,
                                              extend)
                culled = torch.nonzero(~vis).flatten()
                before = chunk_snapshot(state, culled, chunk)
            marks = Marks()
            marks.mark("start")
            state, stats, metrics = fn(state, stats, *args)
            marks.mark("step")
            ms = marks.split()[0][1]
            if step_ms is not None:
                step_ms.append(ms)
            out.append(metrics["loss"])
            if culled is not None:
                after = chunk_snapshot(state, culled, chunk)
                if not all(torch.equal(a, b) for a, b in zip(before, after)):
                    fail(f"step {s} changed a culled chunk")
                n_live = int((culled < state.active_count // chunk).sum())
                print(f"step {s}: {culled.numel()} culled chunks "
                      f"({n_live} live) unchanged by the step")
        return state, stats, torch.stack(out).cpu().numpy()

    # ---- window A: steady steps ----
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    zero_path_counts()
    state, _, loss_a = run(state, None, steady, STEADY_STEPS, step_ms,
                           check_culled=True)
    fwd_a, bwd_a, win_a = read_path_counts("training steady window",
                                           STEADY_STEPS, 0)
    psnr1 = evaluation.score_split(state.params, active, batch, pp,
                                   sh_degree)["psnr"]
    first, last = float(loss_a[:4].mean()), float(loss_a[-4:].mean())
    print(f"steady losses: {np.array2string(loss_a, precision=5)}")
    print(f"loss first 4 mean {first:.6f}, last 4 mean {last:.6f}; "
          f"score_split PSNR {psnr0:.3f} -> {psnr1:.3f} dB")
    if not np.isfinite(loss_a).all() or not last < first:
        fail(f"steady loss did not fall: {first} -> {last}")
    if not psnr1 > psnr0:
        fail(f"PSNR did not rise over the steady steps: {psnr0} -> {psnr1}")

    # ---- window B: statistics, densify + resort, grown model ----
    dp = config.DensifyParams(target_primitives=TARGET_PRIMITIVES,
                              densify_from=0, densify_until=2,
                              densification_interval=1,
                              opacity_reset_interval=100)
    zero_path_counts()
    stats = tstats.init_stats(cap, dev)
    state, stats, loss_s = run(state, stats, collect, STATS_STEPS)
    t0 = time.perf_counter()
    params, adam, grown, did = densify.densify_step(
        state.params, state.adam, stats, active, 1, dp, 2, active, 1.0,
        chunk, generator=torch.Generator().manual_seed(0))
    params, adam = densify.spatial_refine(params, adam, grown)
    torch.cuda.synchronize()
    densify_s = time.perf_counter() - t0
    state = state._replace(params=params, adam=adam, active_count=grown)
    state, _, loss_g = run(state, None, steady, GROWN_STEPS)
    fwd_b, bwd_b, win_b = read_path_counts("training stats/densify window",
                                           STATS_STEPS + GROWN_STEPS, 0)
    peak = torch.cuda.max_memory_allocated()
    print(f"statistics: frag_count total {float(stats.frag_count.sum()):.0f}"
          f", points with weight {int((stats.weight_sum > 0).sum())}; "
          f"densify + resort {densify_s:.2f} s: active {active} -> {grown}"
          f"; losses stats {np.array2string(loss_s, precision=5)} grown "
          f"{np.array2string(loss_g, precision=5)}")
    print(f"peak device memory (training): {peak / 2**30:.2f} GiB")
    if not (did and grown > active and (grown - active) % chunk == 0):
        fail(f"densify did not grow by chunks: {active} -> {grown}")
    if not (np.isfinite(loss_s).all() and np.isfinite(loss_g).all()):
        fail("non-finite loss after densification")

    med = statistics.median(step_ms[WARMUP_STEPS:])
    print(f"train step: median {med:.3f} ms over {len(step_ms) - WARMUP_STEPS}"
          f" steady steps (CUDA events, whole step with its host waits), "
          f"{1e3 / med:.2f} it/s; the reference LiteGS trains garden at "
          f"{BASELINE_ITS:.0f} it/s on an RTX 3090 (that card's number, "
          f"BASELINE.md)")

    # ---- one step split by stage (outside the counted windows; it
    # ---- updates the model, which only the timings below use) ----
    tile_h, tile_w = pp.tile_size
    tiles_x, tiles_y = -(-img_w // tile_w), -(-img_h // tile_h)
    params = state.params
    gt = batch.images[0]
    for _ in range(2):          # the second pass is the one reported
        params.zero_grad(set_to_none=True)
        with torch.no_grad():
            origin, extend = masked_chunk_aabb(params, state.active_count,
                                               chunk)
        marks = Marks()
        marks.mark("start")
        culled = render_preprocess(params, origin, extend, batch.planes[0],
                                   batch.center[0], sh_degree, pp)
        marks.mark("preprocess")
        view_pos, ndc, inv_cov = _project(culled, batch.view[0],
                                          batch.proj[0], img_h, img_w)
        marks.mark("projection")
        table = binning.build_tile_table(
            ndc.detach(), view_pos[2].detach(), inv_cov.detach(),
            culled.opacity.detach(), culled.valid, img_h, img_w, tile_h,
            tile_w)
        marks.mark("binning")
        mean_pix = ndc_to_pixel(ndc, img_h, img_w)
        tiles_color, tiles_trans, _ = raster.rasterize(
            mean_pix, inv_cov, culled.color, culled.opacity, table,
            tiles_x * tiles_y, tiles_x, tile_h, tile_w)
        marks.mark("raster forward")
        img = torch.clamp(um.tiles_to_img(tiles_color, img_h, img_w, tile_h,
                                          tile_w)[:3], 0.0, 1.0)
        loss = losses.fused_l1_ssim_loss(img, gt, op.lambda_dssim)
        marks.mark("loss")
        tiles_color.register_hook(
            lambda g: marks.mark("loss backward") or g)
        mean_pix.register_hook(lambda g: marks.mark("raster backward") or g)
        loss.backward()
        marks.mark("rest of autograd")
        mask = torch.zeros(cap // chunk, dtype=torch.bool, device=dev)
        mask[culled.chunk_ids] = True
        optimizer.sparse_adam_step(
            params, {k: v.grad for k, v in params.fields().items()},
            state.adam, optimizer.LearningRates.from_config(
                op, 1.0, state.step), mask, chunk)
        marks.mark("adam")
        split = marks.split()
    total = sum(ms for _, ms in split)
    print("step stages (view 0, CUDA events): " + ", ".join(
        f"{name} {ms:.3f} ms" for name, ms in split)
        + f"; sum {total:.3f} ms (binning: the default streaming route)")

    # ---- the device's busy share over one epoch of steps ----
    box = [state]

    def epoch():
        box[0] = run(box[0], None, steady, n_views)[0]

    wall, busy, kernels, top = profile_steps(epoch, n_views)
    state = box[0]
    print(f"profiled {n_views} steps: wall {wall:.3f} ms/step, device busy "
          f"{busy:.3f} ms/step ({100 * busy / wall:.1f}% of wall), "
          f"{kernels:.0f} device kernels and copies per step; top by device "
          "time (ms/step): " + ", ".join(f"{k} {ms:.3f}" for k, ms in top))

    # ---- the backward kernel alone on view 0, and against its plain ----
    # ---- version on sampled tiles ----
    params.zero_grad(set_to_none=True)
    with torch.no_grad():
        origin, extend = masked_chunk_aabb(params, state.active_count, chunk)
    culled = render_preprocess(params, origin, extend, batch.planes[0],
                               batch.center[0], sh_degree, pp)
    out = render(culled, batch.view[0], batch.proj[0], img_h, img_w, pp)
    aux, table = out.aux, out.aux.table
    aux.tiles_color.retain_grad()
    losses.fused_l1_ssim_loss(out.img, gt, op.lambda_dssim).backward()
    kargs = (aux.mean_pix.detach().contiguous(),
             aux.inv_cov.detach().contiguous(),
             aux.color_chan.detach().contiguous(),
             aux.opacity.detach().contiguous(), table.sorted_point,
             table.tile_start, table.tile_count, tiles_x, tile_h, tile_w)
    col, trans = aux.tiles_color.detach(), aux.tiles_trans.detach()
    cot = (aux.tiles_color.grad, torch.zeros_like(trans))
    params.zero_grad(set_to_none=True)
    bwd_ms = time_ms(lambda: raster_cuda.raster_backward(
        *kargs, col, trans, *cot, table_checked=True))
    bwd_stats_ms = time_ms(lambda: raster_cuda.raster_backward(
        *kargs, col, trans, *cot, with_stats=True, table_checked=True))
    npix = tile_h * tile_w
    pairs = pair_counts(kargs)
    g = raster_cuda.raster_backward(*kargs, col, trans, *cot,
                                    with_stats=True, table_checked=True)
    frag_count = int(g.frag_count.double().sum())
    m, nchan = aux.opacity.numel(), aux.color_chan.shape[0]
    ncol = nchan + 6
    tiles = table.tile_count.numel()
    # inputs once (the forward's outputs and their cotangents among
    # them), outputs once
    nbytes = 4 * (m * (6 + nchan) + table.num_entries + 2 * tiles
                  + 2 * tiles * (nchan + 1) * npix + ncol * m)
    bound_ms, bound_by, walked_ms = raster_bounds(
        nbytes, pairs, OPS_PER_PAIR + OPS_PER_CONTRIB_BWD + ncol)
    plain_ms = time_ms(lambda: raster_cuda.raster_backward_plain(
        *kargs, col, trans, *cot), repeats=1)
    sub, n_pick = sample_tiles(table.tile_count, 20)
    sargs = kargs[:6] + (sub,) + kargs[7:]
    worst, flips = check_backward(
        raster_cuda.raster_backward(*sargs, col, trans, *cot,
                                    with_stats=True),
        raster_cuda.raster_backward_plain(*sargs, col, trans, *cot,
                                          with_stats=True),
        "on view 0's sampled tiles", flip_rate=STOP_FLIP_RATE)
    print(f"backward view 0: entries={table.num_entries} "
          f"max_tile={int(table.tile_count.max())} kernel_ms={bwd_ms:.3f} "
          f"kernel_stats_ms={bwd_stats_ms:.3f} frag_count_sum={frag_count} "
          + pair_line(pairs, bwd_ms, bound_ms, bound_by, walked_ms)
          + f" plain_ms={plain_ms:.3f} sample_tiles={n_pick} "
          f"sample_entries={int(sub.sum())} max|diff|={worst:.3e} "
          f"frag_count_flips={flips:.0f}")
    record = dict(BWD_RECORD, launches=bwd_a + bwd_b, ms=bwd_ms,
                  plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                  library_ms=None, max_abs_err=worst)
    route_launches, _ = phase_stream_routes(
        dev, "trained model", state.params, state.active_count, batch,
        sh_degree, timed=False)
    return fwd_a + fwd_b, record, win_a + win_b, route_launches


def phase_trainer(dev):
    """The Trainer through its own API on tests/test_training.py's task."""
    from litegs_torch import config
    from litegs_torch.data import synthetic_train
    from litegs_torch.training.trainer import Trainer
    t0 = time.perf_counter()
    data, xyz, rgb = synthetic_train.make_task(
        n_points=500, n_frames=8, img_h=48, img_w=64, sh_degree=1, seed=3,
        device=dev)
    trainer = Trainer(
        lp=config.ModelParams(sh_degree=1),
        op=config.OptimizationParams(iterations=96,
                                     position_lr_max_steps=96),
        pp=config.PipelineParams(),
        dp=config.DensifyParams(densification_interval=2, densify_from=1,
                                densify_until=6, opacity_reset_interval=100,
                                target_primitives=1024),
        caps=config.CapacityParams(primitive_capacity=2048), data=data,
        spatial_lr_scale=4.4)
    state = trainer.init_state(xyz, rgb)
    _, _, m0 = trainer.run_epoch(state, trainer.init_stats(), 0,
                                 frame_ids=[0])
    state, _, hist = trainer.train(xyz, rgb, verbose=False)
    final = hist[-1]["psnr"]
    print(f"trainer: {trainer.total_epochs * trainer.n_frames} iterations "
          f"in {time.perf_counter() - t0:.1f} s; first-epoch PSNR "
          f"{m0['psnr']:.2f} -> final {final:.2f} dB; active "
          f"{[h['active'] for h in hist]}")
    if not (final >= m0["psnr"] + 2.0 and final > 22.0):
        fail(f"Trainer PSNR {m0['psnr']} -> {final} misses the bars")


def write_colmap_scene(root: str, cam, frames, xyz, rgb, images):
    """A binary COLMAP scene: cameras.bin (one PINHOLE camera), images.bin
    (no 2D points), points3D.bin (empty tracks) and images/<name> PNGs."""
    import PIL.Image
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", cam.id, 1, cam.width, cam.height))
        f.write(struct.pack("<4d", cam.focal_x, cam.focal_y, cam.width / 2,
                            cam.height / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(frames)))
        for fr in frames:
            f.write(struct.pack("<i4d3di", fr.id, *fr.qvec, *fr.tvec,
                                cam.id))
            f.write(fr.name.encode() + b"\x00" + struct.pack("<Q", 0))
    rec = np.zeros(len(xyz), np.dtype([
        ("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("err", "<f8"),
        ("track_len", "<u8")]))
    rec["id"] = np.arange(len(xyz))
    rec["xyz"] = xyz
    rec["rgb"] = np.round(rgb * 255)
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        f.write(rec.tobytes())
    os.makedirs(os.path.join(root, "images"))
    for fr, img in zip(frames, images):
        arr = (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        PIL.Image.fromarray(arr.transpose(1, 2, 0)).save(
            os.path.join(root, "images", fr.name))


class Timed:
    """Wraps module attributes so that each call's host seconds are kept
    (and, for save_checkpoint, a host copy of the tree it saves); restores
    them on exit."""

    def __init__(self, module, names, keep_tree=False):
        self.module, self.names, self.keep_tree = module, names, keep_tree
        self.seconds = {n: [] for n in names}
        self.trees = []

    def __enter__(self):
        import torch
        from litegs_torch.io import checkpoint
        self.real = {n: getattr(self.module, n) for n in self.names}

        def wrap(name, fn):
            def timed(*a, **k):
                if self.keep_tree and name == "save_checkpoint":
                    self.trees.append({
                        key: v.detach().cpu().clone() if torch.is_tensor(v)
                        else v for key, v in checkpoint._leaves(a[2])})
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                self.seconds[name].append(time.perf_counter() - t0)
                if self.keep_tree and name == "load_checkpoint":
                    self.trees.append({
                        key: v.detach().cpu().clone() if torch.is_tensor(v)
                        else v for key, v in checkpoint._leaves(out[1])})
                return out
            return timed

        for n, fn in self.real.items():
            setattr(self.module, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.module, n, fn)


def zero_path_counts():
    from litegs_torch.ops import raster_cuda, raster_plain
    raster_cuda.LAUNCHES = raster_cuda.LAUNCHES_BWD = 0
    raster_plain.CALLS = raster_plain.BACKWARD_CALLS = 0
    reset_binning_counts()


def read_path_counts(what: str, steps: int, views: int,
                     step_views: int = 1):
    """The launches (forward, backward, views binned) of the path's kernels
    since zero_path_counts: one forward per step and per evaluated view,
    one backward per step, the binning kernels once each per view binned
    (``step_views`` per step), no other kernel, no plain call."""
    return read_counts(what, steps + views, steps, steps * step_views + views)


def read_counts(what: str, forwards: int, backwards: int, binned: int):
    """The path's kernel launches since zero_path_counts against the
    expected forwards, backwards and views binned (the binning kernels once
    each a view); no other kernel, no plain call."""
    from litegs_torch.ops import binning_cuda, raster_cuda, raster_plain
    fwd, bwd = raster_cuda.LAUNCHES, raster_cuda.LAUNCHES_BWD
    plain = raster_plain.CALLS + raster_plain.BACKWARD_CALLS
    print(f"{what}: {forwards} forwards, {backwards} backwards, {binned} "
          f"views binned expected; raster_forward launches={fwd}, "
          f"raster_backward launches={bwd}, plain calls={plain}; "
          f"binning launches={binning_cuda.LAUNCHES}")
    if fwd != forwards or bwd != backwards or plain:
        fail(f"{what}: kernels launched {fwd} / {bwd} times for {forwards} "
             f"forwards and {backwards} backwards, {plain} plain calls")
    return fwd, bwd, check_binning_counts(what, binned)


def norm_quat_rows(extr):
    out = np.array(extr, np.float64)
    out[:, :4] /= np.linalg.norm(out[:, :4], axis=1, keepdims=True)
    return out


def phase_pose_step(dev):
    """One learnable-pose step at 96x128 with the 'cuda' backend against
    the same step with the 'torch' backend: the extr gradient within the
    scaled 3e-4 bar."""
    import torch
    from litegs_torch import config
    from litegs_torch.data import synthetic, synthetic_train
    from litegs_torch.ops import pose
    from litegs_torch.scene import pad_params
    from litegs_torch.training import optimizer
    from litegs_torch.training import statistics as tstats
    from litegs_torch.training.trainer import (TrainState, make_train_step,
                                               masked_chunk_aabb)
    h, w = POSE_STEP_HW
    data, _, _ = synthetic_train.make_task(
        n_points=2000, n_frames=2, img_h=h, img_w=w, sh_degree=1, seed=3,
        device=dev)
    gt, _, _ = synthetic_train.make_gt_params(2000, 1, seed=3, device=dev)
    gt = pad_params(gt, config.round_up(2000, 128))
    extr = np.stack([f.extr_params() for f in synthetic.make_cameras(
        2, h, w, seed=3)[1]])
    extr[:, 4:] += np.random.default_rng(0).normal(0, 0.01, (2, 3))
    op = config.OptimizationParams(learnable_viewproj=True)
    grads = {}
    for backend in ("cuda", "torch"):
        params = gt.mapped(torch.clone)
        with torch.no_grad():
            origin, extend = masked_chunk_aabb(params, params.capacity, 128)
        step = make_train_step(
            config.ModelParams(sh_degree=1), op,
            config.PipelineParams(raster_backend=backend),
            config.CapacityParams(params.capacity), h, w, 1.0, 1, False,
            learnable_pose=True)
        _, _, _, m = step(
            TrainState(params, optimizer.init_adam(params), params.capacity,
                       0), tstats.init_stats(params.capacity, dev), origin,
            extend, None, data.proj[1], None, None, data.images[1],
            pose.init_pose_state(extr, dev), 1)
        grads[backend] = m["extr_grad"].double().cpu()
    d = float((grads["cuda"] - grads["torch"]).abs().max())
    scale = float(grads["torch"].abs().max())
    print(f"learnable-pose step {h}x{w}: extr gradient cuda "
          f"{grads['cuda'].numpy()} torch {grads['torch'].numpy()}; "
          f"max|diff| {d:.3e} of max|torch| {scale:.3e}")
    if not (scale > 0 and d <= BWD_TOL["grad"] * scale):
        fail(f"learnable-pose step: extr gradient differs by {d} against "
             f"max {scale}")


def phase_colmap(dev, prepared, active: int):
    """The command line on a COLMAP scene on disk at full width (phase 6);
    returns the path's kernel launches by record name, and the training
    run's argv (less -m), it/s and test PSNRs; the scene stays on disk
    for phases 7 to 11."""
    import torch
    from litegs_torch import config, evaluation, example_metrics
    from litegs_torch import example_train
    from litegs_torch import io as lio
    from litegs_torch.data import synthetic
    from litegs_torch.ops import pose
    from litegs_torch.scene import pad_params
    from litegs_torch.training import optimizer
    from litegs_torch.training import statistics as tstats
    from litegs_torch.training.trainer import TrainState

    shutil.rmtree(COLMAP_DIR, ignore_errors=True)
    scene = os.path.join(COLMAP_DIR, "scene")
    t0 = time.perf_counter()
    cam, frames = synthetic.make_cameras(COLMAP_VIEWS, IMG_H, IMG_W, seed=4)
    for fr in frames:
        fr.name = f"{fr.name}.png"
    from litegs_torch.training.trainer import camera_batch_from_frames
    blank = camera_batch_from_frames(
        cam, frames, np.zeros((COLMAP_VIEWS, 3, IMG_H, IMG_W), np.float32),
        device=dev)
    pp = config.PipelineParams()
    gt = [img for _, img in evaluation.render_views(prepared, active, blank,
                                                    pp, SH_DEGREE)]
    xyz, rgb = synthetic.make_gaussian_cloud(N_POINTS, seed=0)
    rng = np.random.default_rng(5)
    keep = rng.choice(N_POINTS, COLMAP_SEED_POINTS, replace=False)
    seed_xyz = xyz[keep] + rng.normal(0, 0.01, (COLMAP_SEED_POINTS, 3))
    write_colmap_scene(scene, cam, frames, seed_xyz, rgb[keep], gt)
    print(f"colmap scene: {COLMAP_VIEWS} PNGs {IMG_H}x{IMG_W}, "
          f"{COLMAP_SEED_POINTS} seed points, written in "
          f"{time.perf_counter() - t0:.1f} s")
    launches = np.zeros(3, np.int64)     # forward, backward, window

    def add(counts):
        launches[:] += counts

    n_train, n_test = COLMAP_VIEWS - 2, 2          # --eval: every 8th
    model = os.path.join(COLMAP_DIR, "model")
    common = ["-s", scene, "--eval", "--sh_degree", str(SH_DEGREE),
              "--target_primitives", str(COLMAP_TARGET)]
    train_args = ["--iterations", str(COLMAP_EPOCHS * n_train),
                  "--densify_from", "2", "--densification_interval", "3",
                  "--densify_until", "7", "--test_epochs", "3,7"]

    # ---- train: start -> Trainer -> ply export and checkpoint ----
    zero_path_counts()
    with Timed(lio, ["save_checkpoint", "save_ply"], keep_tree=True) as io_t:
        t0 = time.perf_counter()
        _, state, hist = example_train.main(
            common + train_args + ["-m", model, "--checkpoint_epochs", "2",
                                   "--save_epochs", "3"], device=dev)
        wall = time.perf_counter() - t0
    steps = COLMAP_EPOCHS * n_train
    add(read_path_counts("colmap training run", steps, 2 * n_test))
    epoch_s = [h["seconds"] for h in hist]
    actives = [h["active"] for h in hist]
    print(f"colmap training run: {wall:.1f} s wall; per epoch (host clock, "
          f"boundary included) {np.round(epoch_s, 3).tolist()} s, "
          f"{steps / sum(epoch_s):.2f} it/s over start's loop with densify;"
          f" active {actives}; train PSNR "
          f"{np.round([h['psnr'] for h in hist], 2).tolist()}; test PSNR "
          f"epoch 3 {hist[3]['test_psnr']:.3f}, epoch 7 "
          f"{hist[7]['test_psnr']:.3f}; ply export "
          f"{np.round(io_t.seconds['save_ply'], 3).tolist()} s; checkpoint "
          f"{np.round(io_t.seconds['save_checkpoint'], 3).tolist()} s")
    if len(hist) != COLMAP_EPOCHS or not np.isfinite(
            [h["loss"] for h in hist]).all():
        fail(f"colmap training run: history {hist}")
    if not actives[-1] > actives[0] or len(set(actives)) < 2:
        fail(f"colmap training run: no densify event grew the model "
             f"{actives}")
    if not hist[-1]["psnr"] > hist[0]["psnr"] + 3.0:
        fail("colmap training run: train PSNR did not rise by 3 dB")
    finish = os.path.join(model, "point_cloud", "finish", "point_cloud.ply")
    for path in (finish, os.path.join(model, "point_cloud",
                                      f"iteration_{4 * n_train}",
                                      "point_cloud.ply")):
        if not os.path.exists(path):
            fail(f"colmap training run wrote no {path}")

    # ---- metrics on the finish ply ----
    zero_path_counts()
    t0 = time.perf_counter()
    res = example_metrics.main(["-s", scene, "-m", model, "--skip_train"],
                               device=dev)
    metrics_s = time.perf_counter() - t0
    add(read_path_counts("colmap metrics", 0, n_test))
    d = abs(res["test"]["psnr"] - hist[-1]["test_psnr"])
    print(f"colmap metrics: {metrics_s:.1f} s; test {json.dumps(res['test'])}"
          f"; |PSNR - training's last test PSNR| {d:.5f} dB")
    if not d <= 0.01:
        fail(f"example_metrics PSNR {res['test']['psnr']} against training's "
             f"{hist[-1]['test_psnr']}")

    # ---- resume from the epoch-2 checkpoint ----
    zero_path_counts()
    ckpt = os.path.join(model, "checkpoints", "chkpnt2.npz")
    with Timed(lio, ["load_checkpoint"], keep_tree=True) as load_t:
        t0 = time.perf_counter()
        _, _, hist2 = example_train.main(
            common + train_args + ["-m", model + "_resumed",
                                   "--start_checkpoint", ckpt], device=dev)
        wall = time.perf_counter() - t0
    add(read_path_counts("colmap resumed run", (COLMAP_EPOCHS - 3) * n_train,
                         2 * n_test))
    saved, (restored,) = io_t.trees[0], load_t.trees
    same = set(saved) == set(restored) and all(
        torch.equal(v, restored[k]) if torch.is_tensor(v)
        else v == restored[k] for k, v in saved.items())
    print(f"colmap resume: {len(saved)} arrays restored bit for bit: {same};"
          f" load {load_t.seconds['load_checkpoint'][0]:.3f} s; run "
          f"{wall:.1f} s, epochs {[h['epoch'] for h in hist2]}, final "
          f"test PSNR {hist2[-1]['test_psnr']:.3f}")
    if not same or [h["epoch"] for h in hist2] != list(range(3,
                                                             COLMAP_EPOCHS)):
        fail("colmap resume: the restored state differs from the saved one "
             "or the run did not finish")
    if not os.path.exists(os.path.join(model + "_resumed", "point_cloud",
                                       "finish", "point_cloud.ply")):
        fail("colmap resume wrote no finish ply")

    # ---- pose leg: ground-truth gaussians, noisy extrinsics ----
    train_frames = [fr for i, fr in enumerate(frames) if i % 8]
    true_extr = np.stack([fr.extr_params() for fr in train_frames])
    rng = np.random.default_rng(0)
    noisy = true_extr.copy()
    noisy[:, 4:] += rng.normal(scale=0.01, size=(n_train, 3))
    noisy[:, :4] += rng.normal(scale=0.004, size=(n_train, 4))
    cap = config.auto_capacity(COLMAP_TARGET).primitive_capacity
    params = pad_params(prepared, cap)
    tree = {"state": TrainState(params, optimizer.init_adam(params), active,
                                0),
            "stats": tstats.init_stats(cap, dev),
            "pose": pose.init_pose_state(noisy, dev)}
    ckpt = lio.save_checkpoint(os.path.join(COLMAP_DIR, "pose_init"), -1,
                               tree)
    del tree, params
    zero_path_counts()
    tiny = "1e-12"      # frozen (the xyz schedule takes a logarithm)
    model_pose = os.path.join(COLMAP_DIR, "model_pose")
    t0 = time.perf_counter()
    _, _, hist3 = example_train.main(
        common + ["-m", model_pose, "--learnable_viewproj",
                  "--iterations", str(POSE_EPOCHS * n_train),
                  "--position_lr_init", tiny, "--position_lr_final", tiny,
                  "--feature_lr", "0", "--opacity_lr", "0", "--scaling_lr",
                  "0", "--rotation_lr", "0", "--densify_from", "1000000000",
                  "--start_checkpoint", ckpt], device=dev)
    wall = time.perf_counter() - t0
    add(read_path_counts("colmap pose leg", POSE_EPOCHS * n_train, 0))
    learned = np.load(os.path.join(model_pose, "viewproj.npz"))["extr"]
    err0 = np.linalg.norm(norm_quat_rows(noisy) - norm_quat_rows(true_extr))
    err1 = np.linalg.norm(norm_quat_rows(learned)
                          - norm_quat_rows(true_extr))
    psnr0, psnr1 = hist3[0]["psnr"], hist3[-1]["psnr"]
    print(f"colmap pose leg: {POSE_EPOCHS * n_train} steps in {wall:.1f} s;"
          f" extr error {err0:.5f} -> {err1:.5f} ({err1 / err0:.3f} of it);"
          f" train PSNR epoch 0 {psnr0:.3f} -> epoch {POSE_EPOCHS - 1} "
          f"{psnr1:.3f} dB; viewproj.npz {learned.shape}")
    if not (err1 < 0.93 * err0 and psnr1 > psnr0 + 1.0):
        fail(f"pose leg misses tests/test_pose.py's bars: err {err0} -> "
             f"{err1}, PSNR {psnr0} -> {psnr1}")
    run_b1 = {"argv": common + train_args, "epoch_s": epoch_s,
              "test_psnr": (hist[3]["test_psnr"], hist[7]["test_psnr"])}
    return dict(zip(("raster_forward", "raster_backward",
                     "bin_count_kernel"), launches.tolist())), run_b1


def sliced_grads(g, lo: int, hi: int):
    """The PointGrads of points [lo, hi)."""
    return type(g)(*[None if x is None else x[..., lo:hi] for x in g])


def check_batched_render(dev, prepared, active: int, batch, sh_degree: int,
                         b: int, counts):
    """render_batch over views 0..b-1 with its launches counted, held to b
    single renders (images, tile outputs, primitive_visible and sizes bit
    for bit); then the merged backward held to the b single backwards and
    both merged kernels timed against the sum of the single launches.
    Returns the largest backward difference."""
    import torch
    from litegs_torch import config
    from litegs_torch.ops import raster_cuda
    from litegs_torch.render import render, render_batch, render_preprocess
    from litegs_torch.training.trainer import masked_chunk_aabb
    pp = config.PipelineParams()
    img_h, img_w = batch.images.shape[-2:]
    with torch.no_grad():
        origin, extend = masked_chunk_aabb(prepared, active, pp.cluster_size)
        culled = [render_preprocess(prepared, origin, extend,
                                    batch.planes[i], batch.center[i],
                                    sh_degree, pp) for i in range(b)]
        zero_path_counts()
        out = render_batch(culled, batch.view[:b], batch.proj[:b], img_h,
                           img_w, pp)
        torch.cuda.synchronize()
        counts += read_counts(f"render_batch B={b}", 1, 0, b)
        singles = [render(culled[v], batch.view[v], batch.proj[v], img_h,
                          img_w, pp) for v in range(b)]
    aux, tab = out.aux, out.aux.table
    view_tiles = tab.tile_count.numel() // b
    tiles_x = -(-img_w // pp.tile_size[1])
    tiles_y = view_tiles // tiles_x
    for v, one in enumerate(singles):
        rows = slice(v * view_tiles, (v + 1) * view_tiles)
        same = (torch.equal(out.imgs[v], one.img)
                and torch.equal(aux.tiles_color[rows], one.aux.tiles_color)
                and torch.equal(aux.tiles_trans[rows], one.aux.tiles_trans)
                and torch.equal(out.primitive_visible[v],
                                one.primitive_visible)
                and torch.equal(out.sizes[v], one.sizes))
        if not same:
            fail(f"render_batch B={b}: view {v} differs from its own render")

    # the merged backward against each view's own, seeded cotangents
    kargs = (aux.mean_pix, aux.inv_cov, aux.color_chan, aux.opacity,
             tab.sorted_point, tab.tile_start, tab.tile_count, tiles_x,
             *pp.tile_size)
    sargs = [(a.mean_pix, a.inv_cov, a.color_chan, a.opacity,
              a.table.sorted_point, a.table.tile_start, a.table.tile_count,
              tiles_x, *pp.tile_size) for a in (one.aux for one in singles)]
    col, trans = aux.tiles_color, aux.tiles_trans
    gen = torch.Generator(device=dev).manual_seed(b)
    cot = (torch.randn(col.shape, generator=gen, device=dev),
           torch.randn(trans.shape, generator=gen, device=dev))
    merged = raster_cuda.raster_backward(*kargs, col, trans, *cot,
                                         with_stats=True, tiles_y=tiles_y)
    off, worst, frags = out.point_offsets, 0.0, 0.0
    for v, one in enumerate(singles):
        rows = slice(v * view_tiles, (v + 1) * view_tiles)
        own = raster_cuda.raster_backward(
            *sargs[v], one.aux.tiles_color, one.aux.tiles_trans,
            cot[0][rows], cot[1][rows], with_stats=True)
        d, _ = check_backward(sliced_grads(merged, off[v], off[v + 1]), own,
                              f"merged B={b} view {v}")
        worst = max(worst, d)
        frags += float(own.frag_count.double().sum())

    # merged kernels against the sum of the single launches
    fwd_ms = time_ms(lambda: raster_cuda.raster_forward(
        *kargs, table_checked=True, tiles_y=tiles_y))
    fwd_sum = sum(time_ms(lambda a=a: raster_cuda.raster_forward(
        *a, table_checked=True)) for a in sargs)
    bwd_ms = time_ms(lambda: raster_cuda.raster_backward(
        *kargs, col, trans, *cot, table_checked=True, tiles_y=tiles_y))
    bwd_sum = sum(time_ms(lambda v=v, a=a: raster_cuda.raster_backward(
        *a, singles[v].aux.tiles_color, singles[v].aux.tiles_trans,
        cot[0][v * view_tiles:(v + 1) * view_tiles],
        cot[1][v * view_tiles:(v + 1) * view_tiles], table_checked=True))
        for v, a in enumerate(sargs))
    print(f"render_batch B={b}: {b} views bit-equal to their own renders "
          f"(images, tiles, primitive_visible, sizes "
          f"{out.sizes.tolist()}); merged backward max|diff| {worst:.3e}, "
          f"frag_count equal ({frags:.0f} pairs); merged grid "
          f"{tab.tile_count.numel()} tiles, {tab.num_entries} entries: "
          f"forward kernel {fwd_ms:.4f} ms against {fwd_sum:.4f} ms for "
          f"{b} single launches ({fwd_ms / fwd_sum:.4f}), backward "
          f"{bwd_ms:.4f} ms against {bwd_sum:.4f} ({bwd_ms / bwd_sum:.4f})")
    return worst


def phase_batched(dev, prepared, active: int, batch, sh_degree: int):
    """Batched views at full width (phase 7): render_batch at B = 2 and 4
    against single renders, one B = 2 step against the mean of two
    single-view losses through the same sparse Adam, and steps timed at
    B = 1, 2 and 4.  Returns (launches [forward, backward, window], the
    largest backward difference)."""
    import torch
    from litegs_torch import config
    from litegs_torch.ops import losses
    from litegs_torch.render import render, render_preprocess
    from litegs_torch.scene import cluster, pad_params
    from litegs_torch.training import optimizer
    from litegs_torch.training.trainer import (TrainState,
                                               make_batch_train_step,
                                               make_train_step,
                                               masked_chunk_aabb)
    t_phase = time.perf_counter()
    counts = np.zeros(3, np.int64)
    worst = max(check_batched_render(dev, prepared, active, batch, sh_degree,
                                     b, counts) for b in BATCH_SIZES)

    # ---- one B = 2 step against two single-view losses' mean ----
    n_views, _, img_h, img_w = batch.images.shape
    pp = config.PipelineParams()
    lp = config.ModelParams(sh_degree=sh_degree)
    op = config.OptimizationParams()
    chunk = pp.cluster_size
    # the training phase's model: sh_0 perturbed, padded for growth
    cap = config.round_up(int(active * CAPACITY_FACTOR), chunk)
    caps = config.CapacityParams(primitive_capacity=cap)
    rng = np.random.default_rng(3)
    base = prepared.mapped(torch.clone)
    gen = torch.Generator(device=dev).manual_seed(7)
    with torch.no_grad():
        base.sh_0 += torch.from_numpy(rng.normal(
            0.0, SH0_NOISE, tuple(base.sh_0.shape)).astype(np.float32)
        ).to(dev)
    base = pad_params(base, cap)
    with torch.no_grad():
        origin, extend = masked_chunk_aabb(base, active, chunk)
    adam0 = optimizer.init_adam(base)
    for m in adam0.exp_avg.values():
        m.normal_(0.0, 1e-4, generator=gen)
    for v in adam0.exp_avg_sq.values():
        v.uniform_(1e-8, 1e-6, generator=gen)

    def fresh():
        return TrainState(base.mapped(torch.clone), optimizer.AdamState(
            *[{k: t.clone() for k, t in d.items()} for d in adam0]),
            active, 0)

    state_b, _, mb = make_batch_train_step(
        lp, op, pp, caps, img_h, img_w, 1.0, sh_degree, 2, False)(
        fresh(), None, origin, extend, batch.view[:2], batch.proj[:2],
        batch.planes[:2], batch.center[:2], batch.images[:2])
    ref = fresh()
    params, mask, loss = ref.params, None, 0.0
    for v in range(2):
        culled = render_preprocess(params, origin, extend, batch.planes[v],
                                   batch.center[v], sh_degree, pp)
        img = render(culled, batch.view[v], batch.proj[v], img_h, img_w,
                     pp).img
        loss = loss + losses.fused_l1_ssim_loss(img, batch.images[v],
                                                op.lambda_dssim)
        vis = cluster.scatter_chunk_mask(culled.chunk_ids,
                                         culled.num_visible_chunks,
                                         params.capacity // chunk)
        mask = vis if mask is None else mask | vis
    loss = loss / 2
    loss.backward()
    optimizer.sparse_adam_step(
        params, {k: t.grad for k, t in params.fields().items()}, ref.adam,
        optimizer.LearningRates.from_config(op, 1.0, 0), mask, chunk)
    loss = float(loss.detach())
    d_loss = abs(float(mb["loss"]) - loss)
    rel = {}
    for name, got, want in (
            ("params", state_b.params.fields(), params.fields()),
            ("exp_avg", state_b.adam.exp_avg, ref.adam.exp_avg),
            ("exp_avg_sq", state_b.adam.exp_avg_sq, ref.adam.exp_avg_sq)):
        for k in want:
            a, w = got[k].detach(), want[k].detach()
            rel[f"{name} {k}"] = float((a - w).abs().max()) / (
                float(w.abs().max()) + 1e-30)
    print(f"batched step B=2 against the mean of two single-view losses: "
          f"loss {float(mb['loss']):.6f} (|diff| {d_loss:.3e}); max|diff| / "
          f"max|ref| " + ", ".join(f"{k} {r:.2e}" for k, r in rel.items()))
    for k, r in rel.items():
        bar = 1e-5 if k.startswith("params") else BWD_TOL["grad"]
        if not r <= bar:
            fail(f"batched step: {k} differs by {r} of its largest, bar "
                 f"{bar}")
    if not d_loss <= 1e-6 * abs(loss):
        fail(f"batched step: loss {float(mb['loss'])} against {loss}")
    del state_b, ref, params

    # ---- steps at B = 1, 2 and 4, in turns: ms per step and per view ----
    per_b = {}
    for b in (1, *BATCH_SIZES, *BATCH_SIZES[::-1], 1):
        step = (make_train_step(lp, op, pp, caps, img_h, img_w, 1.0,
                                sh_degree, False) if b == 1 else
                make_batch_train_step(lp, op, pp, caps, img_h, img_w, 1.0,
                                      sh_degree, b, False))
        box = [fresh()]

        def run(n_steps, times=None):
            for s in range(n_steps):
                ids = [(s * b + k) % n_views for k in range(b)]
                args = [t[ids[0]] if b == 1 else t[ids[0]:ids[0] + b]
                        for t in (batch.view, batch.proj, batch.planes,
                                  batch.center, batch.images)]
                marks = Marks()
                marks.mark("start")
                box[0], _, metrics = step(box[0], None, origin, extend,
                                          *args)
                marks.mark("step")
                if times is not None:
                    times.append(marks.split()[0][1])
                if not bool(torch.isfinite(metrics["loss"])):
                    fail(f"B={b}: non-finite loss")

        times = []
        zero_path_counts()
        run(BATCH_STEPS, times)
        counts += read_path_counts(f"batched steps B={b}", BATCH_STEPS, 0,
                                   step_views=b)
        wall, busy, kernels, _ = profile_steps(
            lambda: run(BATCH_PROFILE_STEPS), BATCH_PROFILE_STEPS)
        med = statistics.median(times[BATCH_WARMUP:])
        per_b.setdefault(b, []).append(med)
        print(f"batched steps B={b}: median {med:.3f} ms/step, "
              f"{med / b:.3f} ms/view over {BATCH_STEPS - BATCH_WARMUP} steps "
              f"(CUDA events); profiled {BATCH_PROFILE_STEPS} steps: wall "
              f"{wall:.3f} ms/step, device busy {busy:.3f} ms/step "
              f"({busy / b:.3f} ms/view, {100 * busy / wall:.1f}% of wall), "
              f"{kernels:.0f} kernels and copies per step "
              f"({kernels / b:.0f} per view)")
        del box
    print("batched steps: ms per view " + ", ".join(
        f"B={b} " + " / ".join(f"{ms / b:.3f}" for ms in meds)
        for b, meds in per_b.items())
        + f"; phase 7 (less the command line) "
          f"{time.perf_counter() - t_phase:.1f} s")
    return counts, worst


def phase_batch_cli(dev, run_b1: dict):
    """example_train --batch_views 2 on phase 6's COLMAP scene (8 train
    frames, 4 groups per epoch), beside phase 6's B = 1 run.  Returns the
    launches [forward, backward, window]."""
    from litegs_torch import example_train
    zero_path_counts()
    t0 = time.perf_counter()
    trainer, state, hist = example_train.main(
        run_b1["argv"] + ["-m", os.path.join(COLMAP_DIR, "model_b2"),
                          "--batch_views", "2"], device=dev)
    wall = time.perf_counter() - t0
    n_train = trainer.n_frames
    steps = COLMAP_EPOCHS * n_train // 2
    counts = np.asarray(read_path_counts("colmap run --batch_views 2", steps,
                                         4, step_views=2))
    epoch_s = [h["seconds"] for h in hist]
    views = 2 * steps

    def rates(secs):
        # views/s over all epochs, and over epochs 1.. (the first warms up)
        return (f"{views / sum(secs):.2f} views/s, "
                f"{views * (len(secs) - 1) / len(secs) / sum(secs[1:]):.2f} "
                "from epoch 1")

    print(f"colmap run --batch_views 2: {wall:.1f} s wall; {steps} steps of "
          f"2 views; per epoch {np.round(epoch_s, 3).tolist()} s; "
          f"{steps / sum(epoch_s):.2f} it/s ({rates(epoch_s)}) over start's "
          f"loop, against {rates(run_b1['epoch_s'])} at B=1 in phase 6 "
          f"(epochs {np.round(run_b1['epoch_s'], 3).tolist()} s); active "
          f"{[h['active'] for h in hist]}; test PSNR epoch 3 "
          f"{hist[3]['test_psnr']:.3f}, epoch 7 {hist[7]['test_psnr']:.3f} "
          f"(B=1: {run_b1['test_psnr'][0]:.3f}, {run_b1['test_psnr'][1]:.3f})")
    if trainer.batch_views != 2 or state.step != steps:
        fail(f"--batch_views 2 ran {state.step} steps at B="
             f"{trainer.batch_views}")
    if not (np.isfinite([h["loss"] for h in hist]).all()
            and hist[-1]["psnr"] > hist[0]["psnr"] + 3.0):
        fail("colmap run --batch_views 2: train PSNR did not rise by 3 dB")
    return counts


def random_lpips_npz(path: str, seed: int = 7) -> str:
    """Seeded random LPIPS-vgg weights in the exporter's npz format."""
    rng = np.random.default_rng(seed)
    widths = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    out, cin = {}, 3
    for i, cout in enumerate(widths):
        w = rng.standard_normal((cout, cin, 3, 3)) * (2.0 / (cin * 9)) ** 0.5
        out[f"conv{i}_weight"] = w.astype(np.float32)
        out[f"conv{i}_bias"] = (0.1 * rng.standard_normal(cout)).astype(
            np.float32)
        cin = cout
    for k, t in enumerate((1, 3, 6, 9, 12)):
        out[f"lin{k}"] = np.abs(rng.standard_normal(widths[t])).astype(
            np.float32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **out)
    return path


def perturbed_model(dev, prepared, active: int):
    """The training phase's model: sh_0 perturbed (seed 3), padded to
    CAPACITY_FACTOR times the live count."""
    import torch
    from litegs_torch import config
    from litegs_torch.scene import pad_params
    rng = np.random.default_rng(3)
    model = prepared.mapped(torch.clone)
    with torch.no_grad():
        model.sh_0 += torch.from_numpy(rng.normal(
            0.0, SH0_NOISE, tuple(model.sh_0.shape)).astype(np.float32)
        ).to(dev)
    cap = config.round_up(int(active * CAPACITY_FACTOR),
                          config.PipelineParams().cluster_size)
    return pad_params(model, cap)


def phase_lpips(dev, prepared, active: int, batch, sh_degree: int):
    """LPIPS at full width (phase 8): seeded random weights through
    LPIPS_WEIGHTS; a crop on the card against the CPU module in float64;
    ms per full-width pair; score_split over the serving views with the
    perturbed model.  Returns the split's launches [forward, backward,
    window]."""
    import torch
    from litegs_torch import config, evaluation, metrics
    from litegs_torch.ops import lpips
    from litegs_torch.training.trainer import make_eval_render
    path = random_lpips_npz(os.path.join(PAR_DIR, "lpips_vgg.npz"))
    os.environ["LPIPS_WEIGHTS"] = path
    try:
        weights = lpips.load_weights()
        net = lpips.LPIPSVGG(weights, device=dev)
        ref = lpips.LPIPSVGG(weights, device="cpu").double()
        model = perturbed_model(dev, prepared, active)
        img = make_eval_render(config.PipelineParams(), IMG_H, IMG_W,
                               sh_degree)(
            model, active, batch.view[0], batch.proj[0], batch.planes[0],
            batch.center[0])[0]
        gt = batch.images[0]
        h, w = LPIPS_CROP
        crop = (slice(None), slice(IMG_H // 3, IMG_H // 3 + h),
                slice(IMG_W // 3, IMG_W // 3 + w))
        got = float(net(img[crop], gt[crop]))
        want = float(ref(img[crop].cpu(), gt[crop].cpu()))
        rel = abs(got - want) / want
        pair_ms = time_ms(lambda: net(img, gt))
        print(f"lpips crop 3x{h}x{w}: card {got:.8f}, CPU float64 "
              f"{want:.8f}, relative difference {rel:.3e} (bar "
              f"{LPIPS_RTOL:g}); full-width pair 3x{IMG_H}x{IMG_W}: "
              f"{pair_ms:.3f} ms (CUDA events, median of {REPEATS}, TF32 "
              "off inside the module)")
        if not (want > 0 and rel <= LPIPS_RTOL):
            fail(f"LPIPS on the card {got} against the CPU's {want}")
        if metrics.lpips_fn() is None:
            fail("lpips_fn found no weights through LPIPS_WEIGHTS")
        pp = config.PipelineParams()
        zero_path_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluation.score_split(model, active, batch, pp, sh_degree)
        torch.cuda.synchronize()
        split_s = time.perf_counter() - t0
        n_views = int(batch.images.shape[0])
        counts = read_path_counts("score_split with LPIPS", 0, n_views)
        print(f"score_split with LPIPS over {n_views} serving views "
              f"(perturbed model): {json.dumps(res)}; {split_s:.3f} s per "
              "split (host clock, synchronised)")
        if res["lpips"] is None or not np.isfinite(res["lpips"]) or not (
                res["lpips"] > 0):
            fail(f"score_split reported LPIPS {res['lpips']}")
    finally:
        del os.environ["LPIPS_WEIGHTS"]
    return np.asarray(counts)


def clone_state(state):
    """A TrainState with its own copies of the parameters and moments."""
    import torch
    from litegs_torch.training import optimizer
    return state._replace(
        params=state.params.mapped(torch.clone),
        adam=optimizer.AdamState(*[{k: v.clone() for k, v in d.items()}
                                   for d in state.adam]))


def field_diff(got, want) -> float:
    """Largest |got - want| over the parameters and both moments, each
    scaled by the largest |want| of its field."""
    worst = 0.0
    pairs = [(getattr(got.params, k), getattr(want.params, k))
             for k in got.params.fields()]
    for d_got, d_want in zip(got.adam, want.adam):
        pairs += [(d_got[k], d_want[k]) for k in d_got]
    for a, b in pairs:
        scale = float(b.detach().abs().max())
        if scale > 0:
            worst = max(worst, float((a.detach() - b.detach()).abs().max())
                        / scale)
    return worst


def span_ms(prof, name: str, steps: int):
    """(spans, host ms, device ms) per step of the profiler spans named
    ``name``, the device time being that of the kernels launched inside
    them."""
    spans = [e for e in prof.key_averages() if e.key == name]
    return (sum(e.count for e in spans) / steps,
            sum(e.cpu_time_total for e in spans) / steps / 1e3,
            sum(e.device_time_total for e in spans) / steps / 1e3)


def phase_parallel(dev, prepared, active: int, batch, sh_degree: int):
    """Data parallelism at full width (phase 8) on an NCCL group of one
    rank: PAR_STEPS steps of make_parallel_train_step (float32 wire,
    sharded statistics) each held to make_train_step's update from the
    same state; the bf16 wire's losses over the same steps; ms per step
    both ways and the all-reduce's own time from its profiler spans; the
    sharded densify against the replicated one on the run's statistics.
    Returns the launches [forward, backward, window] of the counted
    data-parallel steps."""
    import torch
    import torch.distributed as dist
    from litegs_torch import config, parallel
    from litegs_torch.parallel import densify as pdensify
    from litegs_torch.training import densify, optimizer
    from litegs_torch.training import statistics as tstats
    from litegs_torch.training.trainer import (TrainState, make_train_step,
                                               masked_chunk_aabb)
    store = os.path.join(PAR_DIR, "store")
    os.makedirs(PAR_DIR, exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    world = parallel.initialize_distributed(f"file://{store}", 1, 0,
                                            device=dev)
    backend = dist.get_backend()
    print(f"process group: world {world}, backend {backend}")
    if world != 1 or (dev.type == "cuda" and backend != "nccl"):
        fail(f"expected an NCCL group of one rank, got {backend} x {world}")
    try:
        counts = np.zeros(3, np.int64)
        n_views, _, img_h, img_w = batch.images.shape
        lp = config.ModelParams(sh_degree=sh_degree)
        op = config.OptimizationParams()
        chunk = config.PipelineParams().cluster_size
        params = perturbed_model(dev, prepared, active)
        cap = params.capacity
        caps = config.CapacityParams(primitive_capacity=cap)
        # non-zero moments (tests/test_torch_train.py's): from zero moments
        # an update moves every coordinate by lr sqrt(10) times the sign of
        # its gradient, which a gradient at roundoff level would decide
        adam = optimizer.init_adam(params)
        gen = torch.Generator(device=dev).manual_seed(11)
        for v in adam.exp_avg.values():
            v.normal_(0.0, 1e-4, generator=gen)
        for v in adam.exp_avg_sq.values():
            v.uniform_(1e-8, 1e-6, generator=gen)
        start = TrainState(params, adam, active, 0)
        wire_mb = {w: 59 * cap * b / 1e6 for w, b in (("f32", 4),
                                                      ("bf16", 2))}

        def steps_of(wire):
            pp = config.PipelineParams(grad_allreduce_dtype=wire)
            return (make_train_step(lp, op, pp, caps, img_h, img_w, 1.0,
                                    sh_degree, True),
                    parallel.make_parallel_train_step(
                        lp, op, pp, caps, img_h, img_w, 1.0, sh_degree,
                        True, sharded_stats=True))

        def view(i):
            return [x[i % n_views] for x in (batch.view, batch.proj,
                                               batch.planes, batch.center,
                                               batch.images)]

        # ---- float32 wire: each update against make_train_step's ----
        single, par = steps_of("f32")
        state = clone_state(start)
        stats = pdensify.init_sharded_stats(cap, dev)
        single_stats = tstats.init_stats(cap, dev)
        worst, exact, ms, single_ms, losses_f32 = 0.0, True, [], [], []
        parallel.COLLECTIVE_CALLS.clear()
        for i in range(PAR_STEPS):
            with torch.no_grad():
                origin, extend = masked_chunk_aabb(state.params, active,
                                                   chunk)
            before = clone_state(state)
            zero_path_counts()
            marks = Marks()
            marks.mark("start")
            state, stats, m = par(state, stats, origin, extend, *view(i),
                                  1.0)
            marks.mark("step")
            ms.append(marks.split()[0][1])
            counts += read_path_counts(f"data-parallel step {i}", 1, 0)
            losses_f32.append(float(m["loss"]))
            marks = Marks()
            marks.mark("start")
            want, single_stats, wm = single(before, single_stats, origin,
                                            extend, *view(i))
            marks.mark("step")
            single_ms.append(marks.split()[0][1])
            d = field_diff(state, want)
            exact = exact and d == 0.0 and float(m["loss"]) == float(
                wm["loss"])
            worst = max(worst, d, abs(float(m["loss"]) - float(wm["loss"]))
                        / abs(float(wm["loss"])))
            del before, want
        calls = dict(parallel.COLLECTIVE_CALLS)
        print(f"data-parallel steps (float32 wire, {wire_mb['f32']:.1f} MB "
              f"of gradients per all-reduce): losses "
              f"{np.round(losses_f32, 6).tolist()}; each update against "
              f"make_train_step's from the same state: largest scaled "
              f"difference {worst:.3e} (bar {PAR_TOL:g}), bit-equal in "
              f"every step: {exact}; collectives {calls}")
        if not worst <= PAR_TOL:
            fail(f"the world-1 data-parallel update differs from "
                 f"make_train_step's by {worst}")
        med, med1 = (statistics.median(x[1:]) for x in (ms, single_ms))
        print(f"ms per step (CUDA events, median of {PAR_STEPS - 1} after "
              f"1): data-parallel {med:.3f}, make_train_step {med1:.3f} "
              f"({med - med1:+.3f} ms)")

        # ---- sharded densify on the run's statistics ----
        dp = config.DensifyParams(target_primitives=TARGET_PRIMITIVES,
                                  densify_from=0, densify_until=2,
                                  densification_interval=1,
                                  opacity_reset_interval=100)
        full = pdensify.gather_stats(stats, cap)
        t0 = time.perf_counter()
        got = pdensify.sharded_densify_step(
            state.params, state.adam, stats, active, 1, dp, 2, active, 1.0,
            chunk, generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
        want = densify.densify_step(
            state.params, state.adam, full, active, 1, dp, 2, active, 1.0,
            chunk, generator=torch.Generator().manual_seed(0))
        same = got[2] == want[2] and got[3] == want[3] and all(
            torch.equal(a, b) for a, b in zip(
                [*got[0].fields().values(), *got[1].exp_avg.values(),
                 *got[1].exp_avg_sq.values()],
                [*want[0].fields().values(), *want[1].exp_avg.values(),
                 *want[1].exp_avg_sq.values()]))
        uniform = densify.draw_uniform(cap, torch.Generator().manual_seed(0),
                                       dev)
        keys = densify.taming_sample_keys(densify.get_score(
            state.params, full, torch.arange(cap, device=dev) < active),
            uniform)
        budget = int(got[2] - active) + chunk
        topk_ms = time_ms(lambda: pdensify.sharded_topk_mask(keys, budget))
        print(f"sharded densify (world 1): active {active} -> {got[2]}, "
              f"bit-equal to densify_step: {same}; {sharded_s:.3f} s; "
              f"sharded_topk_mask's 32 bisection rounds over {cap} keys: "
              f"{topk_ms:.3f} ms (CUDA events, median of {REPEATS})")
        if not same or not got[2] > active:
            fail("the sharded densify differs from densify_step or did not "
                 "grow the model")
        del got, want, full, keys

        # ---- bf16 wire: the losses of the same steps ----
        _, par16 = steps_of("bf16")
        state16 = clone_state(start)
        stats16 = pdensify.init_sharded_stats(cap, dev)
        losses_16 = []
        for i in range(PAR_STEPS):
            with torch.no_grad():
                origin, extend = masked_chunk_aabb(state16.params, active,
                                                   chunk)
            zero_path_counts()
            state16, stats16, m = par16(state16, stats16, origin, extend,
                                        *view(i), 1.0)
            counts += read_path_counts(f"bf16-wire step {i}", 1, 0)
            losses_16.append(float(m["loss"]))
        rel = np.abs(np.array(losses_16) - losses_f32) / np.abs(losses_f32)
        print(f"bf16 wire ({wire_mb['bf16']:.1f} MB per all-reduce): losses "
              f"{np.round(losses_16, 6).tolist()}; largest relative "
              f"difference from the float32 wire's {rel.max():.3e} (bar "
              f"{BF16_LOSS_RTOL:g})")
        if not rel.max() <= BF16_LOSS_RTOL:
            fail(f"bf16-wire losses differ from float32's by {rel.max()}")
        del state16, stats16

        # ---- the all-reduce's own time, from its profiler spans ----
        for wire in ("f32", "bf16"):
            _, step = steps_of(wire)
            box = [clone_state(start), pdensify.init_sharded_stats(cap, dev)]

            def run():
                for i in range(PAR_STEPS, PAR_STEPS + PAR_PROFILE_STEPS):
                    with torch.no_grad():
                        o, e = masked_chunk_aabb(box[0].params, active,
                                                 chunk)
                    box[0], box[1], _ = step(box[0], box[1], o, e,
                                             *view(i), 1.0)

            run()                                  # warm-up
            zero_path_counts()
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / PAR_PROFILE_STEPS
            counts += read_path_counts(f"profiled {wire} steps",
                                       PAR_PROFILE_STEPS, 0)
            n_spans, host, device = span_ms(prof, "collective:all_reduce",
                                            PAR_PROFILE_STEPS)
            nccl = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and "nccl" in e.key.lower()) / PAR_PROFILE_STEPS / 1e3
            print(f"profiled {PAR_PROFILE_STEPS} data-parallel steps, "
                  f"{wire} wire: wall {wall:.3f} ms/step; the "
                  f"'collective:all_reduce' spans ({n_spans:g} a step) "
                  f"{host:.3f} ms "
                  f"host, {device:.3f} ms of device kernels per step; NCCL "
                  f"kernels {nccl:.3f} ms per step (one rank: no transfer)")
            del box
        return counts
    finally:
        dist.destroy_process_group()


def phase_parallel_cli(run_b1: dict):
    """torchrun with one process: example_train --parallel on, on phase
    6's COLMAP scene at phase 6's depth; its test PSNR against phase 6's
    Trainer run, its finish ply from rank 0."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    model = os.path.join(COLMAP_DIR, "model_parallel")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", "1", "--master_addr", "127.0.0.1",
           "--master_port", str(port), "-m", "litegs_torch.example_train",
           *run_b1["argv"], "-m", model, "--parallel", "on"]
    t0 = time.perf_counter()
    # a session of its own, so that a timeout stops torchrun's worker too
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail("torchrun example_train --parallel on took over 600 s")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"torchrun example_train --parallel on exited "
             f"{proc.returncode}:\n{stdout[-3000:]}\n{stderr[-3000:]}")
    test, took = {}, None
    for line in stdout.splitlines():
        if "] test PSNR " in line:
            epoch = int(line.split("]")[0].lstrip("[epoch "))
            test[epoch] = float(line.rsplit(" ", 1)[1])
        elif line.startswith("takes: "):       # takes: 6.3s (64 iterations)
            secs, iters = line[7:].split("s (")
            took = int(iters.split()[0]) / float(secs)
    want = dict(zip((3, 7), run_b1["test_psnr"]))
    ply = os.path.join(model, "point_cloud", "finish", "point_cloud.ply")
    using = [ln for ln in stdout.splitlines()
             if ln.startswith("using ParallelTrainer")]
    steps = len(run_b1["epoch_s"]) * (COLMAP_VIEWS - 2)   # 8 train views
    print(f"torchrun --nproc_per_node 1 example_train --parallel on: "
          f"{wall:.1f} s wall (process start and kernel load included); "
          f"{using}; {took or float('nan'):.2f} it/s over start's loop "
          f"(host clock, seconds to one decimal) against phase 6's "
          f"Trainer's {steps / sum(run_b1['epoch_s']):.2f}; test PSNR "
          f"{test} against phase 6's Trainer {want} "
          f"(bar {CLI_PSNR_TOL} dB); finish ply from rank 0: "
          f"{os.path.exists(ply)}")
    if not using or set(test) != set(want) or not os.path.exists(ply):
        fail(f"torchrun run incomplete:\n{stdout[-3000:]}")
    if not all(abs(test[e] - want[e]) <= CLI_PSNR_TOL for e in want):
        fail(f"torchrun test PSNR {test} against the Trainer's {want}")


def root_bench_keys() -> dict:
    """{metric: keys in order} of the dicts the root bench.py passes to
    json.dumps, read from its source (it is not imported: it imports
    JAX)."""
    with open(ROOT_BENCH) as f:
        tree = ast.parse(f.read())
    assigned = {node.targets[0].id: node.value for node in ast.walk(tree)
                if isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Dict)
                and isinstance(node.targets[0], ast.Name)}
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and ast.unparse(node.func) == "json.dumps"):
            d = node.args[0]
            if isinstance(d, ast.Name):
                d = assigned[d.id]
            keys = [k.value for k in d.keys]
            out[d.values[keys.index("metric")].value] = keys
    return out


@contextlib.contextmanager
def bench_env(env: dict):
    """The process environment with every BENCH_* knob unset but ``env``;
    restored on exit."""
    saved = {k: v for k, v in os.environ.items() if k.startswith("BENCH_")}
    for k in saved:
        del os.environ[k]
    os.environ.update(env)
    try:
        yield
    finally:
        for k in [k for k in os.environ if k.startswith("BENCH_")]:
            del os.environ[k]
        os.environ.update(saved)


def phase_bench(dev):
    """Phase 9: python -m litegs_torch.bench's main in process at its
    defaults in each of BENCH_MODES; each run's stdout is one JSON line
    with the root bench.py's keys and a finite positive value, and its
    kernel launches are counted against the run's steps and renders.
    Returns the launches (forward, backward, window) and the lines."""
    from litegs_torch import bench
    keys = root_bench_keys()
    warm = 1 + BENCH_FRAMES        # frame 0, then every frame once
    batched = 1 + BENCH_FRAMES // 2 + BENCH_ITERS   # B = 2 steps
    expected = {   # forwards, backwards, views binned
        "train": (warm + BENCH_ITERS,) * 3,
        "render": (warm + 1 + BENCH_ITERS, warm, warm + 1 + BENCH_ITERS),
        "B=2": (warm + batched, warm + batched, warm + 2 * batched)}
    launches = np.zeros(3, np.int64)
    lines = {}
    for label, env, metric in BENCH_MODES:
        out, err = io.StringIO(), io.StringIO()
        zero_path_counts()
        t0 = time.perf_counter()
        with bench_env(env), contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            bench.main(device=dev)
        wall = time.perf_counter() - t0
        launches += read_counts(f"bench {label}", *expected[label])
        printed = out.getvalue().splitlines()
        print(f"bench {label} ({wall:.1f} s wall, set-up included): "
              f"stdout {printed}")
        for line in err.getvalue().splitlines():
            print(f"  {line}")
        if len(printed) != 1:
            fail(f"bench {label} printed {len(printed)} stdout lines")
        rec = json.loads(printed[0])
        if list(rec) != keys[metric] or rec["metric"] != metric:
            fail(f"bench {label}: keys {list(rec)}, bench.py's "
                 f"{keys[metric]}")
        if not (math.isfinite(rec["value"]) and rec["value"] > 0):
            fail(f"bench {label}: value {rec['value']}")
        lines[label] = printed[0]
    return launches, lines


def drop_flags(argv: list, flags) -> list:
    """argv without each of ``flags`` and its value."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in flags:
            skip = True
        else:
            out.append(a)
    return out


def phase_challenge(dev, run_b1: dict):
    """Phase 10: challenge_train at its 5,000 iterations on phase 6's
    COLMAP scene with phase 6's other flags, then challenge_eval on its
    model; the output JSON's keys, the train time, the test PSNR against
    phase 6's last, and the launches (forward, backward, window)."""
    from litegs_torch import challenge_eval, challenge_train
    model = os.path.join(COLMAP_DIR, "model_challenge")
    timing = os.path.join(model, "train_time.json")
    result_json = os.path.join(model, "challenge.json")
    argv = drop_flags(run_b1["argv"], ("--iterations", "--test_epochs"))
    scene = argv[argv.index("-s") + 1]
    n_train = COLMAP_VIEWS - 2
    launches = np.zeros(3, np.int64)
    zero_path_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        challenge_train.main(argv + ["-m", model, "--timing_json", timing],
                             device=dev)
    wall = time.perf_counter() - t0
    steps = CHALLENGE_ITERS // n_train * n_train
    launches += read_path_counts("challenge train", steps, 0)
    printed = out.getvalue().splitlines()
    print(f"challenge train: {wall:.1f} s wall, {len(printed)} lines; "
          f"first and last: {printed[:1] + printed[-3:]}")
    zero_path_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = challenge_eval.main(["-s", scene, "-m", model, "--timing_json",
                                   timing, "--output_json", result_json],
                                  device=dev)
    eval_s = time.perf_counter() - t0
    launches += read_path_counts("challenge eval", 0, 2)
    with open(result_json) as f:
        saved = json.load(f)
    want = run_b1["test_psnr"][-1]
    print(f"challenge eval: {eval_s:.1f} s; {json.dumps(saved)}; "
          f"{steps / saved.get('train_time_s', math.nan):.2f} it/s over "
          f"the challenge's wall time (load and export included); test "
          f"PSNR against phase 6's {want:.3f} after "
          f"{COLMAP_EPOCHS * n_train} steps: "
          f"{saved.get('psnr', math.nan) - want:+.3f} dB")
    if saved != res or list(saved) != ["train_time_s", "scene", "ssim",
                                       "psnr"]:
        fail(f"challenge eval wrote {saved}, returned {res}")
    if not saved["train_time_s"] > 0 or saved["scene"] != scene:
        fail(f"challenge train's record {saved}")
    if not saved["psnr"] >= want - CHALLENGE_PSNR_TOL:
        fail(f"challenge test PSNR {saved['psnr']} more than "
             f"{CHALLENGE_PSNR_TOL} dB below phase 6's {want}")
    return launches


def flag_value(argv: list, flag: str):
    return argv[argv.index(flag) + 1]


def phase_convergence(dev):
    """Phase 11a: synthetic_convergence's main in process with
    CONVERGENCE_r5.md's command at the bench's size, cut to CONV_ITERS
    iterations; the trajectory, it/s and peak memory; the final active
    count, the PSNR gain and finite losses against their bars; the
    launches (forward, backward, window), make_task's ground-truth renders
    included."""
    import torch
    from litegs_torch import synthetic_convergence
    argv = CONV_ARGV + ["--height", str(IMG_H), "--width", str(IMG_W),
                        "--iters", str(CONV_ITERS)]
    frames = int(flag_value(argv, "--frames"))
    target = int(flag_value(argv, "--target"))
    steps = CONV_ITERS // frames * frames
    print(f"convergence: CONVERGENCE_r5.md's command cut: {IMG_H}x{IMG_W} "
          f"(the bench's size) instead of {CONV_R5_HW[0]}x{CONV_R5_HW[1]}, "
          f"{CONV_ITERS} iterations instead of {CONV_R5_ITERS}; argv {argv}")
    zero_path_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        hist = synthetic_convergence.main(argv, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = np.array(read_counts("convergence", frames + steps, steps,
                                    frames + steps), np.int64)
    for line in out.getvalue().splitlines():
        print(f"  {line}")
    print("convergence trajectory (epoch, train PSNR dB, active, wall s "
          "since training began):")
    for h in hist:
        if h["epoch"] % 10 == 0 or h is hist[-1]:
            print(f"  {h['epoch']} {h['psnr']} {h['active']} "
                  f"{h['seconds']}")
    train_s = hist[-1]["seconds"]
    summary = {"wall_s": wall, "train_s": train_s,
               "its": steps / train_s, "peak_gib": peak,
               "psnr0": hist[0]["psnr"], "psnr": hist[-1]["psnr"],
               "active0": hist[0]["active"], "active": hist[-1]["active"]}
    print(f"convergence: {steps} steps in {train_s} s of training = "
          f"{summary['its']} it/s ({wall} s wall, scene build included); "
          f"peak memory {peak} GiB; active {hist[0]['active']} after epoch "
          f"0 -> {hist[-1]['active']} ({hist[-1]['active'] / target} of "
          f"{target}); train PSNR {hist[0]['psnr']} -> {hist[-1]['psnr']}")
    if not all(math.isfinite(h["loss"]) for h in hist):
        fail(f"convergence: a loss is not finite: {hist}")
    if not hist[-1]["active"] >= CONV_ACTIVE_SHARE * target:
        fail(f"convergence: {hist[-1]['active']} active, below "
             f"{CONV_ACTIVE_SHARE} of {target}")
    if not hist[-1]["psnr"] >= hist[0]["psnr"] + CONV_PSNR_GAIN:
        fail(f"convergence: train PSNR {hist[-1]['psnr']} not "
             f"{CONV_PSNR_GAIN} dB above epoch 0's {hist[0]['psnr']}")
    return launches, summary


@contextlib.contextmanager
def child_output(path: str, seconds: int):
    """Standard output and error, the children's included, written to
    ``path``; SIGALRM after ``seconds`` stops the wait (subprocess.run
    kills its child on the way out)."""
    def late(*_):
        raise TimeoutError(f"over {seconds} s")

    sys.stdout.flush()
    sys.stderr.flush()
    saved = os.dup(1), os.dup(2)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
        os.dup2(f.fileno(), 2)
    old = signal.signal(signal.SIGALRM, late)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        sys.stdout.flush()
        sys.stderr.flush()
        for fd, copy in zip((1, 2), saved):
            os.dup2(copy, fd)
            os.close(copy)


def run_ablation(label: str, module, argv: list, dev) -> dict:
    """``module.main(argv)`` with its children's output kept; returns
    {variant: {code, active, test_psnr, log}}, the last two read from
    start's lines ([epoch E] ... active=N, [epoch E] test PSNR x)."""
    log = os.path.join(COLMAP_DIR, f"{label}.log")
    t0 = time.perf_counter()
    try:
        with child_output(log, CHILD_TIMEOUT * len(module.VARIANTS)):
            codes = module.main(argv, device=dev)
    except TimeoutError as e:
        fail(f"{label}: {e}")
    wall = time.perf_counter() - t0
    with open(log) as f:
        text = f.read()
    out = {}
    parts = text.split("=== ")[1:]
    for part in parts:
        name, body = part.split(" ===\n", 1)
        active = [int(m) for m in re.findall(
            r"\] loss=\S+ psnr=\S+ active=(\d+)", body)]
        test = [float(m) for m in re.findall(r"\] test PSNR (\S+)", body)]
        out[name] = {"code": codes.get(name), "active": active,
                     "test_psnr": test, "log": body}
        print(f"{label} {name}: exit {codes.get(name)}, active per epoch "
              f"{active}, test PSNR {test}")
    print(f"{label}: {wall:.1f} s wall (process starts and kernel loads "
          f"included); children's output in {log}")
    if list(out) != list(module.VARIANTS) or any(
            r["code"] != 0 for r in out.values()):
        fail(f"{label}: exit codes {codes}:\n{text[-4000:]}")
    return out


def phase_ablations(dev, run_b1: dict):
    """Phase 11b-c: ablations_densify on phase 6's COLMAP scene at phase
    6's iterations and densify window (each variant its own interval),
    test PSNR at epochs 3 and 7; ablations_culling on the same scene at
    CULLING_ITERS iterations (no variant densifies), test PSNR at the last
    epoch.  The variants train in child processes, so they are checked by
    exit codes and their printed lines, not by launch counts."""
    import torch
    from litegs_torch import ablations_culling, ablations_densify
    torch.cuda.empty_cache()        # the card's memory to the children
    argv = drop_flags(run_b1["argv"], ("--densification_interval",))
    dens = run_ablation("ablations_densify", ablations_densify, argv + [
        "-m", os.path.join(COLMAP_DIR, "ablation_densify")], dev)
    print(f"densify ablation: test PSNR tamings "
          f"{dens['tamings']['test_psnr']}, official_adc "
          f"{dens['official_adc']['test_psnr']}; final primitives "
          f"{dens['tamings']['active'][-1:]} / "
          f"{dens['official_adc']['active'][-1:]}")
    if len(set(dens["official_adc"]["active"])) < 2 or len(
            dens["official_adc"]["test_psnr"]) != 2:
        fail(f"densify ablation: official_adc did not densify or test: "
             f"{dens['official_adc']['log'][-3000:]}")
    scene = flag_value(run_b1["argv"], "-s")
    last = CULLING_ITERS // (COLMAP_VIEWS - 2) - 1
    cull = run_ablation("ablations_culling", ablations_culling, [
        "-s", scene, "-m", os.path.join(COLMAP_DIR, "ablation_culling"),
        "--iterations", str(CULLING_ITERS), "--sh_degree", str(SH_DEGREE),
        "--test_epochs", str(last)], dev)
    psnr = {k: (v["test_psnr"] or [math.nan])[-1] for k, v in cull.items()}
    gap = psnr["script_raster"] - psnr["clustered"]
    print(f"culling ablation: test PSNR {psnr}; script_raster - clustered "
          f"{gap:+.3f} dB (bar {SCRIPT_RASTER_TOL}); no_culling - clustered "
          f"{psnr['no_culling'] - psnr['clustered']:+.3f} dB (not barred)")
    if not abs(gap) <= SCRIPT_RASTER_TOL:
        fail(f"culling ablation: script_raster's test PSNR "
             f"{psnr['script_raster']} against clustered's "
             f"{psnr['clustered']}")
    return {"densify": {k: (v["test_psnr"], v["active"][-1:])
                        for k, v in dens.items()}, "culling": psnr}


def phase_convergence_parallel():
    """Phase 11d: torchrun --nproc_per_node 1 python -m
    litegs_torch.convergence_parallel at PAR_CONV_ITERS iterations, its
    table written under build/; at D = 1 the arms coincide, so this shows
    only that the entry point runs on the card: exit 0 and four rows."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    table = os.path.join(COLMAP_DIR, "convergence_parallel.md")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", "1", "--master_addr", "127.0.0.1",
           "--master_port", str(port), "-m",
           "litegs_torch.convergence_parallel", "--output", table]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True,
                            env={**os.environ,
                                 "CONV_ITERS": str(PAR_CONV_ITERS)},
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        stdout, stderr = proc.communicate(timeout=CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"torchrun convergence_parallel took over {CHILD_TIMEOUT} s")
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.exists(table):
        fail(f"torchrun convergence_parallel exited {proc.returncode}:\n"
             f"{stdout[-3000:]}\n{stderr[-3000:]}")
    with open(table) as f:
        rows = re.findall(r"^\| (sequential|parallel_\w+) \|.*$", f.read(),
                          re.M)
    print(f"torchrun --nproc_per_node 1 convergence_parallel "
          f"(CONV_ITERS={PAR_CONV_ITERS}): {wall:.1f} s wall; "
          f"{stdout.strip().splitlines()}")
    if rows != ["sequential", "parallel_equal_images_lr1",
                "parallel_equal_images_lrsqrtD",
                "parallel_equal_updates_lr1"]:
        fail(f"convergence_parallel's table has rows {rows}")


def main() -> int:
    import torch
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from litegs_torch import config, evaluation
    from litegs_torch.ops import _kernels
    t0 = time.perf_counter()
    built = _kernels.build_all()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    worst_fwd, worst_bwd = phase_kernels(dev)
    worst_sg = phase_stream_kernels(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = make_scene(dev, N_POINTS, SH_DEGREE)
    prepared, active = evaluation.prepare_model(model, config.PipelineParams())
    del model
    torch.cuda.synchronize()
    print(f"scene: {prepared.capacity} gaussians (SH {SH_DEGREE}), "
          f"{N_VIEWS} views {IMG_H}x{IMG_W}, set-up "
          f"{time.perf_counter() - t0:.1f} s")
    fwd, batch, win_serving = phase_serving(dev, prepared, active, IMG_H,
                                            IMG_W, N_VIEWS, SH_DEGREE)
    t0 = time.perf_counter()
    sg_launches, sg_records = phase_stream_routes(
        dev, "serving scene", prepared, active, batch, SH_DEGREE, timed=True)
    keys_record = phase_binning_keys(dev)
    print(f"binning routes phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fwd_launches, bwd, win_training, sg_trained = phase_training(
        dev, prepared, active, batch, SH_DEGREE)
    print(f"training phase {time.perf_counter() - t0:.1f} s")
    phase_trainer(dev)
    t0 = time.perf_counter()
    colmap, run_b1 = phase_colmap(dev, prepared, active)
    phase_pose_step(dev)
    print(f"colmap phase {time.perf_counter() - t0:.1f} s; launches on its "
          f"path {colmap}")
    t0 = time.perf_counter()
    batched, worst_batched = phase_batched(dev, prepared, active, batch,
                                           SH_DEGREE)
    batched += phase_batch_cli(dev, run_b1)
    print(f"batched phase {time.perf_counter() - t0:.1f} s; launches on its "
          f"path {batched.tolist()}")
    t0 = time.perf_counter()
    par = phase_lpips(dev, prepared, active, batch, SH_DEGREE)
    par += phase_parallel(dev, prepared, active, batch, SH_DEGREE)
    phase_parallel_cli(run_b1)
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    print(f"evaluation and data-parallel phase {time.perf_counter() - t0:.1f}"
          f" s; launches on its path {par.tolist()}")
    t0 = time.perf_counter()
    entry, bench_lines = phase_bench(dev)
    entry += phase_challenge(dev, run_b1)
    print(f"bench and challenge phases {time.perf_counter() - t0:.1f} s; "
          f"launches on their path {entry.tolist()}")
    t0 = time.perf_counter()
    conv, conv_summary = phase_convergence(dev)
    t1 = time.perf_counter()
    ablations = phase_ablations(dev, run_b1)
    t2 = time.perf_counter()
    phase_convergence_parallel()
    shutil.rmtree(COLMAP_DIR, ignore_errors=True)
    print(f"convergence and ablation phase {time.perf_counter() - t0:.1f} s "
          f"(11a {t1 - t0:.1f}, 11b-c {t2 - t1:.1f}, 11d "
          f"{time.perf_counter() - t2:.1f}); launches on its in-process "
          f"path {conv.tolist()}")
    path = entry + conv
    fwd_launches += (colmap["raster_forward"] + int(batched[0]) + int(par[0])
                     + int(path[0]))
    bwd["launches"] += (colmap["raster_backward"] + int(batched[1])
                        + int(par[1]) + int(path[1]))
    win_training += (colmap["bin_count_kernel"] + int(batched[2])
                     + int(par[2]) + int(path[2]))
    fwd["launches"] = fwd_launches
    # the merged forward is bit-equal to the single views' (checked)
    fwd["max_abs_err"] = max(fwd["max_abs_err"], worst_fwd)
    bwd["max_abs_err"] = max(bwd["max_abs_err"], worst_bwd, worst_batched)
    # launches: each 'keys' kernel's on the serving and training paths
    # (the default route), beside the views they binned; the stream_gather
    # kernels in the route phases, whose tables and aligned copies are
    # their own path
    for kernel, rec in sg_records.items():
        rec["launches"] = sg_launches[kernel] + sg_trained[kernel]
        rec["max_abs_err"] = max(rec["max_abs_err"], worst_sg[kernel])
    keys_record["launches"] = dict(KEYS_PATH_LAUNCHES)
    keys_record["views_binned"] = win_serving + win_training
    for rec in (fwd, bwd, keys_record, *sg_records.values()):
        n = rec["launches"]
        if not (min(n.values(), default=0) if isinstance(n, dict)
                else n) > 0:
            fail(f"{rec['name']} was never launched on its path")
    torch.cuda.synchronize()
    print(json.dumps({"kernels": [fwd, bwd, *(
        sg_records[k] for k in SG_RECORDS), keys_record]}))
    card = card_line()
    for label, line in bench_lines.items():
        print(f"bench {label} on {card}: {line}")
    print(f"convergence on {card}: {json.dumps(conv_summary)}; ablations "
          f"{json.dumps(ablations)}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
