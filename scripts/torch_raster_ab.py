"""Time one checkout's raster kernels on round and on elongated splats, on
one CUDA card.

    python3 scripts/torch_raster_ab.py [--repo DIR] [--seed N]

Imports ``litegs_torch`` from DIR (default: this checkout), so that two
checkouts -- a parent commit unpacked into a gitignored directory, and the
tree -- are timed on the same scenes: run the script once per checkout in
one session, in the order parent, tree, tree, parent, and compare only
within that session.  The scenes are chip_smoke.py's serving scene
(1,000,000 gaussians, SH 3, 840x1296, 8x16 tiles, view 0) and the same
cloud with every splat stretched: log-scales +s and -s on two axes, so an
aspect ratio of e^(2s) at the same volume, turned by a random rotation
from ``--seed``.  A bounding-box cull is loosest on long splats at a
slant.  Prints per scene: the table's entries; the forward's pair counts
(walked; evaluated and contributing where the checkout's kernel counts
them); the forward kernel's time and the backward's, with and without
statistics, under a seeded cotangent (CUDA events, median of 5 after a
warm-up); both kernels held to their plain versions on sampled tiles at
chip_smoke.py's bars.
"""
from __future__ import annotations

import argparse
import inspect
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

# aspect ratios of the stretched scenes (1: chip_smoke.py's scene)
ASPECTS = (1, 4, 16)


def stretch(model, aspect: float, seed: int):
    """Stretch every splat of model to the given aspect ratio at the same
    volume, each turned by a random unit quaternion."""
    import torch
    if aspect == 1:
        return
    s = 0.5 * math.log(aspect)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=tuple(model.rot.shape)).astype(np.float32)
    q /= np.linalg.norm(q, axis=0, keepdims=True)
    with torch.no_grad():
        model.scale[0] += s
        model.scale[1] -= s
        model.rot.copy_(torch.from_numpy(q))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=ROOT,
                    help="checkout whose litegs_torch is timed")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch

    from litegs_torch import config, evaluation
    from litegs_torch.data import synthetic
    from litegs_torch.ops import raster_cuda
    from litegs_torch.render import render, render_preprocess
    from litegs_torch.training.trainer import (camera_batch_from_frames,
                                               masked_chunk_aabb)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke.card_line()}")
    print(f"litegs_torch from {os.path.dirname(raster_cuda.__file__)}")
    dev = torch.device("cuda")
    h, w, sh = chip_smoke.IMG_H, chip_smoke.IMG_W, chip_smoke.SH_DEGREE
    pp = config.PipelineParams()
    tile_h, tile_w = pp.tile_size
    cam, frames = synthetic.make_cameras(1, h, w, seed=0)
    batch = camera_batch_from_frames(
        cam, frames, np.zeros((1, 3, h, w), np.float32), device=dev)
    counted = [name for name in ("walked", "evaluated", "contributing")
               if name in inspect.signature(
                   raster_cuda.raster_forward).parameters]
    for aspect in ASPECTS:
        model = chip_smoke.make_scene(dev, chip_smoke.N_POINTS, sh)
        stretch(model, aspect, args.seed)
        params, active = evaluation.prepare_model(model, pp)
        del model
        with torch.no_grad():
            origin, extend = masked_chunk_aabb(params, active,
                                               pp.cluster_size)
            culled = render_preprocess(params, origin, extend,
                                       batch.planes[0], batch.center[0], sh,
                                       pp)
            view = render(culled, batch.view[0], batch.proj[0], h, w, pp)
        aux, table = view.aux, view.aux.table
        kargs = (aux.mean_pix.contiguous(), aux.inv_cov.contiguous(),
                 aux.color_chan.contiguous(), aux.opacity.contiguous(),
                 table.sorted_point, table.tile_start, table.tile_count,
                 -(-w // tile_w), tile_h, tile_w)
        counts = torch.zeros((len(counted), table.tile_count.numel(),
                              tile_h * tile_w), dtype=torch.int32,
                             device=dev)
        col, trans = raster_cuda.raster_forward(
            *kargs, **dict(zip(counted, counts)), table_checked=True)
        pairs = dict(zip(counted, counts.sum((1, 2), dtype=torch.int64)
                         .tolist()))
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        cot = (1e-3 * torch.randn(col.shape, generator=gen, device=dev),
               torch.zeros_like(trans))
        fwd_ms = chip_smoke.time_ms(lambda: raster_cuda.raster_forward(
            *kargs, table_checked=True))
        bwd_ms = [chip_smoke.time_ms(lambda: raster_cuda.raster_backward(
            *kargs, col, trans, *cot, with_stats=stats, table_checked=True))
            for stats in (False, True)]
        sub, n_pick = chip_smoke.sample_tiles(table.tile_count, args.seed)
        sargs = kargs[:6] + (sub,) + kargs[7:]
        d_fwd = max(chip_smoke.max_diff(a, b) for a, b in zip(
            raster_cuda.raster_forward(*sargs),
            raster_cuda.raster_forward_plain(*sargs)))
        if not d_fwd <= chip_smoke.TOL:
            chip_smoke.fail(f"aspect {aspect}: forward max|diff| {d_fwd}")
        d_bwd, flips = chip_smoke.check_backward(
            raster_cuda.raster_backward(*sargs, col, trans, *cot,
                                        with_stats=True),
            raster_cuda.raster_backward_plain(*sargs, col, trans, *cot,
                                              with_stats=True),
            f"aspect {aspect}", flip_rate=chip_smoke.STOP_FLIP_RATE)
        print(f"aspect {aspect}: entries={table.num_entries} "
              f"max_tile={int(table.tile_count.max())} "
              + " ".join(f"pairs_{k}={v}" for k, v in pairs.items())
              + f" forward_ms={fwd_ms:.4f} backward_ms={bwd_ms[0]:.4f} "
              f"backward_stats_ms={bwd_ms[1]:.4f} sample_tiles={n_pick} "
              f"max|diff| fwd={d_fwd:.3e} bwd={d_bwd:.3e} "
              f"frag_count_flips={flips:.0f}")
        del params, culled, view, aux, table, kargs, counts
        torch.cuda.empty_cache()
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
