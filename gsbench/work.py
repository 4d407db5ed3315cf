"""The work a view needs, counted from its inputs, and the chip's peaks.

The counts are the benchmark's own: they come from the reference's table
and blend of the same parameters and camera (``reference.render`` with
``counts``), never from the program's kernels, so a change to a kernel
cannot change its own yardstick.  Each constant counts FP32 operations
(a multiply, an add, a compare, an exp, a log, a square root, a division
each count one) of the plain formulation, whatever a kernel does to get
there.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# forward, per contributing (entry, pixel) pair: dx, dy (2); the quadratic
# a dx^2 + 2 b dx dy + c dy^2 (8); -1/2, exp, times opacity (3); the
# 1/256 test and the 255/256 clamp (2); the weight alpha T (1); three
# channels accumulated (6); the transmittance update T (1 - alpha) (2)
OPS_PAIR_FWD = 24
# backward, per contributing pair: alpha recomputed (13); clamp and tests
# (2); weight (1); c . dC over three channels (5); the suffix term and
# d_alpha (6); straight-through dpw (1); d_color (3); d_mean (8);
# d_inv_cov (7); d_opacity (1); the transmittance walked back (3); one
# add per reduced column (2 + 3 + 3 + 1)
OPS_PAIR_BWD = 59
# per entry a tile takes up to its last pixel's stop: the box test of the
# entry's ellipse against the tile (shrink, determinant, level, two radii,
# four compares)
OPS_ENTRY_CULL = 20
# per visible primitive: activation (exp 3, sigmoid 1, quaternion
# normalise 12); SH degree 3 (basis 30, 16 bands x 3 channels x 2 = 96,
# clamp 3); projection (two 4x4 transforms 56, NDC 4, Jacobian 14, the
# rotation-scale matrix 30, T 12, T M 30, cov2d 17, inverse 8, pixel 6)
OPS_POINT_FWD = 16 + 129 + 177
# their vector-Jacobian products: twice the forward's operations
OPS_POINT_BWD = 2 * OPS_POINT_FWD
# Adam per parameter element of a visible chunk: m (3), v (4), sqrt, eps,
# divide, lr (4), the update (1)
OPS_ADAM = 12
PARAMS_PER_POINT = {0: 14, 1: 23, 2: 38, 3: 59}
# per pixel, both ways: for each of three channels L1 (3), SSIM's five
# separable 11-tap blurs (5 x 2 x 11 x 2 = 220) and its map (18), and
# the backward twice that
OPS_PIXEL_LOSS = 3 * 3 * (3 + 220 + 18)


def point_bytes(channels: int = 3) -> int:
    """Per point the rasterizer reads mean (2), inverse covariance (3),
    colour and opacity (channels + 1), 4 bytes each."""
    return 4 * (5 + channels + 1)


def _needed_input_bytes(w: dict, channels: int) -> int:
    """What a view's blend needs to read: the entries up to each tile's
    last stop (a point id each), the attributes of the points they name,
    each tile's run (start, count)."""
    return (w["points_to_stop"] * point_bytes(channels)
            + 4 * w["entries_to_stop"] + 8 * w["tiles"])


def raster_fwd(w: dict, channels: int = 3):
    """(FP32 operations, bytes) of one forward launch over a view: its
    contributing pairs and entries to the stop; the needed inputs read
    once, the tile-layout colour and transmittance written once."""
    ops = OPS_PAIR_FWD * w["pairs"] + OPS_ENTRY_CULL * w["entries_to_stop"]
    nbytes = (_needed_input_bytes(w, channels)
              + 4 * (channels + 1) * w["tile_pixels"])
    return ops, nbytes


def raster_bwd(w: dict, channels: int = 3):
    """(FP32 operations, bytes) of one backward launch: the needed inputs,
    the forward's outputs and their cotangents read once, the gradients
    of every visible point (2 + 3 + channels + 1 columns) written once."""
    ops = OPS_PAIR_BWD * w["pairs"] + OPS_ENTRY_CULL * w["entries_to_stop"]
    nbytes = (_needed_input_bytes(w, channels)
              + 8 * (channels + 1) * w["tile_pixels"]
              + 4 * (6 + channels) * w["points"])
    return ops, nbytes


def bound_s(ops: float, nbytes: float) -> float:
    """Least time the chip could take: operations at the FP32 peak or
    bytes at the HBM peak, whichever is longer."""
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)


def train_step_ops(w: dict, sh_degree: int = 3) -> float:
    """FP32 operations one training view needs: the visible points'
    forward and backward chains and Adam over their parameters, both
    raster launches, and the loss both ways at every pixel."""
    p = w["points"]
    return (p * (OPS_POINT_FWD + OPS_POINT_BWD
                 + OPS_ADAM * PARAMS_PER_POINT[sh_degree])
            + raster_fwd(w)[0] + raster_bwd(w)[0]
            + OPS_PIXEL_LOSS * w["pixels"])


def render_ops(w: dict) -> float:
    """FP32 operations one rendered view needs: the visible points'
    forward chain and the forward raster launch."""
    return w["points"] * OPS_POINT_FWD + raster_fwd(w)[0]


def view_work(vis_points: int, table, counts: tuple, tile_pixels: int,
              pixels: int) -> dict:
    return {"points": vis_points, "entries": int(table.point.numel()),
            "tiles": int(table.tile_count.numel()),
            "tile_pixels": tile_pixels, "pixels": pixels,
            "pairs": counts[0], "entries_to_stop": counts[1],
            "points_to_stop": counts[2]}


def count_view(raw: dict, active: int, cam: dict, sh_degree: int,
               img_h: int, img_w: int, tile: tuple, chunk: int,
               max_pairs: int) -> dict:
    """The work of one view of the parameters ``raw``, by the reference's
    table and blend."""
    import torch

    from .reference import render as R
    tile_h, tile_w = tile
    with torch.no_grad():
        vis = R.preprocess(raw, active, cam, sh_degree, chunk)
        proj = R.project(vis, cam, img_h, img_w)
        table = R.bin_tiles(proj, vis.opacity, img_h, img_w, tile_h, tile_w)
        _, _, counts = R.render_view(vis, proj, table, img_h, img_w, tile_h,
                                     tile_w, max_pairs, counts=True)
    ntiles = int(table.tile_count.numel())
    return view_work(int(vis.opacity.numel()), table, counts,
                     ntiles * tile_h * tile_w, img_h * img_w)
