"""Differentiable rasterize: one entry point over the CUDA kernels and the
plain PyTorch version (``litegs_tpu/ops/raster.py``).

``backend='cuda'`` runs a ``torch.autograd.Function`` whose forward is
``raster_cuda.raster_forward`` and whose backward is
``raster_cuda.raster_backward``: the hand-written kernels on CUDA tensors,
their plain versions on CPU tensors.  ``backend='torch'`` is autograd
through ``raster_plain.rasterize_reference`` on either device (the oracle),
checkpointed by groups of whole tiles on large tables
(:func:`rasterize_plain`).

Densification statistics ride the same backward-kernel run as the
parameter gradients: pass ``stats_sink=zero_stats_sink(M)`` and the sink's
gradient *is* the :class:`RasterStats`, as the reference accumulates them
inside its backward (raster.cu:289-301, 779-820).  :func:`raster_stats` is
the explicit pass for the ``'torch'`` backend.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..utils import profiling, resolve_device
from . import raster_cuda, raster_plain
from .binning import BinningResult


# (entry, pixel) pairs of a table above which the 'torch' backend
# rasterizes groups of whole tiles of at most this many pairs, each under
# checkpointing (rasterize_plain)
PLAIN_GROUP_PAIRS = 1 << 25


class RasterStats(NamedTuple):
    weight_sum: torch.Tensor      # [M] sum of blend weights
    frag_count: torch.Tensor      # [M] contributing (entry, pixel) pairs
    err_sum: torch.Tensor         # [M] sum of per-fragment d_opacity
    err_square_sum: torch.Tensor  # [M] sum of squared per-fragment d_opacity
    grad_norm: torch.Tensor       # [M] ||d mean2d||_ndc this iteration


def zero_stats_sink(m: int, device="cuda") -> RasterStats:
    """Zero leaf tensors to pass as ``stats_sink`` to :func:`rasterize`;
    after the loss's backward their ``.grad`` are the statistics."""
    dev = resolve_device(device)
    return RasterStats(*[torch.zeros(m, device=dev, requires_grad=True)
                         for _ in RasterStats._fields])


def _grad_norm(d_mean, tiles_total: int, tiles_x: int, tile_h: int,
               tile_w: int, img_h: int, img_w: int, tiles_y: int = 0):
    """||d mean||_ndc: pixel gradients scaled to NDC units
    (ndc_to_pixel: px = (x * .5 + .5) * W).  Without img_h the height is
    one view's tile rows: ``tiles_y`` on a merged grid of several views."""
    sx = 0.5 * (img_w if img_w else tiles_x * tile_w)
    sy = 0.5 * (img_h if img_h else
                (tiles_y or tiles_total // tiles_x) * tile_h)
    return torch.sqrt((d_mean[0] * sx) ** 2 + (d_mean[1] * sy) ** 2)


def _stats_from(g: raster_plain.PointGrads, geom) -> RasterStats:
    # err_sum is the reduced d_opacity: both are sum(dpw) / o per entry
    return RasterStats(weight_sum=g.weight_sum, frag_count=g.frag_count,
                       err_sum=g.d_opacity,
                       err_square_sum=g.err_square_sum,
                       grad_norm=_grad_norm(g.d_mean, *geom))


class _Rasterize(torch.autograd.Function):
    """Forward and backward kernels around one checked table."""

    @staticmethod
    def forward(ctx, table: BinningResult, geom, mean_pix, inv_cov, color,
                opacity, *sink):
        tiles_total, tiles_x, tile_h, tile_w = geom[:4]
        args = tuple(t.detach().contiguous()
                     for t in (mean_pix, inv_cov, color, opacity))
        tab = (table.sorted_point, table.tile_start, table.tile_count)
        tiles_color, tiles_trans = raster_cuda.raster_forward(
            *args, *tab, tiles_x, tile_h, tile_w, table_checked=True,
            tiles_y=geom[6])
        ctx.save_for_backward(*args, tiles_color, tiles_trans)
        ctx.tab, ctx.geom, ctx.with_stats = tab, geom, bool(sink)
        return tiles_color, tiles_trans

    @staticmethod
    def backward(ctx, d_tiles_color, d_tiles_trans):
        *args, tiles_color, tiles_trans = ctx.saved_tensors
        tiles_total, tiles_x, tile_h, tile_w = ctx.geom[:4]
        with profiling.span("raster_bwd"):
            g = raster_cuda.raster_backward(
                *args, *ctx.tab, tiles_x, tile_h, tile_w, tiles_color,
                tiles_trans, d_tiles_color.contiguous(),
                d_tiles_trans.contiguous(), with_stats=ctx.with_stats,
                table_checked=True, tiles_y=ctx.geom[6])
        grads = (None, None, g.d_mean, g.d_inv_cov, g.d_color, g.d_opacity)
        if ctx.with_stats:
            grads += tuple(_stats_from(g, ctx.geom))
        return grads


@profiling.spanned("raster_fwd")
def rasterize(mean_pix, inv_cov, color, opacity, table: BinningResult,
              tiles_total: int, tiles_x: int, tile_h: int, tile_w: int,
              backend: str = "cuda",
              stats_sink: Optional[RasterStats] = None,
              img_h: int = 0, img_w: int = 0, tiles_y: int = 0):
    """Rasterize gaussians into tile-layout images (differentiable).

    Args:
      mean_pix: [2, M] pixel-space means.
      inv_cov:  [3, M] inverse 2D covariance (a, b, c).
      color:    [C, M], C in {3, 4} (rgb [+ depth]).
      opacity:  [M] activated opacities.
      table:    binning result (not differentiated).
      backend:  'cuda' (the kernels on CUDA tensors, their plain versions
        on CPU tensors) or 'torch' (autograd through the plain version).
      stats_sink: optional :func:`zero_stats_sink` (``'cuda'`` backend):
        the loss's gradient with respect to it is the RasterStats of this
        view, from the same backward-kernel run as the parameter
        gradients.
      img_h/img_w: image size for the NDC ``grad_norm`` scale (defaults to
        the tile grid's extent).
      tiles_y: 0 for one view; on a merged grid of B views (``tiles_total``
        = B * tiles_x * tiles_y, ``binning.concat_tables``) each view's
        tile rows, modulo which the tile row wraps
        (``litegs_tpu/ops/raster.py:145``).
    Returns:
      (tiles_color [T, C, P], tiles_trans [T, P], None).  Tiles without
      entries come out with colour 0 and transmittance 1.
    """
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown raster backend {backend!r}")
    if backend == "torch":
        if stats_sink is not None:
            raise ValueError("stats_sink needs the 'cuda' backend; the "
                             "'torch' backend takes raster_stats")
        return (*rasterize_plain(mean_pix, inv_cov, color, opacity, table,
                                 tiles_total, tiles_x, tile_h, tile_w,
                                 tiles_y), None)
    raster_cuda.check_table(table.sorted_point, table.tile_start,
                            table.tile_count, color.shape[1])
    sink = () if stats_sink is None else tuple(stats_sink)
    tiles_color, tiles_trans = _Rasterize.apply(
        table, (tiles_total, tiles_x, tile_h, tile_w, img_h, img_w, tiles_y),
        mean_pix, inv_cov, color, opacity, *sink)
    return tiles_color, tiles_trans, None


def rasterize_plain(mean_pix, inv_cov, color, opacity, table: BinningResult,
                    tiles_total: int, tiles_x: int, tile_h: int, tile_w: int,
                    tiles_y: int = 0, max_entries: Optional[int] = None):
    """The ``'torch'`` backend: autograd through
    ``raster_plain.rasterize_reference``; returns (tiles_color,
    tiles_trans).

    Its autograd graph holds a dozen [entries, tile pixels] tensors (over
    60 GB at 840x1296 with 200,000 fresh points), so a table of more than
    ``max_entries`` (default: ``PLAIN_GROUP_PAIRS`` pairs) entries is
    rasterized in groups of whole tiles (``raster_cuda._tile_groups``),
    each under activation checkpointing: between the forward and the
    backward only each group's outputs are kept, and the backward rebuilds
    one group's graph at a time.  Every tile is computed from its own
    entries alone, so a group's tiles equal the whole table's.
    """
    def run(sorted_point, sorted_tile, entry_valid, tile_start):
        out = raster_plain.rasterize_reference(
            mean_pix, inv_cov, color, opacity, sorted_point, sorted_tile,
            entry_valid, tile_start, tiles_total, tiles_x, tile_h, tile_w,
            tiles_y)
        return out.tiles_color, out.tiles_trans

    npix = tile_h * tile_w
    limit = max_entries or max(PLAIN_GROUP_PAIRS // npix, 1)
    if table.sorted_point.shape[0] <= limit:
        return run(table.sorted_point, table.sorted_tile, table.entry_valid,
                   table.tile_start)
    tiles_color = color.new_zeros((tiles_total, color.shape[0], npix))
    tiles_trans = color.new_ones((tiles_total, npix))
    for tiles, entries, sub_tile, sub_start in raster_cuda._tile_groups(
            table.tile_start, table.tile_count, limit, tiles_x * tiles_y):
        valid = torch.ones(len(entries), dtype=torch.bool,
                           device=color.device)
        col, trans = checkpoint(run, table.sorted_point[entries], sub_tile,
                                valid, sub_start, use_reentrant=False)
        tiles_color = tiles_color.index_copy(0, tiles, col[tiles])
        tiles_trans = tiles_trans.index_copy(0, tiles, trans[tiles])
    return tiles_color, tiles_trans


def raster_stats(mean_pix, inv_cov, color, opacity, table: BinningResult,
                 out_tiles_color, out_tiles_trans, d_tiles_color,
                 d_tiles_trans, tiles_total: int, tiles_x: int,
                 tile_h: int, tile_w: int, img_h: int = 0, img_w: int = 0,
                 backend: str = "cuda", tiles_y: int = 0) -> RasterStats:
    """Per-point densification statistics from a loss cotangent: the
    explicit pass (``litegs_tpu/ops/raster.py::raster_stats``).

    Takes the forward's inputs, table and outputs and the loss's cotangent
    of the outputs.  ``backend='cuda'`` runs ``raster_cuda.raster_backward``
    (the kernel on CUDA tensors), ``'torch'`` its plain version.
    """
    args = [t.detach().contiguous()
            for t in (mean_pix, inv_cov, color, opacity)]
    tab = (table.sorted_point, table.tile_start, table.tile_count)
    outs = [t.detach().contiguous() for t in (
        out_tiles_color, out_tiles_trans, d_tiles_color, d_tiles_trans)]
    fn = (raster_cuda.raster_backward if backend == "cuda"
          else raster_cuda.raster_backward_plain)
    g = fn(*args, *tab, tiles_x, tile_h, tile_w, *outs, with_stats=True,
           tiles_y=tiles_y)
    return _stats_from(g, (tiles_total, tiles_x, tile_h, tile_w, img_h,
                           img_w, tiles_y))
