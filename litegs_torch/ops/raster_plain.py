"""Plain PyTorch tile rasterizer.

The port of ``litegs_tpu/ops/raster_jnp.py::rasterize_reference``: alpha
compositing vectorized over the flat (tile-sorted) entry axis, the
sequential front-to-back blend written as a segmented exclusive cumulative
sum of log(1 - alpha).  Differentiable by autograd.  It is the
``raster_backend='torch'`` path and the plain version the raster kernels
are held against.

Blend semantics (raster.cu:161-332):
  * alpha = opacity * exp(-0.5 q), q the inverse-covariance quadratic at
    the pixel center (integer pixel coordinates);
  * alpha < 1/256 is discarded; alpha is clamped to <= 255/256, and the
    clamp is straight-through for gradients (raster.cu:776-778);
  * a pixel stops accepting contributions once its transmittance drops to
    <= 1/8192 (raster.cu:260); its final transmittance is the first value
    at or below that bound;
  * outputs are unclamped; the render wrapper clips to [0, 1].

The segmented cumulative sum runs in float64: it is taken over the whole
entry axis and its running total grows with the number of entries, so in
float32 a deep table would lose the per-tile prefix to cancellation.

:func:`raster_backward_reference` is the analytic backward of the same
blend, with the per-point densification statistics that autograd cannot
give.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

ALPHA_MIN = 1.0 / 256.0
ALPHA_MAX = 255.0 / 256.0
T_MIN = 1.0 / 8192.0

# calls of rasterize_reference and of raster_backward_reference, so a run
# can show which path rendered and which path took the gradients
CALLS = 0
BACKWARD_CALLS = 0


class RasterOutput(NamedTuple):
    tiles_color: torch.Tensor   # [T, C, P] accumulated (unclamped) channels
    tiles_trans: torch.Tensor   # [T, P] final transmittance
    frag_count: torch.Tensor    # [M] int32 fragments with valid alpha
    frag_weight: torch.Tensor   # [M] blend-weight sum per point


class PointGrads(NamedTuple):
    """Per-point gradients of a blend, and its fragment statistics."""

    d_mean: torch.Tensor        # [2, M]
    d_inv_cov: torch.Tensor     # [3, M]
    d_color: torch.Tensor       # [C, M]
    d_opacity: torch.Tensor     # [M]
    # statistics, None unless requested
    weight_sum: Optional[torch.Tensor] = None      # [M] sum of blend weights
    frag_count: Optional[torch.Tensor] = None      # [M] contributing pairs
    err_square_sum: Optional[torch.Tensor] = None  # [M] sum (dpw / o)^2


def tile_pixel_coords(tiles_x: int, tile_h: int, tile_w: int, tile_ids,
                      tiles_y: int = 0):
    """Pixel coords of each tile's pixels, row-major within the tile.

    ``tiles_y > 0``: the tile row wraps modulo ``tiles_y``, so a merged
    grid of B views (view v's tiles at [v T, (v + 1) T),
    ``binning.concat_tables``) places each view's tiles on its own image;
    0 is the single-view grid.  Returns (x [E, P], y [E, P]) as float32.
    """
    p = torch.arange(tile_h * tile_w, device=tile_ids.device)
    in_y = (p // tile_w)[None, :]
    in_x = (p % tile_w)[None, :]
    row = tile_ids // tiles_x
    ty = (row % tiles_y if tiles_y > 0 else row)[:, None]
    tx = (tile_ids % tiles_x)[:, None]
    return ((tx * tile_w + in_x).float(), (ty * tile_h + in_y).float())


def pair_alpha(mean_pix, inv_cov, opacity, sp, pix_x, pix_y):
    """The (entry, pixel) pairs of entries of points ``sp`` [E] at pixels
    (pix_x, pix_y) [E, P]: returns (dx, dy [E, P], a, b, c [E, 1],
    alpha_raw [E, P]), dx = mean_x - px.  The exponent's operations come in
    the order the kernels repeat them (``csrc/raster_common.cuh``
    ``pair_alpha``), each rounded on its own."""
    dx = mean_pix[0][sp][:, None] - pix_x
    dy = mean_pix[1][sp][:, None] - pix_y
    a = inv_cov[0][sp][:, None]
    b = inv_cov[1][sp][:, None]
    c = inv_cov[2][sp][:, None]
    power = -0.5 * (a * dx * dx + 2.0 * b * dx * dy + c * dy * dy)
    return dx, dy, a, b, c, opacity[sp][:, None] * torch.exp(power)


def _segmented_exclusive_cumsum(x, seg_start_per_entry):
    """Exclusive cumsum of x [E, P] within segments of the entry axis.

    seg_start_per_entry [E]: start offset of each entry's segment.
    """
    x64 = x.double()
    cum = torch.cumsum(x64, dim=0)
    excl = cum - x64
    start = seg_start_per_entry
    base = torch.where((start > 0)[:, None],
                       cum[torch.clamp(start - 1, min=0)],
                       torch.zeros((), dtype=cum.dtype, device=cum.device))
    return (excl - base).float()


def rasterize_reference(mean_pix, inv_cov, color, opacity,
                        sorted_point, sorted_tile, entry_valid, tile_start,
                        tiles_total: int, tiles_x: int,
                        tile_h: int, tile_w: int,
                        tiles_y: int = 0) -> RasterOutput:
    """Rasterize into tile-layout images.

    Args:
      mean_pix: [2, M] gaussian centers in pixel coords.
      inv_cov:  [3, M] inverse 2D covariance (a, b, c).
      color:    [C, M] per-point channels (RGB, optionally + depth).
      opacity:  [M] activated opacity.
      sorted_point/sorted_tile/entry_valid/tile_start: a binning table
        whose tiles own contiguous entry runs (ops/binning.py, or the JAX
        package's padded table); sorted_tile == tiles_total marks padding.
      tiles_y: tile rows per view on a merged grid of several views (the
        tile row wraps modulo it); 0 for one view.
    Returns RasterOutput (tile layout; utils.math.tiles_to_img converts).
    """
    global CALLS
    CALLS += 1
    nchan, m = color.shape
    sp = sorted_point.long()
    safe_tile = torch.clamp(sorted_tile.long(), max=tiles_total - 1)
    pix_x, pix_y = tile_pixel_coords(tiles_x, tile_h, tile_w, safe_tile,
                                     tiles_y)

    alpha_raw = pair_alpha(mean_pix, inv_cov, opacity, sp, pix_x,
                           pix_y)[-1]
    # straight-through upper clamp (see module docstring)
    alpha_c = alpha_raw + (torch.clamp(alpha_raw, max=ALPHA_MAX)
                           - alpha_raw).detach()
    alpha_ok = (alpha_raw >= ALPHA_MIN) & entry_valid[:, None]
    alpha = torch.where(alpha_ok, alpha_c, torch.zeros_like(alpha_c))

    seg_start = tile_start.long()[safe_tile]

    # plain transmittance decides the stop condition (raster.cu:260)
    log_t = torch.log1p(-alpha)
    t_plain_excl = torch.exp(_segmented_exclusive_cumsum(log_t.detach(),
                                                         seg_start))
    active = t_plain_excl > T_MIN

    alpha_eff = torch.where(active, alpha, torch.zeros_like(alpha))
    log_t_eff = torch.log1p(-alpha_eff)
    t_excl = torch.exp(_segmented_exclusive_cumsum(log_t_eff, seg_start))
    weight = alpha_eff * t_excl                     # [E, P]

    col = color[:, sp]                              # [C, E]
    contrib = col[:, :, None] * weight[None]        # [C, E, P]
    npix = tile_h * tile_w
    tiles_color = torch.zeros((tiles_total, nchan, npix), dtype=color.dtype,
                              device=color.device).index_add(
        0, safe_tile, contrib.permute(1, 0, 2))
    seg_logt = torch.zeros((tiles_total, npix), dtype=log_t_eff.dtype,
                           device=color.device).index_add(
        0, safe_tile, log_t_eff)
    tiles_trans = torch.exp(seg_logt)               # [T, P]

    frag_ok = alpha_ok & active
    frag_count = torch.zeros(m, dtype=torch.int32,
                             device=color.device).index_add(
        0, sp, frag_ok.sum(dim=-1, dtype=torch.int32))
    frag_weight = torch.zeros(m, dtype=weight.dtype,
                              device=color.device).index_add(
        0, sp, weight.detach().sum(dim=-1))
    return RasterOutput(tiles_color=tiles_color, tiles_trans=tiles_trans,
                        frag_count=frag_count, frag_weight=frag_weight)


@torch.no_grad()
def raster_backward_reference(mean_pix, inv_cov, color, opacity,
                              sorted_point, sorted_tile, entry_valid,
                              tile_start, tiles_total: int, tiles_x: int,
                              tile_h: int, tile_w: int, tiles_color,
                              tiles_trans, d_tiles_color, d_tiles_trans,
                              with_stats: bool = False,
                              tiles_y: int = 0) -> PointGrads:
    """Analytic backward of :func:`rasterize_reference`, per point.

    Takes the forward's inputs and table, its outputs (``tiles_color``
    [T, C, P], ``tiles_trans`` [T, P]) and their cotangents, and walks the
    entries in forward order (``litegs_tpu/ops/raster_pallas.py:424-505``):

      D0      = sum_c dC_c C_total_c + T_fin dT             per pixel
      prefix  = inclusive per-tile cumsum of (c . dC) w     w = alpha T
      d_alpha = (c . dC) T - (D0 - prefix) / (1 - alpha)   contributing pairs
      dpw     = d_alpha * alpha_raw                         (straight through
                                                             the 255/256 clamp)

    With power = -(a dx^2 + 2 b dx dy + c dy^2) / 2 and dx = mean_x - px,
    the pair gradients are d_mean = -(a dx + b dy, b dx + c dy) dpw,
    d_inv_cov = -(dx^2 / 2, dx dy, dy^2 / 2) dpw, d_color = dC w and
    d_opacity = dpw / o.  With ``with_stats`` it also returns each point's
    blend-weight sum, its number of contributing (entry, pixel) pairs and
    its sum over pairs of (dpw / o)^2 -- the fragment statistics of
    ``litegs_tpu/ops/raster.py::raster_stats``.  ``tiles_y`` as in
    :func:`rasterize_reference`.
    """
    global BACKWARD_CALLS
    BACKWARD_CALLS += 1
    m = color.shape[1]
    sp = sorted_point.long()
    safe_tile = torch.clamp(sorted_tile.long(), max=tiles_total - 1)
    pix_x, pix_y = tile_pixel_coords(tiles_x, tile_h, tile_w, safe_tile,
                                     tiles_y)

    dx, dy, a, b, c, alpha_raw = pair_alpha(mean_pix, inv_cov, opacity, sp,
                                            pix_x, pix_y)
    alpha_ok = (alpha_raw >= ALPHA_MIN) & entry_valid[:, None]
    zero = torch.zeros((), dtype=alpha_raw.dtype, device=alpha_raw.device)
    alpha = torch.where(alpha_ok, torch.clamp(alpha_raw, max=ALPHA_MAX), zero)
    seg_start = tile_start.long()[safe_tile]
    t_excl = torch.exp(_segmented_exclusive_cumsum(torch.log1p(-alpha),
                                                   seg_start))
    ok = alpha_ok & (t_excl > T_MIN)
    w = torch.where(ok, alpha * t_excl, zero)

    d_col_e = d_tiles_color[safe_tile]              # [E, C, P]
    g1 = torch.einsum("ce,ecp->ep", color[:, sp], d_col_e)
    d0 = (torch.sum(d_tiles_color * tiles_color, dim=1)
          + tiles_trans * d_tiles_trans)            # [T, P]
    u = g1 * w
    prefix = _segmented_exclusive_cumsum(u, seg_start) + u
    d_alpha = torch.where(ok, g1 * t_excl - (d0[safe_tile] - prefix)
                          / (1.0 - alpha), zero)
    dpw = d_alpha * alpha_raw

    op_e = torch.clamp(opacity[sp], min=1e-12)

    def to_points(per_entry):                       # [K, E] -> [K, M]
        return torch.zeros((per_entry.shape[0], m), dtype=per_entry.dtype,
                           device=per_entry.device).index_add_(
            1, sp, per_entry)

    d_mean = to_points(torch.stack([(-(a * dx + b * dy) * dpw).sum(-1),
                                    (-(b * dx + c * dy) * dpw).sum(-1)]))
    d_inv_cov = to_points(torch.stack([(-0.5 * dx * dx * dpw).sum(-1),
                                       (-dx * dy * dpw).sum(-1),
                                       (-0.5 * dy * dy * dpw).sum(-1)]))
    d_color = to_points(torch.einsum("ecp,ep->ce", d_col_e, w))
    d_opacity = to_points((dpw.sum(-1) / op_e)[None])[0]
    if not with_stats:
        return PointGrads(d_mean, d_inv_cov, d_color, d_opacity)
    stats = to_points(torch.stack([w.sum(-1), ok.sum(-1, dtype=w.dtype),
                                   (dpw * dpw).sum(-1) / (op_e * op_e)]))
    return PointGrads(d_mean, d_inv_cov, d_color, d_opacity,
                      weight_sum=stats[0], frag_count=stats[1],
                      err_square_sum=stats[2])
