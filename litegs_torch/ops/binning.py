"""Tile binning: build the per-tile depth-sorted gaussian table.

The counterpart of ``litegs_tpu/ops/binning.py``, with buffers sized exactly
from the data:

  1. the same visibility test and closed-form exact ellipse/tile-row
     intersection (speedy-splat's AccuTile slab walk, evaluated per
     (point, tile-row) pair), with the row range tightened to rows whose
     clipped x-span is nonempty;
  2. a stable depth sort of the points;
  3. two expansions, point -> (point, tile-row) -> (point, tile).  The
     streaming configuration (``stream``, the default on CUDA tensors:
     ``config.BINNING_STREAM``) replicates each stage's payload through the
     hand-written kernels of ``ops/stream_gather``; the other one decodes
     owners with :func:`expand_with_table` (``torch.repeat_interleave`` and
     one row gather).  Both give the same table, entry for entry;
  4. a stable sort by tile, so each tile's entries are contiguous and in
     depth order.

The table is exact and unpadded: tile t owns entries
``[tile_start[t], tile_start[t] + tile_count[t])``.  The JAX package's
128-alignment pads, ``num_aligned`` and f32-encoded integer columns are TPU
artifacts and have no counterpart here.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import config
from ..utils import profiling
from . import stream_gather

# float -> int32 conversions saturate here first: torch's cast of an
# out-of-range float is undefined, XLA's saturates
_INT_RANGE = float(1 << 30)


class BinningResult(NamedTuple):
    sorted_point: torch.Tensor   # [E] int32 point index per table entry
    sorted_tile: torch.Tensor    # [E] int32 tile id per entry
    entry_valid: torch.Tensor    # [E] bool (all True: no padding)
    tile_start: torch.Tensor     # [T] int32 start offset per tile
    tile_count: torch.Tensor     # [T] int32 entries per tile
    num_entries: int             # E
    num_rows: int                # (point, tile-row) pairs
    primitive_visible: torch.Tensor  # [M] bool: point touches >= 1 tile
    point_counts: torch.Tensor   # [M] int32 table entries per point
    overflow: bool               # always False (buffers are exact)


def _to_i32(x):
    return torch.clamp(x, -_INT_RANGE, _INT_RANGE).to(torch.int32)


def _clip_i(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def tile_counts_for_rows(px, py, a, b, c, t, disc, row, tile_h, tile_w,
                         rect_min_x, rect_max_x):
    """Exact x-tile span of the ellipse within one tile row (vectorized).

    The x-extremes of the convex region {q <= t} within the y-slab
    [row*tile_h, (row+1)*tile_h] are attained either at the global x-apex
    (if its y lies in the slab) or at a slab edge; clamping the apex height
    into the slab's y-interval (itself clamped to the ellipse's y-extent)
    selects the right case in one evaluation of
    x(y) = px + (-b h -+ sqrt(disc h^2 + t a)) / a.

    Returns (min_tile, count) per row.
    """
    dy_max = torch.sqrt(torch.clamp(-t * a / disc, min=0.0))
    h0 = row * tile_h - py
    h1 = (row + 1) * tile_h - py
    h0c = torch.minimum(torch.maximum(h0, -dy_max), dy_max)
    h1c = torch.minimum(torch.maximum(h1, -dy_max), dy_max)
    dx_max = torch.sqrt(torch.clamp(-t * c / disc, min=0.0))
    h_xmin = (b / c) * dx_max
    h_xmax = -h_xmin
    he_min = torch.minimum(torch.maximum(h_xmin, h0c), h1c)
    he_max = torch.minimum(torch.maximum(h_xmax, h0c), h1c)
    sq_min = torch.sqrt(torch.clamp(disc * he_min * he_min + t * a, min=0.0))
    sq_max = torch.sqrt(torch.clamp(disc * he_max * he_max + t * a, min=0.0))
    x_lo = px + (-b * he_min - sq_min) / a
    x_hi = px + (-b * he_max + sq_max) / a
    min_tile = _clip_i(_to_i32(torch.floor(x_lo / tile_w)),
                       rect_min_x, rect_max_x)
    max_tile = _clip_i(_to_i32(torch.floor(x_hi / tile_w)) + 1,
                       rect_min_x, rect_max_x)
    count = torch.clamp(max_tile - min_tile, min=0)
    return min_tile, count


def _y_span_in_xband(px, py, a, b, c, t, disc, x0, x1):
    """Exact y-extent of the ellipse {q <= t} within the x-band [x0, x1].

    The transpose of :func:`tile_counts_for_rows` (x <-> y, a <-> c); used
    to tighten the emitted row range to rows whose x-span survives the
    image clip.  Removing zero-count rows never changes the entry set.
    """
    dx_max = torch.sqrt(torch.clamp(-t * c / disc, min=0.0))
    e0 = torch.minimum(torch.maximum(x0 - px, -dx_max), dx_max)
    e1 = torch.minimum(torch.maximum(x1 - px, -dx_max), dx_max)
    dy_max = torch.sqrt(torch.clamp(-t * a / disc, min=0.0))
    e_ymin = (b / a) * dy_max
    e_ymax = -e_ymin
    ee_min = torch.minimum(torch.maximum(e_ymin, e0), e1)
    ee_max = torch.minimum(torch.maximum(e_ymax, e0), e1)
    sq_min = torch.sqrt(torch.clamp(disc * ee_min * ee_min + t * c, min=0.0))
    sq_max = torch.sqrt(torch.clamp(disc * ee_max * ee_max + t * c, min=0.0))
    y_lo = py + (-b * ee_min - sq_min) / c
    y_hi = py + (-b * ee_max + sq_max) / c
    return y_lo, y_hi


def _ellipse_tile_rect(px, py, a_s, c_s, t_s, disc_s,
                       tile_h, tile_w, tiles_x, tiles_y):
    """Exact ellipse extent -> clipped tile rect (binning.cu:324-355).

    Returns (dx_max, dy_max, min_x, max_x, min_y, max_y).
    """
    dx_max = torch.sqrt(torch.clamp(-t_s * c_s / disc_s, min=0.0))
    dy_max = torch.sqrt(torch.clamp(-t_s * a_s / disc_s, min=0.0))
    min_x = torch.clamp(torch.floor((px - dx_max) / tile_w), 0,
                        tiles_x).to(torch.int32)
    max_x = torch.clamp(torch.floor((px + dx_max + tile_w - 1) / tile_w), 0,
                        tiles_x).to(torch.int32)
    min_y = torch.clamp(torch.floor((py - dy_max) / tile_h), 0,
                        tiles_y).to(torch.int32)
    max_y = torch.clamp(torch.floor((py + dy_max + tile_h - 1) / tile_h), 0,
                        tiles_y).to(torch.int32)
    return dx_max, dy_max, min_x, max_x, min_y, max_y


def _visible_and_safe(ndc, view_z, inv_cov2d, opacity, valid_mask,
                      img_h, img_w):
    """Visibility (binning.cu:319-320) and the per-point quadratic inputs,
    with invisible points' values replaced by safe constants."""
    a, b, c = inv_cov2d[0], inv_cov2d[1], inv_cov2d[2]
    disc = b * b - a * c
    # NDC guard band 1.3, view z > 0.2, opacity >= 1/255, inverse
    # covariance positive definite
    visible = ((ndc[0].abs() <= 1.3) & (ndc[1].abs() <= 1.3)
               & (view_z > 0.2) & (opacity >= 1.0 / 255.0)
               & (a > 0) & (c > 0) & (disc < 0) & valid_mask)
    # pixel center coords (binning.cu:315-316)
    px = (ndc[0] * 0.5 + 0.5) * img_w - 0.5
    py = (ndc[1] * 0.5 + 0.5) * img_h - 0.5
    t = 2.0 * torch.log(torch.clamp(opacity, min=1e-12) * 255.0)
    one = torch.ones_like(a)
    a_s = torch.where(visible, a, one)
    c_s = torch.where(visible, c, one)
    disc_s = torch.where(visible, disc, -one)
    t_s = torch.where(visible, t, torch.zeros_like(t))
    return visible, px, py, a_s, b, c_s, disc_s, t_s


def estimate_table_sizes(ndc, view_z, inv_cov2d, opacity, valid_mask,
                         img_h: int, img_w: int, tile_h: int, tile_w: int):
    """Cheap upper-bound sizing pass: no expansions.

    Returns [3] int32 (visible points, exact row count, entry upper bound
    from the tile-rect area).
    """
    tiles_x = math.ceil(img_w / tile_w)
    tiles_y = math.ceil(img_h / tile_h)
    visible, px, py, a_s, _, c_s, disc_s, t_s = _visible_and_safe(
        ndc, view_z, inv_cov2d, opacity, valid_mask, img_h, img_w)
    _, _, rmin_x, rmax_x, rmin_y, rmax_y = _ellipse_tile_rect(
        px, py, a_s, c_s, t_s, disc_s, tile_h, tile_w, tiles_x, tiles_y)
    zero = torch.zeros_like(px)
    rect_w = torch.where(visible, (rmax_x - rmin_x).float(), zero)
    rect_h = torch.where(visible, (rmax_y - rmin_y).float(), zero)
    n_vis = visible.sum()
    n_rows = rect_h.sum()
    n_entries = (rect_w * rect_h).sum()
    return torch.stack([n_vis.to(torch.int32), n_rows.to(torch.int32),
                        n_entries.to(torch.int32)])


def expand_by_counts(counts):
    """Decode flat slots of a variable-length concatenation.

    Given per-item counts, slot e of the concatenation belongs to item
    ``owner[e]`` at ``rank[e]``.  The output is exactly as long as the
    total.  One host read (the total).

    Returns (owner [total] int32, rank [total] int32, total int).
    """
    m = counts.shape[0]
    dev = counts.device
    cum = torch.cumsum(counts, 0)
    if m:
        profiling.host_wait("bin.total")
    total = int(cum[-1]) if m else 0
    owner = torch.repeat_interleave(
        torch.arange(m, dtype=torch.int32, device=dev), counts,
        output_size=total)
    slots = torch.arange(total, dtype=torch.int32, device=dev)
    starts = (cum - counts).to(torch.int32)
    rank = slots - starts[owner]
    return owner, rank, total


def expand_with_table(counts, table):
    """:func:`expand_by_counts` plus the fetch of per-item payload columns
    in one row gather.

    Args:
      counts: [m] integer per-item expansion counts.
      table: [m, K] per-item payload, any one dtype.
    Returns (owner, rank, total, fetched [total, K]).  ``fetched`` is laid
    out column by column (``fetched.T`` is contiguous), so that each
    fetched column is a contiguous vector for what consumes it; a table
    handed over as the transpose of a contiguous [K, m] tensor is read the
    same way.
    """
    owner, rank, total = expand_by_counts(counts)
    return owner, rank, total, table.T[:, owner].T


# output slots per thread block of the streaming expansions; their item
# windows are the step + 128 (rows: every emitting point owns >= 1 row) and
# the step + 256 (entries: slack for rows that float32 tangency left empty)
STREAM_STEP = 512
STREAM_ROUTES = ("window", "async", "prefix")


def stream_route(stream, on_cuda: bool):
    """The streaming route ``stream`` selects, or None for the
    non-streaming expansions.  None means ``config.BINNING_STREAM`` (a
    bool) on CUDA tensors and off on CPU tensors; True means ``'window'``,
    and the other routes are reached by name only."""
    if stream is None:
        stream = bool(config.BINNING_STREAM) if on_cuda else False
    if stream is True:
        return "window"
    if not stream:
        return None
    if stream not in STREAM_ROUTES:
        raise ValueError(f"stream={stream!r}: expected a bool, None or one "
                         f"of {STREAM_ROUTES}")
    return stream


def _check_windows(*oks):
    """The streaming kernels' window check.  The table's buffers are exact,
    so there is nothing to retry with: a window that did not hold a step's
    owners is an error.  One host read."""
    profiling.host_wait("bin.windows")
    if not bool(torch.stack(oks).all()):
        raise RuntimeError(
            "streaming binning: an expansion step's owners span more items "
            "than its window holds (a long run of rows that own no tile); "
            "set litegs_torch.config.BINNING_STREAM = False, or pass "
            "stream=False to build_tile_table, to build the table without "
            "the streaming kernels")


@profiling.spanned("bin")
def build_tile_table(ndc, view_z, inv_cov2d, opacity, valid_mask,
                     img_h: int, img_w: int, tile_h: int, tile_w: int,
                     stream=None) -> BinningResult:
    """Construct the depth-sorted per-tile gaussian table.

    Args:
      ndc:       [4, M] NDC positions.
      view_z:    [M] view-space depth.
      inv_cov2d: [3, M] inverse 2D covariance (a, b, c).
      opacity:   [M] activated opacities.
      valid_mask: [M] bool, False for slots that must not render.
      img_h..tile_w: image/tile geometry.
      stream: run the two expansions through the streaming kernels of
        ``ops/stream_gather``.  None (the default) means
        ``config.BINNING_STREAM`` on CUDA tensors and off on CPU tensors;
        True or ``'window'`` runs both through ``expand_attrs_windowed``,
        ``'async'`` through its ``dma=True`` kernel, ``'prefix'`` runs the
        first through ``expand_attrs`` (the depth key sorts the points
        that emit no row to the tail, so its prefix contract holds there).
        A window overrun raises.  Every route returns the same table.
    """
    dev = ndc.device
    m = ndc.shape[-1]
    tiles_x = math.ceil(img_w / tile_w)
    tiles_y = math.ceil(img_h / tile_h)
    tiles_total = tiles_x * tiles_y
    route = stream_route(stream, ndc.is_cuda)

    visible, px, py, a_s, b, c_s, disc_s, t_s = _visible_and_safe(
        ndc, view_z, inv_cov2d, opacity, valid_mask, img_h, img_w)
    _, _, rect_min_x, rect_max_x, rect_min_y, rect_max_y = \
        _ellipse_tile_rect(px, py, a_s, c_s, t_s, disc_s,
                           tile_h, tile_w, tiles_x, tiles_y)
    # tighten the row range to rows with a nonempty clipped x-span (every
    # emitted row then produces >= 1 entry, what the streaming windows
    # count on)
    y_lo, y_hi = _y_span_in_xband(
        px, py, a_s, b, c_s, t_s, disc_s,
        rect_min_x.float() * tile_w, rect_max_x.float() * tile_w)
    row_min_y = _clip_i(_to_i32(torch.floor(y_lo / tile_h)),
                        rect_min_y, rect_max_y)
    row_max_y = _clip_i(_to_i32(torch.floor(y_hi / tile_h)) + 1,
                        rect_min_y, rect_max_y)
    n_rows = torch.where(visible & (rect_max_x > rect_min_x),
                         torch.clamp(row_max_y - row_min_y, min=0),
                         torch.zeros_like(row_min_y))

    # depth order, front to back (wrapper.py:739-742); points that emit no
    # rows sort behind every emitting point and expand to nothing, so the
    # row counts > 0 form a contiguous prefix in depth order
    z_key = torch.where(visible & (n_rows > 0), view_z,
                        torch.full_like(view_z, float("inf")))
    depth_order = torch.sort(z_key, stable=True).indices

    # expansion 1: (point) -> (point, tile-row), in depth order.  The
    # per-point payload: point id, the quadratic's inputs, the point-level
    # tile rect and the row count, as 4-byte words (float32 columns ride
    # bitcast, nothing is re-encoded)
    words = [c if c.dtype == torch.int32 else c.view(torch.int32)
             for c in (torch.arange(m, dtype=torch.int32, device=dev),
                       px, py, a_s, b, c_s, t_s, disc_s, rect_min_x,
                       rect_max_x, row_min_y, n_rows)]
    pt_sorted = torch.stack(words)[:, depth_order]              # [12, M]
    oks = []
    if route:
        if route == "prefix":
            r, row_rank, _ = stream_gather.expand_attrs(
                pt_sorted, pt_sorted[11])
        else:
            r, row_rank, _, ok = stream_gather.expand_attrs_windowed(
                pt_sorted, pt_sorted[11], None,
                window_items=STREAM_STEP + 128, slots_per_step=STREAM_STEP,
                dma=route == "async")
            oks.append(ok)
    else:
        _, row_rank, _, rv = expand_with_table(pt_sorted[11], pt_sorted.T)
        r = rv.T
    num_rows = row_rank.shape[0]
    f32 = torch.float32
    row_pt = r[0]
    r_min_x, r_max_x = r[8], r[9]
    row_y = r[10] + row_rank
    min_tile_x, row_tiles = tile_counts_for_rows(
        r[1].view(f32), r[2].view(f32), r[3].view(f32), r[4].view(f32),
        r[5].view(f32), r[6].view(f32), r[7].view(f32), row_y.float(),
        float(tile_h), float(tile_w), r_min_x, r_max_x)

    # expansion 2: (point, tile-row) -> (point, tile) = table entry
    row_table = torch.stack([row_pt, row_y, min_tile_x])        # [3, R]
    if route:
        ev, ent_rank, _, ok = stream_gather.expand_attrs_windowed(
            row_table, row_tiles, None,
            window_items=STREAM_STEP + 256, slots_per_step=STREAM_STEP,
            dma=route == "async")
        oks.append(ok)
        _check_windows(*oks)
    else:
        _, ent_rank, _, ev = expand_with_table(row_tiles, row_table.T)
        ev = ev.T
    ent_pt = ev[0]
    ent_tile = ev[1] * tiles_x + ev[2] + ent_rank
    num_entries = ent_pt.shape[0]

    # stable sort by tile keeps each tile's entries in depth order
    sorted_tile, order = torch.sort(ent_tile, stable=True)
    sorted_point = ent_pt[order]
    # CUDA's bincount reads its input's min and max to the host
    if num_entries:
        profiling.host_wait("bin.bincount", 4)
    tile_count = torch.bincount(sorted_tile, minlength=tiles_total)
    tile_start = torch.cumsum(tile_count, 0) - tile_count
    point_counts = torch.bincount(ent_pt, minlength=m)
    return BinningResult(
        sorted_point=sorted_point.to(torch.int32),
        sorted_tile=sorted_tile.to(torch.int32),
        entry_valid=torch.ones(num_entries, dtype=torch.bool, device=dev),
        tile_start=tile_start.to(torch.int32),
        tile_count=tile_count.to(torch.int32),
        num_entries=num_entries,
        num_rows=num_rows,
        primitive_visible=point_counts > 0,
        point_counts=point_counts.to(torch.int32),
        overflow=False)


def concat_tables(tables, tiles_total: int) -> BinningResult:
    """Merge B per-view tables into ONE table over a B * T tile grid
    (``litegs_tpu/ops/binning.py::concat_tables``).

    View v's tiles move to [v T, (v + 1) T); its point ids move past the
    points of the views before it and its entries past their entries.
    The tables here are exact (no pads), so the offsets are cumulative --
    point ids by the sum of the earlier views' M_u (each view's M is the
    length of its ``primitive_visible``), ``tile_start`` by the sum of
    their E_u -- where JAX's padded buffers shift by fixed v m and v E_len.
    The result is one table for ONE rasterize() call over B * T tiles
    with ``tiles_y`` set to a view's tile rows: per-tile depth order is
    untouched, and the per-point outputs over the concatenated [sum M_v]
    points split back into views at the same offsets.
    """
    point_off = entry_off = 0
    sp, st, ts = [], [], []
    for v, t in enumerate(tables):
        sp.append(t.sorted_point + point_off)
        st.append(t.sorted_tile + v * tiles_total)
        ts.append(t.tile_start + entry_off)
        point_off += t.primitive_visible.shape[0]
        entry_off += t.num_entries
    return BinningResult(
        sorted_point=torch.cat(sp), sorted_tile=torch.cat(st),
        entry_valid=torch.cat([t.entry_valid for t in tables]),
        tile_start=torch.cat(ts),
        tile_count=torch.cat([t.tile_count for t in tables]),
        num_entries=entry_off,
        num_rows=sum(t.num_rows for t in tables),
        primitive_visible=torch.cat([t.primitive_visible for t in tables]),
        point_counts=torch.cat([t.point_counts for t in tables]),
        overflow=False)
