"""Tile binning: build the per-tile depth-sorted gaussian table.

The counterpart of ``litegs_tpu/ops/binning.py``, with buffers sized exactly
from the data.  Every route applies the same visibility test and
closed-form exact ellipse/tile-row intersection (speedy-splat's AccuTile
slab walk, evaluated per (point, tile-row) pair), with the row range
tightened to rows whose clipped x-span is nonempty, and gives the same
table, entry for entry.  The default route (``'keys'``, on CPU and CUDA
tensors alike while ``config.BINNING_STREAM`` is on) is the reference's
count -> scan -> duplicate-with-keys -> sort -> ranges (binning.cu:33-110):

  1. count each point's rows and entries (``bin_count_kernel`` of
     ``ops/binning_cuda`` on the card), and read both totals and the range
     of the emitting points' view-z bits to the host in one copy;
  2. emit each entry's key ``tile << zb | (view-z bits - their least)``
     (``zb`` the width of their range) and point id at its point's offset
     in the scan of the entry counts;
  3. sort the pairs once, stably, by the key's tile and depth bits: entries
     emitted in point order come out tile by tile, each tile's in depth
     order, ties by point index;
  4. find each tile's run in the sorted keys.

The other routes, kept by name, build the same table as the JAX package
does: a stable depth sort of the points, two expansions point ->
(point, tile-row) -> (point, tile) -- through the hand-written kernels of
``ops/stream_gather`` (``True`` or ``'window'``, ``'async'``,
``'prefix'``) or :func:`expand_with_table` (``False``) -- a stable sort by
tile and two histograms.

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
from . import binning_cuda, stream_gather

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
STREAM_ROUTES = ("keys", "window", "async", "prefix")

# calls of the 'keys' route's plain version, so a run can show that a CUDA
# tensor never took it
PLAIN_CALLS = 0


def stream_route(stream):
    """The route ``stream`` selects, or None for the non-streaming
    expansions.  None means ``'keys'`` while ``config.BINNING_STREAM`` (a
    bool) is on, and None otherwise; True means ``'window'``, and the other
    routes are reached by name only."""
    if stream is None:
        stream = "keys" if config.BINNING_STREAM else False
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
            "pass stream='keys' or stream=False to build_tile_table to "
            "build the table without the window kernels")


def _point_rows(ndc, view_z, inv_cov2d, opacity, valid_mask,
                img_h: int, img_w: int, tile_h: int, tile_w: int):
    """Every point's row walk: (visible, (px, py, a, b, c, t, disc) with
    invisible points' values made safe, rect_min_x, rect_max_x, row_min_y,
    n_rows), the rows tightened to those with a nonempty clipped x-span
    (every emitted row then produces >= 1 entry, what the streaming
    windows count on)."""
    tiles_x = math.ceil(img_w / tile_w)
    tiles_y = math.ceil(img_h / tile_h)
    visible, px, py, a_s, b, c_s, disc_s, t_s = _visible_and_safe(
        ndc, view_z, inv_cov2d, opacity, valid_mask, img_h, img_w)
    _, _, rect_min_x, rect_max_x, rect_min_y, rect_max_y = \
        _ellipse_tile_rect(px, py, a_s, c_s, t_s, disc_s,
                           tile_h, tile_w, tiles_x, tiles_y)
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
    return (visible, (px, py, a_s, b, c_s, t_s, disc_s), rect_min_x,
            rect_max_x, row_min_y, n_rows)


def _table(sorted_point, sorted_tile, tile_start, tile_count, point_counts,
           num_rows: int, num_entries: int) -> BinningResult:
    return BinningResult(
        sorted_point=sorted_point.to(torch.int32),
        sorted_tile=sorted_tile.to(torch.int32),
        entry_valid=torch.ones(num_entries, dtype=torch.bool,
                               device=sorted_point.device),
        tile_start=tile_start.to(torch.int32),
        tile_count=tile_count.to(torch.int32),
        num_entries=num_entries,
        num_rows=num_rows,
        primitive_visible=point_counts > 0,
        point_counts=point_counts.to(torch.int32),
        overflow=False)


def _empty_table(m: int, tiles_total: int, num_rows: int, point_counts,
                 dev) -> BinningResult:
    """The table of a view whose points emit no entry."""
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    zeros = torch.zeros(tiles_total, dtype=torch.int32, device=dev)
    if point_counts is None:
        point_counts = torch.zeros(m, dtype=torch.int32, device=dev)
    return _table(none, none, zeros, zeros, point_counts, num_rows, 0)


def _key_layout(z_lo: int, z_hi: int, tiles_total: int):
    """(z_min, zb, key bits) of a view whose emitting points' view-z bits
    span [z_lo, z_hi]: a key is ``tile << zb | (z bits - z_min)``."""
    zb = (z_hi - z_lo).bit_length()
    return z_lo, zb, (tiles_total - 1).bit_length() + zb


def _table_by_keys(ndc, view_z, inv_cov2d, opacity, valid_mask,
                   img_h: int, img_w: int, tile_h: int, tile_w: int):
    """The ``'keys'`` route on the card: count, scan, one host read of the
    totals and the depth range, emit, one stable sort of the pairs,
    ranges."""
    dev = ndc.device
    m = ndc.shape[-1]
    tiles_total = math.ceil(img_w / tile_w) * math.ceil(img_h / tile_h)
    if m == 0:
        return _empty_table(0, tiles_total, 0, None, dev)
    geom = binning_cuda.Geometry(img_h, img_w, tile_h, tile_w)
    inputs = binning_cuda.point_inputs(ndc, view_z, inv_cov2d, opacity,
                                       valid_mask)
    entries, totals = binning_cuda.count(inputs, geom)
    ends = torch.cumsum(entries, 0, dtype=torch.int32)
    profiling.host_wait("bin.sizes")
    num_rows, num_entries, z_lo, z_hi = totals.tolist()
    if num_entries >= 2 ** 31:
        raise ValueError(f"{num_entries} table entries do not fit int32 "
                         "offsets")
    if num_entries == 0:
        return _empty_table(m, tiles_total, num_rows, entries, dev)
    z_min, zb, key_bits = _key_layout(0xFFFFFFFF - z_lo, z_hi, tiles_total)
    keys, points = binning_cuda.emit(inputs, geom, entries, ends, z_min, zb,
                                     num_entries)
    keys, points = binning_cuda.sort_pairs(keys, points, key_bits)
    sorted_tile, tile_start, tile_count = binning_cuda.ranges(
        keys, zb, tiles_total)
    return _table(points, sorted_tile, tile_start, tile_count, entries,
                  num_rows, num_entries)


def _table_by_keys_plain(ndc, view_z, inv_cov2d, opacity, valid_mask,
                         img_h: int, img_w: int, tile_h: int, tile_w: int):
    """The plain PyTorch version of the ``'keys'`` route, for CPU tensors:
    the same count, emit order, key, stable sort (one ``torch.sort``) and
    ranges, the row walk in tensor ops over every (point, row) pair."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    dev = ndc.device
    m = ndc.shape[-1]
    tiles_x = math.ceil(img_w / tile_w)
    tiles_total = tiles_x * math.ceil(img_h / tile_h)
    if m == 0:
        return _empty_table(0, tiles_total, 0, None, dev)
    _, q, rect_min_x, rect_max_x, row_min_y, n_rows = _point_rows(
        ndc, view_z, inv_cov2d, opacity, valid_mask, img_h, img_w, tile_h,
        tile_w)
    # count: each point's rows, then each row's tiles
    row_pt = torch.repeat_interleave(torch.arange(m, device=dev), n_rows)
    first_row = torch.cumsum(n_rows, 0) - n_rows
    row_int = torch.stack([rect_min_x, rect_max_x, row_min_y,
                           view_z.view(torch.int32)])[:, row_pt]
    row_y = (row_int[2] + torch.arange(row_pt.shape[0], device=dev)
             - first_row[row_pt]).to(torch.int32)
    min_tile_x, row_tiles = tile_counts_for_rows(
        *torch.stack(q)[:, row_pt], row_y.float(), float(tile_h),
        float(tile_w), row_int[0], row_int[1])
    entries = torch.zeros(m, dtype=torch.int32, device=dev).index_add_(
        0, row_pt, row_tiles)
    z_bits = view_z.view(torch.int32).long()
    emitting = entries > 0
    sizes = torch.stack([
        n_rows.sum(), entries.sum(),
        torch.where(emitting, z_bits, 0xFFFFFFFF).min(),
        torch.where(emitting, z_bits, 0).max()])
    profiling.host_wait("bin.sizes")
    num_rows, num_entries, z_lo, z_hi = sizes.tolist()
    if num_entries == 0:
        return _empty_table(m, tiles_total, num_rows, entries, dev)
    z_min, zb, _ = _key_layout(z_lo, z_hi, tiles_total)
    # emit: point by point, each point's rows top to bottom, each row's
    # tiles left to right; entry k of a row is its first tile plus k, so
    # its key is the row's key for k = 0 plus k << zb
    ent_row = torch.repeat_interleave(
        torch.arange(num_rows, device=dev), row_tiles,
        output_size=num_entries)
    first_ent = torch.cumsum(row_tiles, 0) - row_tiles
    row_key = ((row_y * tiles_x + min_tile_x - first_ent).long() << zb
               | (row_int[3].long() - z_min))
    ent_key = row_key[ent_row] + (torch.arange(num_entries, device=dev)
                                  << zb)
    keys, order = torch.sort(ent_key, stable=True)
    ent_pt = row_pt[ent_row[order]].to(torch.int32)
    # ranges: where each tile's run starts and ends in the sorted keys
    sorted_tile = (keys >> zb).to(torch.int32)
    tiles = torch.arange(tiles_total, dtype=torch.int32, device=dev)
    tile_start = torch.searchsorted(sorted_tile, tiles, out_int32=True)
    tile_end = torch.searchsorted(sorted_tile, tiles, right=True,
                                  out_int32=True)
    return _table(ent_pt, sorted_tile, tile_start, tile_end - tile_start,
                  entries, num_rows, num_entries)


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
      stream: the route.  None (the default) means ``'keys'`` while
        ``config.BINNING_STREAM`` is on: the count, emit, sort and ranges
        kernels of ``ops/binning_cuda`` on CUDA tensors, their plain
        version on CPU tensors, one host read.  The other routes run the two expansions:
        True or ``'window'`` both through ``expand_attrs_windowed``,
        ``'async'`` through its ``dma=True`` kernel, ``'prefix'`` the first
        through ``expand_attrs`` (the depth key sorts the points that emit
        no row to the tail, so its prefix contract holds there), False
        through :func:`expand_with_table`; the stream_gather wrappers take
        their plain versions on CPU tensors.  A window overrun raises.
        Every route returns the same table.
    """
    route = stream_route(stream)
    if route == "keys":
        keyed = (_table_by_keys if ndc.is_cuda else _table_by_keys_plain)
        return keyed(ndc, view_z, inv_cov2d, opacity, valid_mask, img_h,
                     img_w, tile_h, tile_w)
    dev = ndc.device
    m = ndc.shape[-1]
    tiles_x = math.ceil(img_w / tile_w)
    tiles_total = tiles_x * math.ceil(img_h / tile_h)
    visible, q, rect_min_x, rect_max_x, row_min_y, n_rows = _point_rows(
        ndc, view_z, inv_cov2d, opacity, valid_mask, img_h, img_w, tile_h,
        tile_w)
    px, py, a_s, b, c_s, t_s, disc_s = q

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
    return _table(sorted_point, sorted_tile, tile_start, tile_count,
                  point_counts, num_rows, num_entries)


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
