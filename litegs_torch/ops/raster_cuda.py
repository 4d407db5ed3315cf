"""Raster kernels on the card: the wrappers of ``csrc/raster_fwd.cu`` and
``csrc/raster_bwd.cu`` (their shared parts in ``csrc/raster_common.cuh``).

:func:`raster_forward` replaces ``litegs_tpu/ops/raster_pallas.py::
_fwd_kernel`` (launched by ``raster_forward_pallas``).  The kernel runs one
thread block per tile, one pixel per thread and an 8x4 pixel block per
warp, and walks the tile's depth-sorted entries of the exact binning
table front to back (see the source for the blend).  What bounds it on
the H100: the FP32 and exp work per (entry, pixel) pair -- about fifteen
operations and one exponential for each pair walked -- while the bytes it
moves are small (each entry's ten attribute words, each pixel's output
once).  Each batch of entries is staged once per tile in shared memory as
16-byte records with a per-warp cull mask: a warp skips the entries whose
alpha >= 1/256 region cannot reach its pixels (:func:`warp_block_visible`
is the plain version of that test), and stops as soon as its pixels have
saturated (T <= 1/8192).

:func:`raster_backward` replaces ``raster_pallas.py::_bwd_kernel``
(launched by ``raster_backward_pallas``), reduced to points. Same grid,
records and cull, two pixels of one column per thread and an 8x8 pixel
block per warp (the pixels share the entry's loads and dx terms); each
pixel re-walks its entries in forward order with its cotangent and forms
each pair's partial gradients directly. What bounds it: the reduction of
each entry's 9-13 partial sums across the tile's pixels and their atomic
adds into the per-point outputs, then the per-pair FP32 work. The kernel
reduces each touched entry across a warp by one reduce-scatter butterfly
(16 shuffles), across warps by shared-memory atomics, and adds each entry
into a point-major ``[M, KP]`` array with 16-byte vector atomics; the
wrapper transposes that array into the ``[K, M]`` rows of
:class:`PointGrads`.

The tables are validated once per table by :func:`check_table` (a host
wait), not per launch: the autograd Function of ``ops/raster`` checks each
table in its forward and passes ``table_checked=True`` to both kernels.

On a CPU tensor each wrapper computes the same function with its plain
PyTorch version (:func:`raster_forward_plain`,
:func:`raster_backward_plain`); on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import profiling
from . import _kernels, raster_plain
from .raster_plain import (PointGrads, raster_backward_reference,
                           rasterize_reference)

# kernel launches by raster_forward / raster_backward, so a run can show
# the kernels ran
LAUNCHES = 0
LAUNCHES_BWD = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _kernels.library("raster_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.litegs_raster_forward.argtypes = [p] * 12 + [i] * 7 + [p]
    lib.litegs_raster_forward.restype = i
    lib.litegs_raster_forward_takes.argtypes = [i, i]
    lib.litegs_raster_forward_takes.restype = i
    lib.litegs_error_string.argtypes = [i]
    lib.litegs_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    lib = _kernels.library("raster_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.litegs_raster_backward.argtypes = [p] * 12 + [i] * 8 + [p]
    lib.litegs_raster_backward.restype = i
    for fn in (lib.litegs_raster_backward_row,
               lib.litegs_raster_backward_takes):
        fn.argtypes = [i, i]
        fn.restype = i
    lib.litegs_error_string.argtypes = [i]
    lib.litegs_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_table(sorted_point, tile_start, tile_count, m: int):
    """Tile runs inside the table and point ids inside [0, M): the kernels
    index with them unchecked.  One host wait."""
    if tile_start.numel() == 0:
        return
    profiling.host_wait("raster.check_table")
    e = sorted_point.numel()
    vals = [torch.minimum(tile_start.min(), tile_count.min()).long(),
            (tile_start.long() + tile_count.long()).max()]
    if e:
        vals += [sorted_point.min().long(), sorted_point.max().long()]
    v = torch.stack(vals).tolist()
    if v[0] < 0 or v[1] > e:
        raise ValueError(f"tile runs reach outside the {e}-entry table")
    if e and (v[2] < 0 or v[3] >= m):
        raise ValueError(f"point ids outside [0, {m})")


# the per-warp cull of both kernels (csrc/raster_common.cuh): the form's
# a and c shrunk by CULL_SHRINK, the level raised by CULL_SLACK (1 + |t|),
# the box widened by CULL_MARGIN_PX
CULL_SHRINK = 1.0 - 1.0 / 256.0
CULL_SLACK = 1.0 / 256.0
CULL_MARGIN_PX = 1.0 / 16.0


def warp_block_visible(mean_pix, inv_cov, opacity, x0, y0, x1, y1):
    """The plain version of the kernels' per-warp cull.

    For entries with float32 attributes mean_pix [2, N], inv_cov [3, N],
    opacity [N] and a block of pixel centres [x0, x1] x [y0, y1] (integer
    coordinates, inclusive), returns bool [N]: False where the kernels
    skip the entry for a warp owning that block.  The test is meant to be
    conservative -- False only where every pixel of the block has
    alpha_raw < 1/256 (or NaN) -- with the rounding margins of
    ``csrc/raster_common.cuh``: the bounding box of the alpha >= 1/256
    region of a form with a and c shrunk by 1/256, at a level raised by
    (1 + |t|) / 256, widened by 1/16 pixel.  Kept everywhere: a form that
    is not positive definite after the shrink, or a box that is not
    finite; culled everywhere: opacity < 1/256 on a positive-definite form.
    """
    mx, my = mean_pix[0], mean_pix[1]
    a, b, c = inv_cov[0], inv_cov[1], inv_cov[2]
    a_s, c_s = a * CULL_SHRINK, c * CULL_SHRINK
    det = a_s * c_s - b * b
    definite = (a > 0) & (c > 0) & (det > 0)
    faint = opacity < raster_plain.ALPHA_MIN
    t = 2.0 * torch.log(256.0 * opacity)
    tau = t + CULL_SLACK * (1.0 + t.abs())
    rx = torch.sqrt(tau * c_s / det) + CULL_MARGIN_PX
    ry = torch.sqrt(tau * a_s / det) + CULL_MARGIN_PX
    finite = (rx < 1e30) & (ry < 1e30)
    hit = (mx + rx >= x0) & (mx - rx <= x1) & (my + ry >= y0) & (my - ry <= y1)
    return ~definite | (~faint & (~finite | hit))


def _check_launch(mean_pix, inv_cov, color, opacity, sorted_point,
                  tile_start, tile_count, tiles_x: int, tile_h: int,
                  tile_w: int, tiles_y: int = 0):
    """The per-launch checks both kernels share: dtype, shape, device,
    contiguity and the tile geometry (a merged grid, ``tiles_y > 0``, holds
    whole views of ``tiles_x * tiles_y`` tiles).  Returns (device, C, M, T,
    P)."""
    if mean_pix.device.type != "cuda":
        raise ValueError(f"unsupported device {mean_pix.device}")
    dev = mean_pix.device
    nchan, m = color.shape
    tiles_total = tile_start.shape[0]
    npix = tile_h * tile_w
    if nchan not in (3, 4):
        raise ValueError(f"color has {nchan} channels; the kernels take 3 "
                         "or 4")
    if not 0 < npix <= 1024:
        raise ValueError(f"tile {tile_h}x{tile_w} exceeds 1024 pixels")
    if tiles_y < 0:
        raise ValueError(f"tiles_y={tiles_y} is negative")
    view_tiles = tiles_x * tiles_y if tiles_y else tiles_x
    if view_tiles <= 0 or tiles_total % view_tiles:
        raise ValueError(f"{tiles_total} tiles is not a multiple of "
                         f"tiles_x={tiles_x}"
                         + (f" * tiles_y={tiles_y}" if tiles_y else ""))
    f32, i32 = torch.float32, torch.int32
    _check("mean_pix", mean_pix, f32, (2, m), dev)
    _check("inv_cov", inv_cov, f32, (3, m), dev)
    _check("color", color, f32, (nchan, m), dev)
    _check("opacity", opacity, f32, (m,), dev)
    _check("sorted_point", sorted_point, i32, sorted_point.shape, dev)
    _check("tile_start", tile_start, i32, (tiles_total,), dev)
    _check("tile_count", tile_count, i32, (tiles_total,), dev)
    if sorted_point.dim() != 1:
        raise ValueError("sorted_point must be 1-D")
    return dev, nchan, m, tiles_total, npix


def _check_tile(takes, tile_h: int, tile_w: int):
    if not takes(tile_h, tile_w):
        raise ValueError(f"tile {tile_h}x{tile_w}: the kernels take tiles "
                         "of at most 1024 pixels made of whole warp blocks "
                         "(8 or 16 columns wide)")


def raster_forward(mean_pix, inv_cov, color, opacity, sorted_point,
                   tile_start, tile_count, tiles_x: int, tile_h: int,
                   tile_w: int, walked=None, evaluated=None,
                   contributing=None, table_checked: bool = False,
                   tiles_y: int = 0):
    """Blend each tile's entries; tile layout out.

    Args:
      mean_pix [2, M], inv_cov [3, M], color [C, M] (C = 3 or 4),
      opacity [M]: float32 per-point attributes.
      sorted_point [E], tile_start [T], tile_count [T]: int32 binning
        table; tile t blends entries tile_start[t] .. + tile_count[t] - 1.
      walked, evaluated, contributing: optional int32 [T, P] tensors (CUDA
        only; for measuring the work a frame needs).  walked receives, per
        pixel, the entries up to and including its stop (or the tile's
        count), whether the per-warp cull skipped them or not; evaluated
        the pairs among them that the cull did not skip; contributing the
        pairs among them with alpha >= 1/256, which the blend takes.
      table_checked: the caller has run :func:`check_table` on this table.
      tiles_y: 0 for one view; on a merged grid of several views (view v's
        tiles at [v T, (v + 1) T), ``binning.concat_tables``) each view's
        tile rows, modulo which the tile row wraps.
    Returns (tiles_color [T, C, P], tiles_trans [T, P]); a tile with no
    entries comes out with colour 0 and transmittance 1.
    """
    if mean_pix.device.type == "cpu":
        if (walked, evaluated, contributing) != (None, None, None):
            raise ValueError("walked, evaluated and contributing are only "
                             "produced by the CUDA kernel")
        return raster_forward_plain(mean_pix, inv_cov, color, opacity,
                                    sorted_point, tile_start, tile_count,
                                    tiles_x, tile_h, tile_w,
                                    tiles_y=tiles_y)
    global LAUNCHES
    dev, nchan, m, tiles_total, npix = _check_launch(
        mean_pix, inv_cov, color, opacity, sorted_point, tile_start,
        tile_count, tiles_x, tile_h, tile_w, tiles_y)
    lib = _lib()
    _check_tile(lib.litegs_raster_forward_takes, tile_h, tile_w)
    if not table_checked:
        check_table(sorted_point, tile_start, tile_count, m)
    counts = {"walked": walked, "evaluated": evaluated,
              "contributing": contributing}
    for name, t in counts.items():
        if t is not None:
            _check(name, t, torch.int32, (tiles_total, npix), dev)
    out_color = torch.empty((tiles_total, nchan, npix), dtype=torch.float32,
                            device=dev)
    out_trans = torch.empty((tiles_total, npix), dtype=torch.float32,
                            device=dev)
    rc = lib.litegs_raster_forward(
        mean_pix.data_ptr(), inv_cov.data_ptr(), color.data_ptr(),
        opacity.data_ptr(), sorted_point.data_ptr(), tile_start.data_ptr(),
        tile_count.data_ptr(), out_color.data_ptr(), out_trans.data_ptr(),
        *(None if t is None else t.data_ptr() for t in counts.values()),
        m, nchan, tiles_total, tiles_x, tiles_y, tile_h, tile_w,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("raster forward kernel launch failed: "
                           + lib.litegs_error_string(rc).decode())
    LAUNCHES += 1
    return out_color, out_trans


def raster_backward(mean_pix, inv_cov, color, opacity, sorted_point,
                    tile_start, tile_count, tiles_x: int, tile_h: int,
                    tile_w: int, tiles_color, tiles_trans, d_tiles_color,
                    d_tiles_trans, with_stats: bool = False,
                    table_checked: bool = False,
                    tiles_y: int = 0) -> PointGrads:
    """Per-point gradients of :func:`raster_forward`, and optionally its
    fragment statistics.

    Args:
      the forward's inputs and table, as :func:`raster_forward` takes them;
      tiles_color [T, C, P], tiles_trans [T, P]: the forward's outputs;
      d_tiles_color [T, C, P], d_tiles_trans [T, P]: their cotangents;
      with_stats: also return weight_sum, frag_count and err_square_sum;
      tiles_y: as :func:`raster_forward` takes it.
    Returns raster_plain.PointGrads.
    """
    if mean_pix.device.type == "cpu":
        return raster_backward_plain(
            mean_pix, inv_cov, color, opacity, sorted_point, tile_start,
            tile_count, tiles_x, tile_h, tile_w, tiles_color, tiles_trans,
            d_tiles_color, d_tiles_trans, with_stats=with_stats,
            tiles_y=tiles_y)
    global LAUNCHES_BWD
    dev, nchan, m, tiles_total, npix = _check_launch(
        mean_pix, inv_cov, color, opacity, sorted_point, tile_start,
        tile_count, tiles_x, tile_h, tile_w, tiles_y)
    lib = _lib_bwd()
    _check_tile(lib.litegs_raster_backward_takes, tile_h, tile_w)
    if not table_checked:
        check_table(sorted_point, tile_start, tile_count, m)
    for name, t in (("tiles_color", tiles_color),
                    ("d_tiles_color", d_tiles_color)):
        _check(name, t, torch.float32, (tiles_total, nchan, npix), dev)
    for name, t in (("tiles_trans", tiles_trans),
                    ("d_tiles_trans", d_tiles_trans)):
        _check(name, t, torch.float32, (tiles_total, npix), dev)
    rows = nchan + 6 + (3 if with_stats else 0)
    # the kernel adds each entry's columns into one point-major row
    point_major = torch.zeros(
        (m, lib.litegs_raster_backward_row(nchan, int(with_stats))),
        dtype=torch.float32, device=dev)
    rc = lib.litegs_raster_backward(
        mean_pix.data_ptr(), inv_cov.data_ptr(), color.data_ptr(),
        opacity.data_ptr(), sorted_point.data_ptr(), tile_start.data_ptr(),
        tile_count.data_ptr(), tiles_color.data_ptr(), tiles_trans.data_ptr(),
        d_tiles_color.data_ptr(), d_tiles_trans.data_ptr(),
        point_major.data_ptr(),
        m, nchan, int(with_stats), tiles_total, tiles_x, tiles_y, tile_h,
        tile_w, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("raster backward kernel launch failed: "
                           + lib.litegs_error_string(rc).decode())
    LAUNCHES_BWD += 1
    grads = point_major[:, :rows].t().contiguous()
    c = nchan
    out = PointGrads(d_mean=grads[c:c + 2], d_inv_cov=grads[c + 2:c + 5],
                     d_color=grads[:c], d_opacity=grads[c + 5])
    if with_stats:
        out = out._replace(weight_sum=grads[c + 6], frag_count=grads[c + 7],
                           err_square_sum=grads[c + 8])
    return out


def _tile_groups(tile_start, tile_count, max_entries: int,
                 view_tiles: int = 0):
    """Split the non-empty tiles into groups of at most ``max_entries``
    entries (a single tile may exceed it).  Yields, per group, (tiles,
    entries, sub_tile, sub_start): the group's tile ids, the table slots of
    its entries in order, each entry's tile, and each tile's start in the
    group's sub-table (a [T] vector).

    ``view_tiles`` > 0: the grid is a merged grid of views of that many
    tiles each, and no group straddles two views, so each view is split
    and computed exactly as it is alone."""
    dev = tile_start.device
    tiles_total = tile_start.shape[0]
    counts = tile_count.long()
    starts = tile_start.long()
    profiling.host_wait("raster.groups")
    nonempty = torch.nonzero(counts > 0).flatten()
    bounds = [0, nonempty.numel()]
    if view_tiles:
        edges = torch.arange(view_tiles, tiles_total, view_tiles, device=dev)
        profiling.host_wait("raster.groups")
        bounds[1:1] = torch.searchsorted(nonempty, edges).tolist()
    for first, end in zip(bounds[:-1], bounds[1:]):
        view = nonempty[first:end]
        if view.numel() == 0:
            continue
        profiling.host_wait("raster.groups")
        cum = torch.cumsum(counts[view], 0).cpu()
        cuts = [0]
        while cuts[-1] < len(cum):
            done = int(cum[cuts[-1] - 1]) if cuts[-1] else 0
            nxt = int(torch.searchsorted(cum, done + max_entries,
                                         right=True))
            cuts.append(max(nxt, cuts[-1] + 1))
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            tiles = view[lo:hi]
            cnt = counts[tiles]
            seg_start = torch.cumsum(cnt, 0) - cnt
            # the sum and three repeat_interleave without output_size
            profiling.host_wait("raster.groups", 4)
            n = int(cnt.sum())
            rank = torch.arange(n, device=dev) - torch.repeat_interleave(
                seg_start, cnt)
            sub_tile = torch.repeat_interleave(tiles, cnt)
            entries = torch.repeat_interleave(starts[tiles], cnt) + rank
            sub_start = torch.zeros(tiles_total, dtype=torch.long,
                                    device=dev)
            sub_start[tiles] = seg_start
            yield tiles, entries, sub_tile, sub_start


def raster_forward_plain(mean_pix, inv_cov, color, opacity, sorted_point,
                         tile_start, tile_count, tiles_x: int, tile_h: int,
                         tile_w: int, max_entries: int = 1 << 20,
                         tiles_y: int = 0):
    """The plain PyTorch version of :func:`raster_forward`.

    Takes the same table (tiles may own any runs of ``sorted_point``) and
    calls ``raster_plain.rasterize_reference`` without autograd, on groups
    of whole tiles of at most ``max_entries`` entries each so that its
    [E, P] intermediates stay bounded.  On a merged grid (``tiles_y`` > 0)
    the groups stay within one view, so each view comes out bit for bit
    as it does alone, as the kernel's blocks compute each tile alone.
    """
    dev = mean_pix.device
    tiles_total = tile_start.shape[0]
    npix = tile_h * tile_w
    nchan = color.shape[0]
    tiles_color = torch.zeros((tiles_total, nchan, npix), dtype=color.dtype,
                              device=dev)
    tiles_trans = torch.ones((tiles_total, npix), dtype=color.dtype,
                             device=dev)
    with torch.no_grad():
        for tiles, entries, sub_tile, sub_start in _tile_groups(
                tile_start, tile_count, max_entries, tiles_x * tiles_y):
            out = rasterize_reference(
                mean_pix, inv_cov, color, opacity, sorted_point[entries],
                sub_tile, torch.ones(len(entries), dtype=torch.bool,
                                     device=dev),
                sub_start, tiles_total, tiles_x, tile_h, tile_w, tiles_y)
            tiles_color[tiles] = out.tiles_color[tiles]
            tiles_trans[tiles] = out.tiles_trans[tiles]
    return tiles_color, tiles_trans


def raster_backward_plain(mean_pix, inv_cov, color, opacity, sorted_point,
                          tile_start, tile_count, tiles_x: int, tile_h: int,
                          tile_w: int, tiles_color, tiles_trans,
                          d_tiles_color, d_tiles_trans,
                          with_stats: bool = False,
                          max_entries: int = 1 << 18,
                          tiles_y: int = 0) -> PointGrads:
    """The plain PyTorch version of :func:`raster_backward`.

    Calls ``raster_plain.raster_backward_reference`` on groups of whole
    tiles of at most ``max_entries`` entries each (within one view on a
    merged grid, as :func:`raster_forward_plain`) and sums the per-point
    results over the groups.
    """
    dev = mean_pix.device
    nchan, m = color.shape
    z = functools.partial(torch.zeros, dtype=color.dtype, device=dev)
    total = PointGrads(z((2, m)), z((3, m)), z((nchan, m)), z(m),
                       *((z(m), z(m), z(m)) if with_stats else ()))
    for _, entries, sub_tile, sub_start in _tile_groups(
            tile_start, tile_count, max_entries, tiles_x * tiles_y):
        part = raster_backward_reference(
            mean_pix, inv_cov, color, opacity, sorted_point[entries],
            sub_tile, torch.ones(len(entries), dtype=torch.bool, device=dev),
            sub_start, tile_start.shape[0], tiles_x, tile_h, tile_w,
            tiles_color, tiles_trans, d_tiles_color, d_tiles_trans,
            with_stats=with_stats, tiles_y=tiles_y)
        for acc, add in zip(total, part):
            if acc is not None:
                acc += add
    return total
