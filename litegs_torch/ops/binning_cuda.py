"""Binning kernels on the card: the wrappers of ``csrc/binning.cu``.

The ``'keys'`` route of :func:`litegs_torch.ops.binning.build_tile_table`
runs them on CUDA tensors, around one scan and one stable sort:

=================  ====================================================
function           kernel
=================  ====================================================
count              bin_count_kernel: every point's entry count, the row
                   and entry totals and the emitting points' view-z range
emit               bin_emit_kernel: every entry's (tile, depth) key and
                   point id, at its point's offset
sort_pairs         bin_sort_count_kernel and bin_sort_scatter_kernel,
                   once each per 8 key bits: a stable LSD radix sort
ranges             bin_ranges_kernel: each tile's start and count in the
                   sorted keys, and the int32 tile column
=================  ====================================================

They replace no Pallas kernel (see the source); their plain version is
``binning._table_by_keys_plain``, the whole route in tensor ops, which CPU
tensors take.  Each wrapper launches its kernel on the current stream or
raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _kernels

# kernel launches by kernel, so a run can show which route it took
LAUNCHES = {"bin_count_kernel": 0, "bin_emit_kernel": 0,
            "bin_sort_count_kernel": 0, "bin_sort_scatter_kernel": 0,
            "bin_ranges_kernel": 0}
# entries a block of the sort takes (csrc/binning.cu kSortTile), and the
# key bits a pass sorts
SORT_TILE = 4096
DIGIT_BITS = 8


def reset_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class Geometry(NamedTuple):
    img_h: int
    img_w: int
    tile_h: int
    tile_w: int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _kernels.library("binning")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.litegs_bin_count.argtypes = [p] + [i] * 5 + [p] * 3
    lib.litegs_bin_emit.argtypes = ([p] + [i] * 5 + [p] * 2
                                    + [ctypes.c_uint, i] + [p] * 3)
    lib.litegs_bin_sort_count.argtypes = [p, i, i, p, p]
    lib.litegs_bin_sort_scatter.argtypes = [p, p, i, i] + [p] * 5
    lib.litegs_bin_ranges.argtypes = [p, i, i, i] + [p] * 4
    for fn in (lib.litegs_bin_count, lib.litegs_bin_emit,
               lib.litegs_bin_sort_count, lib.litegs_bin_sort_scatter,
               lib.litegs_bin_ranges):
        fn.restype = i
    lib.litegs_error_string.argtypes = [i]
    lib.litegs_error_string.restype = ctypes.c_char_p
    return lib


def _launch(kernel: str, fn_name: str, *args):
    lib = _lib()
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           + lib.litegs_error_string(rc).decode())
    LAUNCHES[kernel] += 1


def _stream(dev) -> int:
    return torch._C._cuda_getCurrentRawStream(dev.index)


def point_inputs(ndc, view_z, inv_cov2d, opacity, valid_mask):
    """The kernels' eight [M] inputs as contiguous rows: ndc x and y, view
    z, the inverse covariance's a, b and c, opacity (float32) and valid
    (bool).  Raises on what the kernels do not take."""
    m = view_z.shape[-1]
    dev = view_z.device
    if dev.type != "cuda":
        raise ValueError(f"binning kernels: tensors on {dev}, expected a "
                         "CUDA device")
    rows = (ndc[0], ndc[1], view_z, inv_cov2d[0], inv_cov2d[1],
            inv_cov2d[2], opacity, valid_mask)
    for k, t in enumerate(rows):
        want = torch.bool if k == 7 else torch.float32
        if t.dtype != want:
            raise TypeError(f"binning kernels: input {k} has dtype "
                            f"{t.dtype}, expected {want}")
        if tuple(t.shape) != (m,) or t.device != dev:
            raise ValueError(f"binning kernels: input {k} has shape "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"({m},) on {dev}")
    return tuple(t.contiguous() for t in rows)


def _pointers(inputs):
    return (ctypes.c_void_p * 8)(*[t.data_ptr() for t in inputs])


def count(inputs, geom: Geometry):
    """(entries [M] int32, totals [4] int64) of M > 0 points; totals holds
    the row and entry totals, 0xffffffff less the least view-z bits of a
    point with entries and the most (0 and 0 where no point has one)."""
    m = inputs[0].shape[0]
    dev = inputs[0].device
    entries = torch.empty(m, dtype=torch.int32, device=dev)
    totals = torch.zeros(4, dtype=torch.int64, device=dev)
    _launch("bin_count_kernel", "litegs_bin_count", _pointers(inputs), m,
            *geom, entries.data_ptr(), totals.data_ptr(), _stream(dev))
    return entries, totals


def emit(inputs, geom: Geometry, entries, ends, z_min: int, zb: int,
         num_entries: int):
    """(keys [E] int64, points [E] int32) of the ``num_entries`` > 0
    entries: point p's at ``[ends[p] - entries[p], ends[p])``, row by row,
    each key ``tile << zb | (view-z bits - z_min)``.  ``ends`` is the
    int32 inclusive scan of ``entries``."""
    m = inputs[0].shape[0]
    dev = inputs[0].device
    keys = torch.empty(num_entries, dtype=torch.int64, device=dev)
    points = torch.empty(num_entries, dtype=torch.int32, device=dev)
    _launch("bin_emit_kernel", "litegs_bin_emit", _pointers(inputs), m,
            *geom, entries.data_ptr(), ends.data_ptr(), z_min, zb,
            keys.data_ptr(), points.data_ptr(), _stream(dev))
    return keys, points


def sort_pairs(keys, points, key_bits: int):
    """(keys, points) of E > 0 pairs sorted stably by the keys' low
    ``key_bits`` bits (the rest zero), 8 bits a pass: each pass counts
    every 4096-entry tile's digits, scans the digit-major counts and
    scatters.  The inputs are overwritten."""
    e = keys.shape[0]
    dev = keys.device
    counts = torch.empty(-(-e // SORT_TILE) << DIGIT_BITS, dtype=torch.int32,
                         device=dev)
    src = (keys, points)
    dst = (torch.empty_like(keys), torch.empty_like(points))
    stream = _stream(dev)
    for shift in range(0, key_bits, DIGIT_BITS):
        _launch("bin_sort_count_kernel", "litegs_bin_sort_count",
                src[0].data_ptr(), e, shift, counts.data_ptr(), stream)
        ends = torch.cumsum(counts, 0, dtype=torch.int32)
        _launch("bin_sort_scatter_kernel", "litegs_bin_sort_scatter",
                src[0].data_ptr(), src[1].data_ptr(), e, shift,
                counts.data_ptr(), ends.data_ptr(), dst[0].data_ptr(),
                dst[1].data_ptr(), stream)
        src, dst = dst, src
    return src


def ranges(sorted_keys, zb: int, tiles_total: int):
    """(sorted_tile [E] int32, tile_start [T] int32, tile_count [T] int32)
    of E > 0 sorted keys, each ``tile << zb | depth``."""
    e = sorted_keys.shape[0]
    dev = sorted_keys.device
    sorted_tile = torch.empty(e, dtype=torch.int32, device=dev)
    tile_start = torch.empty(tiles_total, dtype=torch.int32, device=dev)
    tile_count = torch.zeros(tiles_total, dtype=torch.int32, device=dev)
    _launch("bin_ranges_kernel", "litegs_bin_ranges", sorted_keys.data_ptr(),
            e, zb, tiles_total, sorted_tile.data_ptr(), tile_start.data_ptr(),
            tile_count.data_ptr(), _stream(dev))
    return sorted_tile, tile_start, tile_count
