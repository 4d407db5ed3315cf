"""The work counts on tables counted by hand."""
import math

import pytest
import torch

from gsbench import work
from gsbench.reference import render as R


def _table(counts):
    """A table of ``counts[t]`` entries in tile t, entry i of point i."""
    n = sum(counts)
    tile = torch.repeat_interleave(torch.arange(len(counts)),
                                   torch.tensor(counts))
    count = torch.tensor(counts)
    return R.Table(torch.arange(n), tile, torch.cumsum(count, 0) - count,
                   count)


def _flat_points(n, opacity):
    """n points whose alpha is ``opacity`` at every pixel (inverse
    covariance 0)."""
    return (torch.full((2, n), 8.0), torch.zeros(3, n), torch.ones(3, n),
            torch.full((n,), opacity))


@pytest.mark.parametrize("counts,pairs,to_stop", [
    # alpha 3/4: T before entry k is 4^-k, above 1/8192 for k <= 6, so a
    # pixel takes 7 entries and stops
    ([20], 7 * 128, 7),
    # three entries never reach the stop; the second tile's ten stop at 7
    ([3, 10], 10 * 128, 10),
])
def test_contributing_pairs_and_entries_to_the_stop(counts, pairs, to_stop):
    table = _table(counts)
    pts = _flat_points(sum(counts), 0.75)
    _, _, got = R.blend_block(table, 0, len(counts), *pts, 16, 8,
                              len(counts), counts=True)
    assert got[:2] == (pairs, to_stop)
    # the points named by the walked entries: the first 7 of each tile
    starts = [sum(counts[:t]) for t in range(len(counts))]
    assert got[2].tolist() == [s + i for s, c in zip(starts, counts)
                               for i in range(min(c, 7))]


def test_faint_entries_are_walked_but_do_not_contribute():
    # alpha 1/512 < 1/256: no pair contributes, every entry is walked
    table = _table([5])
    pts = _flat_points(5, 1.0 / 512)
    _, _, got = R.blend_block(table, 0, 1, *pts, 16, 8, 1, counts=True)
    assert got[:2] == (0, 5) and got[2].tolist() == [0, 1, 2, 3, 4]


def test_binning_of_one_round_splat():
    # sigma 2 px at pixel (24, 12) of 64x32, opacity 1: radius
    # 2 sqrt(2 ln 255) = 6.66 px spans x 17.3-30.7 (tile column 1) and
    # y 5.3-18.7 (tile rows 0-2): tiles 1, 5 and 9 of the 4x4 grid
    ndc = torch.tensor([[(24.5 / 64 - 0.5) * 2], [(12.5 / 32 - 0.5) * 2]])
    inv = torch.tensor([[0.25], [0.0], [0.25]])
    p = R.Projected(ndc, torch.tensor([5.0]), torch.tensor([[24.0], [12.0]]),
                    inv)
    t = R.bin_tiles(p, torch.tensor([1.0]), 32, 64, 8, 16)
    assert t.tile.tolist() == [1, 5, 9]
    assert t.tile_count.tolist() == [0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0,
                                     0, 0, 0, 0]


def test_kernel_costs_by_hand():
    w = {"points": 10, "entries": 20, "tiles": 2, "tile_pixels": 256,
         "pairs": 100, "entries_to_stop": 5, "points_to_stop": 4}
    # 24 ops a pair and 20 an entry to the stop; 36 bytes a point those
    # entries name, 4 an entry to the stop, 8 a tile, 16 a tile pixel
    # (colour and transmittance)
    assert work.raster_fwd(w) == (2500, 144 + 20 + 16 + 4096)
    # 59 ops a pair; the outputs and their cotangents, and 9 gradient
    # columns of every visible point
    assert work.raster_bwd(w) == (6000, 144 + 20 + 16 + 8192 + 360)
    assert work.bound_s(67e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_step_operations_add_up():
    w = {"points": 1, "entries": 0, "tiles": 0, "tile_pixels": 0,
         "pairs": 0, "entries_to_stop": 0, "points_to_stop": 0, "pixels": 1}
    per_point = 3 * work.OPS_POINT_FWD + 12 * 59
    assert work.train_step_ops(w) == per_point + work.OPS_PIXEL_LOSS
    assert work.render_ops(w) == work.OPS_POINT_FWD
    assert math.isclose(work.OPS_PIXEL_LOSS, 3 * 3 * 241)
