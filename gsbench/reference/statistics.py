"""Plain reference of LiteGS's per-primitive statistics
(litegs/utils/statistic_helper.py, summed inside the raster backward,
raster.cu:289-301, 779-820).

Over the views of a statistics epoch each primitive accumulates:

* ``visible_count``: the views in which it touches at least one tile;
* ``weight_sum``, ``weight_sq_sum``: the sum of its blend weights
  w = alpha T over its contributing (entry, pixel) pairs, a view's sum
  and that sum squared;
* ``err_sum``, ``err_sq_sum``: a view's sum over its pairs of the
  fragment error dL/d(power) / o (the pair's opacity gradient), and the
  sum of its squares;
* ``frag_count``: its contributing pairs;
* ``grad_norm_sum``: a view's ||dL/d mean2d|| in NDC units
  (pixel gradient times W / 2 and H / 2).

A pair contributes where its alpha is at least 1/256 and the pixel's
transmittance before it is above 1/8192.  The per-pair values come from
the blend of ``render.blend_block`` and autograd's gradient of the loss
with respect to the pair's unclamped alpha, straight through the 255/256
clamp, which is dL/d(power) / alpha_raw.

Departures from LiteGS: the sums run in float64 inside the blend and are
kept in float32 (``dtype``) per primitive of a fixed capacity; LiteGS
keeps its own tensors per live primitive.
"""
from __future__ import annotations

import torch

FIELDS = ("visible_count", "weight_sum", "weight_sq_sum", "err_sum",
          "err_sq_sum", "frag_count", "grad_norm_sum")


def zeros(capacity: int, device, dtype=torch.float32) -> dict:
    return {k: torch.zeros(capacity, dtype=dtype, device=device)
            for k in FIELDS}


def view_sums(m: int, device) -> torch.Tensor:
    """[4, m] per visible point: weight sum, contributing pairs, fragment
    error sum, its square sum."""
    return torch.zeros((4, m), dtype=torch.float32, device=device)


@torch.no_grad()
def add_pairs(sums, sp, raw, d_raw, weight, opacity):
    """Add one block's pairs to ``view_sums``: ``raw`` [P, E] each pair's
    unclamped alpha, ``d_raw`` the loss's gradient with respect to it,
    ``weight`` the pair's blend weight (0 where it does not contribute),
    ``opacity`` [M] the points' activated opacity."""
    err = d_raw * raw / torch.clamp(opacity[sp], min=1e-12)[None]
    per_entry = torch.stack([weight.sum(0), (weight > 0).sum(0).float(),
                             err.sum(0), (err * err).sum(0)])
    sums.index_add_(1, sp, per_entry.to(sums.dtype))


@torch.no_grad()
def add_view(stats: dict, chunk_ids, chunk: int, touched, sums, d_mean,
             img_h: int, img_w: int):
    """Add one view's statistics of its visible points (the chunks
    ``chunk_ids``, in order) to ``stats`` at their primitive index.
    ``touched`` [M] bool: the point has an entry in the view's table;
    ``d_mean`` [2, M] the loss's gradient with respect to the points'
    pixel means."""
    offs = torch.arange(chunk, device=chunk_ids.device)
    idx = (chunk_ids.long()[:, None] * chunk + offs).reshape(-1)
    ndc = torch.sqrt((d_mean[0] * (0.5 * img_w)) ** 2
                     + (d_mean[1] * (0.5 * img_h)) ** 2)
    view = {"visible_count": touched.float(), "weight_sum": sums[0],
            "weight_sq_sum": sums[0] ** 2, "err_sum": sums[2],
            "err_sq_sum": sums[3], "frag_count": sums[1],
            "grad_norm_sum": ndc}
    for k in FIELDS:
        stats[k].index_add_(0, idx, view[k].to(stats[k].dtype))
