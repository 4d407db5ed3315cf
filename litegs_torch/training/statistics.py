"""Per-primitive training statistics feeding densification.

The port of ``litegs_tpu/training/statistics.py`` (reference
StatisticsHelper, litegs/utils/statistic_helper.py).  Accumulates, per
primitive, over the iterations of a statistics epoch: the visible count,
the blend-weight sum and square sum, the opacity-gradient sum and square
sum, the fragment count and the NDC positional-gradient norm.  The scatter
from the visible-compacted axis back to the primitive axis is one
``index_add`` per field.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import profiling, resolve_device


class StatsState(NamedTuple):
    visible_count: torch.Tensor   # [N] int32
    weight_sum: torch.Tensor      # [N]
    weight_sq_sum: torch.Tensor   # [N]
    err_sum: torch.Tensor         # [N]
    err_sq_sum: torch.Tensor      # [N]
    frag_count: torch.Tensor      # [N]
    grad_norm_sum: torch.Tensor   # [N] accumulated ||d mean2d||_ndc


def init_stats(capacity: int, device="cuda") -> StatsState:
    device = resolve_device(device)

    def z():
        return torch.zeros(capacity, dtype=torch.float32, device=device)
    return StatsState(
        visible_count=torch.zeros(capacity, dtype=torch.int32, device=device),
        weight_sum=z(), weight_sq_sum=z(), err_sum=z(), err_sq_sum=z(),
        frag_count=z(), grad_norm_sum=z())


def global_indices(chunk_ids, chunk_size: int):
    """Visible-compacted slot -> global primitive index."""
    offs = torch.arange(chunk_size, device=chunk_ids.device)
    return (chunk_ids.long()[:, None] * chunk_size + offs).reshape(-1)


@torch.no_grad()
def update_stats(stats: StatsState, chunk_ids, valid_mask,
                 primitive_visible, raster_stats,
                 chunk_size: int) -> StatsState:
    """Accumulate one iteration's statistics.

    Args:
      chunk_ids: [Mv/chunk] visible chunk ids.
      valid_mask: [Mv] bool; slots where it is False are dropped.
      primitive_visible: [Mv] bool from binning.
      raster_stats: ops.raster.RasterStats over the compacted axis.
    """
    # each boolean mask's index is a nonzero: a host wait on the card
    profiling.host_wait("stats.mask")
    idx = global_indices(chunk_ids, chunk_size)[valid_mask]

    def add(acc, val):
        profiling.host_wait("stats.mask")
        return acc.index_add(0, idx, val[valid_mask].to(acc.dtype))

    rs = raster_stats
    return StatsState(
        visible_count=add(stats.visible_count, primitive_visible),
        weight_sum=add(stats.weight_sum, rs.weight_sum),
        weight_sq_sum=add(stats.weight_sq_sum, rs.weight_sum ** 2),
        err_sum=add(stats.err_sum, rs.err_sum),
        err_sq_sum=add(stats.err_sq_sum, rs.err_square_sum),
        frag_count=add(stats.frag_count, rs.frag_count),
        grad_norm_sum=add(stats.grad_norm_sum, rs.grad_norm),
    )


def err_variance(stats: StatsState):
    """var(fragment_err) per primitive (statistic_helper.py:225-240):
    E[x^2] - E[x]^2 with the reference's count+1 denominator, clamped >= 0.
    """
    denom = stats.frag_count + 1.0
    mean = stats.err_sum / denom
    mean_sq = stats.err_sq_sum / denom
    return torch.clamp(torch.nan_to_num(mean_sq - mean * mean), min=0.0)


def permute(stats: StatsState, perm) -> StatsState:
    return StatsState(*[x[perm] for x in stats])


def mean_grad_norm(stats: StatsState):
    """Mean per-iteration NDC positional-gradient norm (accumulated norms
    over times visible)."""
    return stats.grad_norm_sum / torch.clamp(
        stats.visible_count.float(), min=1.0)
