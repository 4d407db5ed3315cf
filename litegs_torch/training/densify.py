"""Density control: score-based budgeted densification (TamingGS-style).

The port of ``litegs_tpu/training/densify.py`` (reference
litegs/training/densify.py) at a fixed primitive capacity:

* appends write into the inactive tail (at active_count + rank),
* prunes compact via a stable 3-way sort permutation
  (active-kept < pruned < inactive padding),
* multinomial-without-replacement sampling is Gumbel-top-k with a stable
  sort, so equal draws give the same selection as the JAX package.

Semantics preserved from DensityControllerTamingGS:
* budget = min(max(ramp_target - N, 1) + prune_num, N)  (densify.py:304-305)
* score = var(fragment_err) * frag_count * sigmoid(op)^2 (:286-292)
* split if max(exp(scale)) > percent_dense * screen_extent else clone
  (:309-310); split scale divided by 1.6, offset ~ N(0, S) rotated (:313-325)
* prune: blend-weight sum == 0 ('weight' mode, :273-284) or opacity
  threshold + never-visible ('threshold' mode, :113-119)
* append/prune counts trimmed to chunk multiples (:148-154, :203-210)
* opacity 'decay': op *= 0.5 clamped >= 1/128, ALL Adam state cleared
  (:229-232); 'reset': op clamped <= 0.005, opacity moments cleared (:233-235)

Random draws come from a ``torch.Generator`` (on the CPU, so a seed gives
the same draws on any device), or are passed in explicitly.  Every
function returns new tensors; ``active_count`` is a Python int.

Spans: ``densify_step`` runs in a span ``densify`` and ``spatial_refine``
in ``resort`` (children of the trainer's ``boundary``).  Every host read
is marked with ``profiling.host_wait`` under a site ``densify.*``: the
counts read back (``selected``, ``want``, ``prune_num``, ``n_prune``),
the copies of the draws to the device (``draws``) and the ids of the
appended primitives' sources (``copies``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import DensifyParams
from ..ops import projection
from ..scene.gaussians import GaussianModel
from ..scene.morton import spatial_sort_indices
from ..utils import profiling
from . import statistics
from .optimizer import AdamState


def densify_until_epoch(dp: DensifyParams, total_epochs: int) -> int:
    """Resolve densify_until < 0 (reference trainer.py:94-95)."""
    if dp.densify_until >= 0:
        return dp.densify_until
    return (int(total_epochs * 0.8 / dp.opacity_reset_interval)
            * dp.opacity_reset_interval + 1)


def model_device(params: GaussianModel, *args, **kwargs) -> torch.device:
    """The device of a span whose call's first argument is the model."""
    return params.xyz.device


def _take(params: GaussianModel, adam: AdamState, perm):
    """Permute every primitive (last axis) of the model and its moments."""
    return (params.mapped(lambda x: x[..., perm]),
            AdamState(*[{k: v[..., perm] for k, v in d.items()}
                        for d in adam]))


def get_prune_mask(params: GaussianModel, stats: statistics.StatsState,
                   active_mask, dp: DensifyParams):
    """Reference get_prune_mask (densify.py:273-284 / 113-119)."""
    if dp.prune_mode == "weight":
        mask = stats.weight_sum == 0.0
    else:
        opacity = torch.sigmoid(params.opacity.detach()[0])
        mask = opacity < dp.opacity_threshold
        mask |= stats.visible_count == 0
    return mask & active_mask


def get_score(params: GaussianModel, stats: statistics.StatsState,
              active_mask):
    """score = var(fragment_err) * count * sigmoid(op)^2 (densify.py:286-292)."""
    var = statistics.err_variance(stats)
    op = torch.sigmoid(params.opacity.detach()[0])
    score = torch.clamp(torch.nan_to_num(var * stats.frag_count * op * op),
                        min=0.0)
    return torch.where(active_mask, score, torch.zeros_like(score))


def taming_budget(prune_num: int, active_count: int, epoch: int,
                  dp: DensifyParams, densify_until: int,
                  init_points_num: int, chunk_size: int,
                  capacity: int) -> int:
    """Append budget: linear ramp to target (+ prune slack), chunk-trimmed
    (reference densify.py:304-305).  The ramp's distance is taken in
    float32, as the JAX package takes it."""
    span = max(densify_until - dp.densify_from, 1)
    cur_target = ((dp.target_primitives - init_points_num) / span
                  * (epoch - dp.densify_from) + init_points_num)
    gap = int((np.float32(cur_target) - np.float32(active_count))
              .astype(np.int32))
    budget = min(max(gap, 1) + prune_num, active_count)
    # never grow past capacity
    budget = min(budget, capacity - active_count)
    return (budget // chunk_size) * chunk_size


def taming_sample_keys(score, uniform):
    """Gumbel keys: top-k of these == multinomial without replacement
    (densify.py:308).  ``uniform``: [N] draws in [1e-10, 1)."""
    gumbel = -torch.log(-torch.log(uniform))
    return torch.where(score > 0, torch.log(score) + gumbel,
                       torch.full_like(score, -math.inf))


def draw_uniform(n: int, generator: torch.Generator, device):
    """[n] uniform draws in [1e-10, 1) from ``generator``."""
    profiling.host_wait("densify.draws")
    return torch.rand(n, generator=generator).clamp_(min=1e-10).to(device)


def draw_normal(n: int, generator: torch.Generator, device):
    """[3, n] standard normal draws from ``generator``."""
    profiling.host_wait("densify.draws")
    return torch.randn((3, n), generator=generator).to(device)


def split_and_clone(params: GaussianModel, adam: AdamState,
                    stats: statistics.StatsState, active_count: int,
                    epoch: int, dp: DensifyParams, densify_until: int,
                    init_points_num: int, screen_extent: float,
                    chunk_size: int, generator=None, uniform=None,
                    normal=None, selected=None):
    """Budgeted densification step (reference densify.py:294-363).

    Draws ``uniform`` [N] (taming selection) and ``normal`` [3, N] (split
    offsets) from ``generator`` unless they are given.  ``selected``: a
    precomputed [N] selection mask (the sharded selection of
    ``parallel.densify``), which takes the place of the selection here and
    of its draw, so both paths share this append tail.
    Returns (params, adam, active_count).
    """
    n = params.capacity
    dev = params.xyz.device
    idx = torch.arange(n, device=dev)
    active_mask = idx < active_count

    if selected is not None:
        profiling.host_wait("densify.selected")
        budget = int(selected.sum())
    elif dp.densify_mode == "official":
        # original-3DGS criterion: mean NDC positional-gradient norm over
        # the statistics window >= threshold (no primitive budget)
        want = ((statistics.mean_grad_norm(stats)
                 >= dp.densify_grad_threshold) & active_mask)
        profiling.host_wait("densify.want")
        budget = min(int(want.sum()), n - active_count)
        budget = (budget // chunk_size) * chunk_size
        rank_of = torch.cumsum(want.int(), 0) - 1
        selected = want & (rank_of < budget)
    else:
        profiling.host_wait("densify.prune_num")
        prune_num = int(get_prune_mask(params, stats, active_mask, dp).sum())
        budget = taming_budget(prune_num, active_count, epoch, dp,
                               densify_until, init_points_num, chunk_size, n)
        score = get_score(params, stats, active_mask)
        if uniform is None:
            uniform = draw_uniform(n, generator, dev)
        keys = taming_sample_keys(score, uniform)
        order = torch.sort(-keys, stable=True).indices
        rank_of = torch.empty_like(order)
        rank_of[order] = idx
        selected = (rank_of < budget) & (score > 0)

    if normal is None:
        normal = draw_normal(n, generator, dev)
    # the copies' sources in index order, never past the capacity
    profiling.host_wait("densify.copies")
    ids = torch.nonzero(selected).squeeze(1)[:n - active_count]
    p = {k: v.detach() for k, v in params.fields().items()}
    new = {k: v[..., ids] for k, v in p.items()}
    # split vs clone by world extent (densify.py:309-310)
    scale = torch.exp(new["scale"])
    is_split = scale.amax(dim=0) > dp.percent_dense * screen_extent
    # clones copy; splits offset by R @ (s * eps) and shrink scale by 1.6
    # (densify.py:313-325).  Computed over the copies alone, in the
    # reference's order of operations: the Morton resort after the event
    # turns a last-bit difference in a position into another order
    eps = normal[:, ids] * scale
    norm = torch.sqrt(torch.sum(new["rot"] ** 2, dim=0, keepdim=True))
    rot_unit = new["rot"] / torch.clamp(norm, min=1e-12)
    rot_m = projection.create_transform_matrix(torch.ones_like(eps),
                                               rot_unit)
    # row-vector convention: shift = eps_row @ M  (densify.py:318)
    shift = (eps[:, None] * rot_m).sum(0)
    new["xyz"] = torch.where(is_split, new["xyz"] + shift, new["xyz"])
    new["scale"] = torch.where(is_split, new["scale"] - math.log(1.6),
                               new["scale"])

    # appends go to the tail; fresh primitives get zero Adam moments
    slots = torch.arange(active_count, active_count + ids.numel(),
                         device=dev)
    params_out = GaussianModel(**{
        k: v.clone().index_copy_(v.dim() - 1, slots, new[k])
        for k, v in p.items()})
    adam_out = AdamState(*[{k: v.clone().index_fill_(v.dim() - 1, slots, 0.0)
                            for k, v in d.items()} for d in adam])
    # fewer than `budget` primitives may carry a positive score: floor
    # again so active_count stays a chunk multiple
    appended = (min(ids.numel(), budget) // chunk_size) * chunk_size
    return params_out, adam_out, active_count + appended


def prune(params: GaussianModel, adam: AdamState,
          stats: statistics.StatsState, active_count: int,
          dp: DensifyParams, chunk_size: int, stats_valid_count=None,
          prune_mask=None):
    """Compact pruned primitives out via a stable permutation (reference
    densify.py:138-157 + _prune_optimizer :72-98).

    stats_valid_count: primitives appended after the statistics were
    collected are not pruned (the reference's prune mask covers the
    pre-append prefix only, densify.py:278-280); they stay active.
    prune_mask: a precomputed [N] mask (the sharded path), in place of the
    one computed here from ``stats``.
    Returns (params, adam, active_count).
    """
    n = params.capacity
    idx = torch.arange(n, device=params.xyz.device)
    active_mask = idx < active_count
    prunable = active_mask
    if stats_valid_count is not None:
        prunable = prunable & (idx < stats_valid_count)
    if prune_mask is None:
        prune_mask = get_prune_mask(params, stats, prunable, dp)
    else:
        prune_mask = prune_mask & prunable
    # a run about to prune >80% of its primitives is broken (diverged
    # opacities / dead stats); the reference hard-asserts here
    # (densify.py:146-147)
    profiling.host_wait("densify.n_prune")
    n_prune = int(prune_mask.sum())
    n_active = max(active_count, 1)
    if n_prune > 0.8 * n_active:
        raise RuntimeError(
            f"densify prune would remove {n_prune}/{n_active} (>80%) of "
            "primitives -- aborting (reference densify.py:146-147)")
    # trim to a chunk multiple: only the first del_limit pruned primitives
    # are removed (densify.py:148-154)
    del_limit = (n_prune // chunk_size) * chunk_size
    prune_eff = prune_mask & (torch.cumsum(prune_mask.int(), 0) - 1
                              < del_limit)
    # stable 3-way partition: kept-active < pruned < inactive
    bucket = torch.where(active_mask, prune_eff.int(),
                         torch.full_like(idx, 2, dtype=torch.int32))
    perm = torch.sort(bucket, stable=True).indices
    params_out, adam_out = _take(params, adam, perm)
    return params_out, adam_out, active_count - del_limit


def reset_opacity(params: GaussianModel, adam: AdamState, dp: DensifyParams):
    """Opacity decay/reset (reference densify.py:224-237)."""
    op = torch.sigmoid(params.opacity.detach())
    decay = dp.opacity_reset_mode == "decay"
    if decay:
        new_op = torch.clamp(op * 0.5, min=1.0 / 128)
    else:
        new_op = torch.clamp(op, max=0.005)
    fields = {k: v.detach() for k, v in params.fields().items()}
    fields["opacity"] = torch.log(new_op / (1 - new_op))
    adam_out = AdamState(*[
        {k: torch.zeros_like(v) if decay or k == "opacity" else v
         for k, v in d.items()} for d in adam])
    return GaussianModel(**fields), adam_out


@profiling.spanned("resort", device=model_device)
def spatial_refine(params: GaussianModel, adam: AdamState,
                   active_count: int):
    """Morton resort of primitives + optimizer state
    (reference scene/point.py:86-154, invoked trainer.py:104-106), over
    the live primitives' own box; the inactive tail keeps its order."""
    n = params.capacity
    active_mask = torch.arange(n, device=params.xyz.device) < active_count
    perm = spatial_sort_indices(params.xyz.detach(), active_mask)
    return _take(params, adam, perm)


@profiling.spanned("densify", device=model_device)
def densify_step(params, adam, stats, active_count: int, epoch: int,
                 dp: DensifyParams, densify_until: int,
                 init_points_num: int, screen_extent: float,
                 chunk_size: int, generator=None):
    """Whole per-epoch density-control step (reference densify.py:246-260).

    Returns (params, adam, active_count, did_update).
    """
    did = False
    if dp.densify_from <= epoch < densify_until:
        if epoch % dp.densification_interval == 0:
            pre_append_count = active_count
            params, adam, active_count = split_and_clone(
                params, adam, stats, active_count, epoch, dp,
                densify_until, init_points_num, screen_extent, chunk_size,
                generator=generator)
            params, adam, active_count = prune(
                params, adam, stats, active_count, dp, chunk_size,
                stats_valid_count=pre_append_count)
            did = True
        if epoch % dp.opacity_reset_interval == 0:
            params, adam = reset_opacity(params, adam, dp)
            did = True
    return params, adam, active_count, did
