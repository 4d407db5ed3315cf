"""Sharded densification: statistics and selection spread over the ranks.

The port of ``litegs_tpu/parallel/densify.py``.  The per-primitive
statistics (seven [N] accumulators) and the selection's work shard over
the ranks; the parameters stay replicated, so the append and prune tail
(``training.densify.split_and_clone`` / ``prune`` with the masks
injected) runs identically on every rank from two all-gathered [N] masks.

Layout per rank (D ranks, capacity N, S = ceil(N / D)): the statistics
shard holds primitives [rank * S, rank * S + S) -- the last shard's tail
past N is padding that stays zero --; scores, keys and bisection counts
are computed on the shard; the selection and prune masks are gathered.

Both controller modes are ported, taming (budgeted Gumbel-top-k) and
official (gradient threshold).  The distributed top-k is exact: keys are
bisected in their order-preserving 32-bit image (32 rounds, one scalar
all-reduce each, no key gathered), with ties broken by the lowest global
index, so it equals the replicated stable ``sort(-keys)`` selection.
Every rank draws the same [N] uniform vector from its generator (seeded
alike on every rank) and takes its slice, so the sharded step equals the
replicated ``training.densify.densify_step`` bit for bit.
"""
from __future__ import annotations

import math

import torch

from ..config import DensifyParams
from ..training import densify as dens
from ..training import statistics
from . import add_packed, all_gather, collective, shard_len, world


def order_key_u32(x: torch.Tensor) -> torch.Tensor:
    """The monotone bijection float32 -> uint32 (IEEE-754 total order:
    positives get the sign bit set, negatives are bit-complemented), held
    in int64 because torch's uint32 arithmetic is thin.  Comparing keys
    compares the floats; -inf is lowest."""
    u = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)


def sharded_topk_mask(local_keys: torch.Tensor, budget: int) -> torch.Tensor:
    """Exact distributed top-``budget`` over float32 keys sharded by rank.

    Returns this rank's [n_local] bool mask; over all ranks exactly
    min(budget, #finite keys) are set, those of the stable
    ``argsort(-keys)[:budget]`` of the gathered keys (ties by the lowest
    global index; -inf is never selected).  32 bisection rounds find tau,
    the budget-th largest key's image: each round compares the shard once
    and all-reduces one count.
    """
    kord = order_key_u32(local_keys)
    dev = kord.device
    lo = torch.zeros(1, dtype=torch.int64, device=dev)
    hi = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    for _ in range(32):
        # the least v with count(keys > v) < budget
        mid = lo + (hi - lo) // 2
        cnt = collective("all_reduce", (kord > mid).sum().reshape(1))
        below = cnt < budget
        lo, hi = torch.where(below, lo, mid + 1), torch.where(below, mid, hi)
    tau = lo
    above = kord > tau
    n_above = collective("all_reduce", above.sum().reshape(1))
    need = torch.clamp(budget - n_above, min=0)
    at = kord == tau
    _, rank = world()
    per_shard = all_gather(at.sum().reshape(1))[:, 0]
    tie_rank = per_shard[:rank].sum() + torch.cumsum(at.long(), 0) - 1
    return (above | (at & (tie_rank < need))) & (local_keys > -math.inf)


def init_sharded_stats(capacity: int, device) -> statistics.StatsState:
    """This rank's zeroed [ceil(N / D)] statistics shard."""
    d, _ = world()
    return statistics.init_stats(shard_len(capacity, d), device)


def scatter_stats_update(stats_local: statistics.StatsState,
                         packed: torch.Tensor) -> statistics.StatsState:
    """Add every rank's [7, N] statistics delta (``parallel.pack_stats``)
    into this rank's shard: one reduce-scatter in place of the replicated
    all-reduce (D x less traffic and memory)."""
    d, _ = world()
    s = stats_local.weight_sum.shape[0]
    padded = torch.zeros((7, d * s), dtype=torch.float32,
                         device=packed.device)
    padded[:, :packed.shape[1]] = packed
    mine = collective("reduce_scatter",
                      padded.view(7, d, s).transpose(0, 1).reshape(-1),
                      padded.new_empty(7 * s))
    return add_packed(stats_local, mine.view(7, s))


def gather_stats(stats_local: statistics.StatsState,
                 capacity: int) -> statistics.StatsState:
    """The full [N] statistics from every rank's shard."""
    return statistics.StatsState(*[all_gather(x).reshape(-1)[:capacity]
                                   for x in stats_local])


def local_shard(full: statistics.StatsState) -> statistics.StatsState:
    """This rank's shard of full [N] statistics, padded with zeros."""
    d, rank = world()
    n = full.weight_sum.shape[0]
    s = shard_len(n, d)
    lo = min(rank * s, n)
    hi = min(lo + s, n)

    def cut(x):
        out = torch.zeros(s, dtype=x.dtype, device=x.device)
        out[:hi - lo] = x[lo:hi]
        return out

    return statistics.StatsState(*[cut(x) for x in full])


def _gather_mask(local: torch.Tensor, s: int, n: int) -> torch.Tensor:
    """[N] bool from every rank's [n_local <= S] piece."""
    padded = torch.zeros(s, dtype=torch.uint8, device=local.device)
    padded[:local.shape[0]] = local
    return all_gather(padded).reshape(-1)[:n].bool()


def sharded_select(params, stats_local: statistics.StatsState,
                   active_count: int, epoch: int, dp: DensifyParams,
                   densify_until: int, init_points_num: int,
                   chunk_size: int, generator=None, uniform=None):
    """The selection pass from sharded statistics: (selected, prune) [N]
    masks, the same on every rank.

    Taming draws ``uniform`` [N] from ``generator`` unless it is given
    (as ``training.densify.split_and_clone`` draws it) and uses its slice.
    """
    n = params.capacity
    d, rank = world()
    s = stats_local.weight_sum.shape[0]
    lo = min(rank * s, n)
    hi = min(lo + s, n)
    dev = params.xyz.device
    stats = statistics.StatsState(*[x[:hi - lo] for x in stats_local])
    p_local = params.mapped(lambda x: x[..., lo:hi])
    active = torch.arange(lo, hi, device=dev) < active_count
    prune_local = dens.get_prune_mask(p_local, stats, active, dp)
    if dp.densify_mode == "official":
        # original-3DGS criterion, selected in index order up to the
        # chunk-trimmed headroom: global rank = the shards before this
        # one plus the local cumsum
        want = ((statistics.mean_grad_norm(stats)
                 >= dp.densify_grad_threshold) & active)
        per_shard = all_gather(want.sum().reshape(1))[:, 0]
        budget = min(int(per_shard.sum()), n - active_count)
        budget = (budget // chunk_size) * chunk_size
        rank_of = per_shard[:rank].sum() + torch.cumsum(want.long(), 0) - 1
        sel = want & (rank_of < budget)
    else:
        prune_num = int(collective("all_reduce",
                                   prune_local.sum().reshape(1)))
        budget = dens.taming_budget(prune_num, active_count, epoch, dp,
                                    densify_until, init_points_num,
                                    chunk_size, n)
        if uniform is None:
            uniform = dens.draw_uniform(n, generator, dev)
        keys = dens.taming_sample_keys(
            dens.get_score(p_local, stats, active), uniform[lo:hi])
        sel = sharded_topk_mask(keys, budget)
    return _gather_mask(sel, s, n), _gather_mask(prune_local, s, n)


def sharded_densify_step(params, adam, stats_local, active_count: int,
                         epoch: int, dp: DensifyParams, densify_until: int,
                         init_points_num: int, screen_extent: float,
                         chunk_size: int, generator=None, uniform=None,
                         normal=None):
    """The per-epoch density-control step on the reference schedule
    (densify.py:246-260) from sharded statistics: the sharded selection,
    then the replicated append and prune tail with its masks injected.

    Returns (params, adam, active_count, did) as
    ``training.densify.densify_step`` does, and equal to it bit for bit for
    the same generator state (or the same ``uniform`` and ``normal``).
    """
    did = False
    if dp.densify_from <= epoch < densify_until:
        if epoch % dp.densification_interval == 0:
            selected, prune_mask = sharded_select(
                params, stats_local, active_count, epoch, dp,
                densify_until, init_points_num, chunk_size,
                generator=generator, uniform=uniform)
            pre_append = active_count
            params, adam, active_count = dens.split_and_clone(
                params, adam, None, active_count, epoch, dp, densify_until,
                init_points_num, screen_extent, chunk_size,
                generator=generator, normal=normal, selected=selected)
            params, adam, active_count = dens.prune(
                params, adam, None, active_count, dp, chunk_size,
                stats_valid_count=pre_append, prune_mask=prune_mask)
            did = True
        if epoch % dp.opacity_reset_interval == 0:
            params, adam = dens.reset_opacity(params, adam, dp)
            did = True
    return params, adam, active_count, did
