"""Data-parallel training over ``torch.distributed``.

The port of ``litegs_tpu/parallel/__init__.py``.  JAX builds one in-process
mesh over every device; PyTorch's idiom is one rank per process and one
device per rank (``torchrun --nproc_per_node N``), with NCCL between cards
and gloo between CPU processes.  The seam is the same as JAX's:

* **cameras are sharded** -- each rank renders its own view per step;
* **gaussian parameters are replicated** -- every rank holds the full
  model, and every rank applies the same update, so the replicas stay
  bit-equal;
* **gradients are combined with an all-reduce** (optionally in bf16 on the
  wire, ``pp.grad_allreduce_dtype``), weighted so that a padding slot adds
  nothing;
* the sparse-Adam visibility mask is the **union** (a MAX all-reduce) of
  the ranks' visible chunks;
* densification statistics are each rank's deltas, all-reduced into a
  replicated accumulator or reduce-scattered into sharded ones
  (``parallel.densify``).

One step applies ONE optimizer update from the mean gradient of D views,
where the reference applies D sequential updates.

Every collective of the package goes through :func:`collective`, inside a
``collective:<kind>`` profiler span; ``COLLECTIVE_CALLS`` counts the calls
by kind.  Without an initialised process group there is one rank, and
each collective is the identity (nothing is called or counted).
"""
from __future__ import annotations

import collections
import datetime
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from .. import config as cfg
from ..ops import losses
from ..ops import raster as raster_ops
from ..render import render, render_preprocess
from ..scene import cluster
from ..training import statistics
from ..training.optimizer import LearningRates, sparse_adam_step
from ..training.trainer import (CameraBatch, TrainState, view_loss,
                                view_raster_stats)
from ..utils import resolve_device
from ..utils import profiling

COLLECTIVE_CALLS: collections.Counter = collections.Counter()


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None, device="cuda",
                           timeout: Optional[float] = None) -> int:
    """Join the process group; returns the world size.

    The backend follows the device: ``nccl`` for cuda, ``gloo`` for cpu.
    Launched by torchrun (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` in the
    environment) it joins through the environment and, on cuda, takes the
    card ``LOCAL_RANK``.  With explicit arguments it joins ``init_method``
    (``tcp://host:port`` or ``file://path``) as ``rank`` of
    ``world_size``; a failure raises and never degrades to one process.
    With neither it is one process and returns 1.  An already initialised
    group is kept.  ``timeout``: seconds to wait for the other ranks.
    """
    dev = resolve_device(device)
    if dist.is_initialized():
        return dist.get_world_size()
    explicit = (init_method is not None or world_size is not None
                or rank is not None)
    from_env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if not explicit and not from_env:
        return 1
    if dev.type == "cuda":
        index = dev.index
        if index is None:
            index = int(os.environ.get("LOCAL_RANK", 0)) if from_env else (
                torch.cuda.current_device())
        torch.cuda.set_device(index)
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method or "env://", world_size=world_size or -1,
        rank=-1 if rank is None else rank, **kwargs)
    return dist.get_world_size()


def world() -> tuple[int, int]:
    """(world size, rank); (1, 0) without a process group."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def collective(kind: str, tensor: torch.Tensor,
               out: Optional[torch.Tensor] = None, op=dist.ReduceOp.SUM):
    """The package's one call site of ``torch.distributed``.

    ``kind``: ``'all_reduce'`` (in place on ``tensor``, with ``op``),
    ``'reduce_scatter'`` (``tensor`` [D * n] summed into ``out`` [n]) or
    ``'all_gather'`` (``tensor`` [n] of every rank into ``out`` [D * n]).
    Returns the result tensor.
    """
    if not dist.is_initialized():
        if out is None:
            return tensor
        return out.copy_(tensor)
    COLLECTIVE_CALLS[kind] += 1
    with profiling.span(f"collective:{kind}", tensor.device):
        if kind == "all_reduce":
            dist.all_reduce(tensor, op=op)
            return tensor
        if kind == "reduce_scatter":
            dist.reduce_scatter_tensor(out, tensor, op=op)
        elif kind == "all_gather":
            dist.all_gather_into_tensor(out, tensor)
        else:
            raise ValueError(f"unknown collective {kind!r}")
    return out


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """[D, *x.shape]: every rank's ``x``, in rank order."""
    d, _ = world()
    out = x.new_empty((d * x.numel(),))
    return collective("all_gather", x.contiguous().reshape(-1),
                      out).reshape(d, *x.shape)


def shard_camera_batch(batch: CameraBatch) -> CameraBatch:
    """This rank's frames of a batch: the round-robin slice ``rank::D``
    (``training.start.shard_frames_for_process`` on frame lists)."""
    d, r = world()
    return CameraBatch(*[x[r::d] for x in batch])


def _reduce_grads(grads: list, weight, wsum, wire: str):
    """Σ_ranks (w · g) / wsum for every gradient, in one all-reduce of the
    flattened gradients; ``wire`` 'bf16' casts before the reduce and back
    to float32 after."""
    flat = torch.cat([g.reshape(-1) for g in grads]).mul_(weight)
    if wire == "bf16":
        flat = collective("all_reduce", flat.to(torch.bfloat16)).float()
    else:
        flat = collective("all_reduce", flat)
    flat.div_(wsum)
    return [f.view_as(g) for f, g in
            zip(torch.split(flat, [g.numel() for g in grads]), grads)]


def pack_stats(delta: statistics.StatsState) -> torch.Tensor:
    """[7, N] float32 (visible counts are small integers, exact there)."""
    return torch.stack([x.float() for x in delta])


def add_packed(stats: statistics.StatsState,
               packed: torch.Tensor) -> statistics.StatsState:
    return statistics.StatsState(*[
        acc + d.to(acc.dtype) for acc, d in zip(stats, packed)])


def make_parallel_train_step(lp: cfg.ModelParams, op: cfg.OptimizationParams,
                             pp: cfg.PipelineParams, caps: cfg.CapacityParams,
                             img_h: int, img_w: int, spatial_lr_scale: float,
                             sh_degree: int, collect_stats: bool,
                             sharded_stats: bool = False,
                             lr_scale: float = 1.0):
    """Build the data-parallel train step of one rank.

    Returns ``step(state, stats, chunk_origin, chunk_extend, view, proj,
    planes, center, gt_image, weight) -> (state, stats, metrics)``: this
    rank's view and its weight, the replicated state (updated in place, as
    ``make_train_step`` does) and the statistics, replicated [N] or, with
    ``sharded_stats``, this rank's shard (``parallel.densify``).  Every
    rank calls it once per step.

    ``weight``: 1 for a live view, 0 for a PADDING slot -- when D does not
    divide the frame count the last step pads with duplicate frames, whose
    gradients, statistics, chunk visibility and metrics must not count
    (the weighted mean with w = 0 gives the F-frame epoch exactly).

    The rank renders its view with autograd (``render_preprocess`` ->
    ``render`` -> ``fused_l1_ssim_loss`` -> backward), then: every
    gradient times w is summed over the ranks in one all-reduce (bf16 on
    the wire with ``pp.grad_allreduce_dtype == 'bf16'``) and divided by
    the summed weights; loss and PSNR likewise; the chunk mask is the MAX
    of the live ranks' masks; one ``sparse_adam_step``, the same on every
    rank, with the learning rates times ``lr_scale``; the statistics delta
    times w is all-reduced into replicated statistics or reduce-scattered
    into the rank's shard.  ``metrics``: ``loss``, ``psnr`` (device
    scalars) and ``sizes`` [D, 3], every rank's.

    JAX's step keeps the old state when any live chip's binning
    overflowed; the port's buffers are sized from the data and cannot
    overflow, so there is nothing to keep.
    """
    chunk_size = pp.cluster_size
    nchunks = caps.primitive_capacity // chunk_size
    use_sink = collect_stats and pp.raster_backend == "cuda"

    def step(state: TrainState, stats: statistics.StatsState,
             chunk_origin, chunk_extend, view, proj, planes, center,
             gt_image, weight):
        params = state.params
        dev = params.xyz.device
        live = float(weight) > 0.0
        # pageable copies to the device: host waits on the card
        profiling.host_wait("dp.weight")
        w = torch.tensor(float(weight), device=dev)
        params.zero_grad(set_to_none=True)
        culled = render_preprocess(params, chunk_origin, chunk_extend,
                                   planes, center, sh_degree, pp)
        sink = (raster_ops.zero_stats_sink(culled.xyz.shape[1], dev)
                if use_sink else None)
        out = render(culled, view, proj, img_h, img_w, pp, stats_sink=sink)
        if collect_stats and not use_sink:
            out.aux.tiles_color.retain_grad()
            out.aux.tiles_trans.retain_grad()
        loss = view_loss(op, pp, out.img, gt_image, culled.scale,
                         out.transmitance)
        loss.backward()

        psnr = losses.psnr(out.img.detach(), gt_image)
        sums = collective("all_reduce", torch.stack(
            [w, loss.detach() * w, psnr * w]))
        wsum = sums[0]
        fields = params.fields()
        grads = _reduce_grads(
            [torch.zeros_like(v) if v.grad is None else v.grad
             for v in fields.values()], w, wsum, pp.grad_allreduce_dtype)
        vis = cluster.scatter_chunk_mask(culled.chunk_ids,
                                         culled.num_visible_chunks, nchunks)
        vis = (vis & live).to(torch.int32)
        chunk_mask = collective("all_reduce", vis,
                                op=dist.ReduceOp.MAX) > 0
        lrs = LearningRates.from_config(op, spatial_lr_scale, state.step)
        if lr_scale != 1.0:
            lrs = LearningRates(*[lr * lr_scale for lr in lrs])
        sparse_adam_step(params, dict(zip(fields, grads)), state.adam, lrs,
                         chunk_mask, chunk_size)
        params.zero_grad(set_to_none=True)

        if collect_stats:
            delta = statistics.update_stats(
                statistics.init_stats(params.capacity, dev),
                culled.chunk_ids, culled.valid, out.primitive_visible,
                view_raster_stats(out, sink, pp, img_h, img_w), chunk_size)
            packed = pack_stats(delta) * w
            if sharded_stats:
                from . import densify as pdensify
                stats = pdensify.scatter_stats_update(stats, packed)
            else:
                stats = add_packed(stats, collective("all_reduce", packed))

        profiling.host_wait("dp.sizes")
        metrics = {"loss": sums[1] / wsum, "psnr": sums[2] / wsum,
                   "sizes": all_gather(out.sizes.to(dev))}
        return state._replace(step=state.step + 1), stats, metrics

    return step


def shard_len(capacity: int, d: int) -> int:
    """Primitives per statistics shard: ceil(N / D) (the last shard's tail
    past N is padding)."""
    return math.ceil(capacity / d)
