"""The data-parallel epoch loop (the port of
``litegs_tpu/parallel/trainer.py``).

The single-device Trainer takes one view per optimizer step, as the
reference's DataLoader(batch_size=1) loop does (litegs/training/
trainer.py:111-163).  Over D ranks each step takes D views -- one per
rank -- with the mean gradient all-reduced, so an epoch of F frames is
ceil(F/D) steps; when D does not divide F the last step pads the ranks
that have run out of frames with zero-weight duplicates.  Every rank takes
the same number of steps (a rank that skipped one would leave the others
waiting in a collective): the frame order comes from one
``torch.Generator`` seeded alike on every rank.  Everything stateful is
replicated except the densification statistics, which are sharded over
the primitive axis and feed the sharded densify pass (``densify.py``).

Each rank holds its own frames, the round-robin slice ``rank::D`` of the
training frames (``training.start.shard_frames_for_process``,
``parallel.shard_camera_batch``), and renders frame ``g`` of the global
order when ``g % D`` is its rank.

JAX's trainer re-buckets its capacities per step group and retries a
group whose binning overflowed; the port's buffers are sized from the
data and cannot overflow, so neither is carried over.

Semantics differ from the sequential Trainer (see ``parallel``): one
mean-gradient update replaces D sequential updates.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import config as cfg
from ..scene.gaussians import create_gaussians, pad_params, pad_to_chunk
from ..training import densify as tdensify
from ..training import statistics
from ..training.optimizer import init_adam
from ..training.trainer import (CameraBatch, TrainState, _state_device,
                                make_eval_render, masked_chunk_aabb)
from ..ops import losses
from ..utils import profiling, resolve_device
from . import all_gather, make_parallel_train_step, world
from . import densify as pdensify


@dataclasses.dataclass
class ParallelTrainer:
    """Data-parallel trainer: one rank of D, each rank in its own process
    with its own device (``device``, where ``data`` -- this rank's frames
    -- is moved)."""

    lp: cfg.ModelParams
    op: cfg.OptimizationParams
    pp: cfg.PipelineParams
    dp: cfg.DensifyParams
    caps: cfg.CapacityParams
    data: CameraBatch
    spatial_lr_scale: float
    # learning-rate multiplier for the D-views-per-update semantics; JAX
    # (CONVERGENCE_r2.md) and the port (CONVERGENCE_TORCH.md) measured
    # that at equal optimizer updates the mean-gradient step needs none,
    # and that sqrt(D) loses at equal images, hence 1.0
    lr_scale: float = 1.0
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        if self.op.learnable_viewproj:
            raise ValueError(
                "learnable_viewproj is not supported by ParallelTrainer")
        self.device = resolve_device(self.device)
        self.data = CameraBatch(*[x.to(self.device) for x in self.data])
        self.d, self.rank = world()
        self.img_h = int(self.data.images.shape[2])
        self.img_w = int(self.data.images.shape[3])
        n_local = int(self.data.images.shape[0])
        self.n_frames = int(all_gather(torch.tensor(
            [n_local], device=self.device)).sum())
        if n_local == 0 or n_local != len(range(self.rank, self.n_frames,
                                                self.d)):
            raise ValueError(
                f"rank {self.rank} holds {n_local} of {self.n_frames} "
                f"frames; ParallelTrainer needs the round-robin slice "
                f"rank::{self.d}, with at least one frame per rank")
        # one epoch sees every frame once in ceil(F/D) steps of <= D views
        self.steps_per_epoch = -(-self.n_frames // self.d)
        self.total_epochs = max(int(self.op.iterations) // self.n_frames, 1)
        self.densify_until = tdensify.densify_until_epoch(
            self.dp, self.total_epochs)
        self._step_cache = {}
        self.generator = torch.Generator().manual_seed(self.seed)
        self.pose_state = None

    # -- setup ---------------------------------------------------------

    def init_state(self, init_xyz, init_color) -> TrainState:
        params = create_gaussians(init_xyz, init_color, self.lp.sh_degree,
                                  device=self.device)
        params = pad_to_chunk(params, self.pp.cluster_size)
        self.init_points_num = params.capacity
        params = pad_params(params, self.caps.primitive_capacity)
        return TrainState(params=params, adam=init_adam(params),
                          active_count=self.init_points_num, step=0)

    def init_stats(self) -> statistics.StatsState:
        return pdensify.init_sharded_stats(self.caps.primitive_capacity,
                                           self.device)

    # -- helpers -------------------------------------------------------

    def _sh_degree(self, epoch: int) -> int:
        return min(epoch // 5, self.lp.sh_degree)

    def is_densify_active(self, epoch: int) -> bool:
        return (self.dp.densify_from <= epoch < self.densify_until
                and epoch % self.dp.densification_interval == 0)

    def _collect_stats(self, epoch: int) -> bool:
        """Official mode accumulates every epoch before densify_until;
        taming only on densify epochs (Trainer._collect_stats)."""
        if self.dp.densify_mode == "official":
            return epoch < self.densify_until
        return self.is_densify_active(epoch)

    def _get_step(self, sh_degree: int, collect: bool):
        key = (sh_degree, collect)
        if key not in self._step_cache:
            self._step_cache[key] = make_parallel_train_step(
                self.lp, self.op, self.pp, self.caps, self.img_h,
                self.img_w, self.spatial_lr_scale, sh_degree, collect,
                sharded_stats=True, lr_scale=self.lr_scale)
        return self._step_cache[key]

    def epoch_frames(self):
        """This rank's (local frame ids, weights), one per step of the
        epoch: a permutation of the F global frames (the same on every
        rank) keeps the frames whose global index is this rank's modulo D;
        a rank with fewer than ceil(F/D) pads with its own frames again,
        wrapping around, at weight 0."""
        order = torch.randperm(self.n_frames,
                               generator=self.generator).tolist()
        ids = [g // self.d for g in order if g % self.d == self.rank]
        weights = [1.0] * len(ids)
        pad = self.steps_per_epoch - len(ids)
        ids += (ids * (-(-pad // len(ids))))[:pad]
        weights += [0.0] * pad
        return ids, weights

    # -- main loop -----------------------------------------------------

    def run_epoch(self, state: TrainState, stats, epoch: int, frames=None):
        """Train one epoch over ``frames`` (default: ``epoch_frames()``);
        returns (state, stats, mean metrics over the steps)."""
        sh_deg = self._sh_degree(epoch)
        collect = self._collect_stats(epoch)
        with torch.no_grad():
            origin, extend = masked_chunk_aabb(
                state.params, state.active_count, self.pp.cluster_size)
        ids, weights = frames if frames is not None else self.epoch_frames()
        step_fn = self._get_step(sh_deg, collect)
        d = self.data
        pending = []
        for i, w in zip(ids, weights):
            state, stats, metrics = step_fn(
                state, stats, origin, extend, d.view[i], d.proj[i],
                d.planes[i], d.center[i], d.images[i], w)
            pending.append(torch.stack([metrics["loss"], metrics["psnr"]]))
        got = torch.stack(pending).cpu().numpy()
        return state, stats, {"loss": float(np.mean(got[:, 0])),
                              "psnr": float(np.mean(got[:, 1]))}

    @profiling.spanned("boundary", device=_state_device)
    def epoch_boundary(self, state: TrainState, stats, epoch: int):
        """The sharded densification, then the Morton resort, in a span
        ``boundary``."""
        params, adam, active, did = pdensify.sharded_densify_step(
            state.params, state.adam, stats, state.active_count, epoch,
            self.dp, self.densify_until, self.init_points_num,
            self.spatial_lr_scale, self.pp.cluster_size,
            generator=self.generator)
        if did:
            stats = self.init_stats()
        state = state._replace(params=params, adam=adam, active_count=active)
        if self.pp.cluster_size > 0 and (
                epoch % self.dp.densification_interval == 0):
            params, adam = tdensify.spatial_refine(state.params, state.adam,
                                                   state.active_count)
            state = state._replace(params=params, adam=adam)
        return state, stats

    def train(self, init_xyz, init_color, verbose=True):
        state = self.init_state(init_xyz, init_color)
        stats = self.init_stats()
        history = []
        t0 = time.time()
        verbose = verbose and self.rank == 0
        for epoch in range(self.total_epochs):
            state, stats, metrics = self.run_epoch(state, stats, epoch)
            state, stats = self.epoch_boundary(state, stats, epoch)
            metrics["epoch"] = epoch
            metrics["active"] = state.active_count
            history.append(metrics)
            if verbose:
                print(f"[epoch {epoch}] loss={metrics['loss']:.4f} "
                      f"psnr={metrics['psnr']:.2f} "
                      f"active={metrics['active']}", flush=True)
        if verbose:
            print(f"parallel training took {time.time() - t0:.1f}s "
                  f"(D={self.d}, lr_scale={self.lr_scale:.2f})", flush=True)
        return state, stats, history

    # -- eval and IO hooks (as the single-device Trainer's) -------------

    def evaluate(self, state: TrainState, data: CameraBatch,
                 epoch: int) -> float:
        """Mean PSNR of ``data``'s views from the replicated state (every
        rank renders every view and gets the same number)."""
        eval_fn = make_eval_render(self.pp, self.img_h, self.img_w,
                                   self._sh_degree(epoch))
        psnrs = []
        for i in range(data.images.shape[0]):
            img, _ = eval_fn(state.params, state.active_count, data.view[i],
                             data.proj[i], data.planes[i], data.center[i])
            psnrs.append(losses.psnr(img, data.images[i]))
        return float(torch.stack(psnrs).mean())

    def stats_for_io(self, stats) -> statistics.StatsState:
        """The full [N] statistics, gathered from every rank's shard (a
        collective: every rank calls it)."""
        return pdensify.gather_stats(stats, self.caps.primitive_capacity)

    def stats_from_io(self, full_stats) -> statistics.StatsState:
        return pdensify.local_shard(statistics.StatsState(
            *[x.to(self.device) for x in full_stats]))

    def state_from_io(self, state: TrainState) -> TrainState:
        """Every rank restores the same file: the replicas are equal."""
        return state
