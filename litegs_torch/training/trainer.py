"""Training orchestration: the train step, the epoch loop and the eval render.

The port of ``litegs_tpu/training/trainer.py`` (reference
litegs/training/trainer.py:26-227).  One step runs render_preprocess ->
render (autograd through the raster kernels) -> fused L1+SSIM loss ->
backward -> sparse chunk Adam; with ``pp.batch_views`` = B > 1 a step
takes B views through one raster launch (make_batch_train_step).
Densification and the Morton resort run at epoch boundaries on the
reference's schedule.

The port sizes its buffers exactly from the data: render_preprocess keeps
exactly the visible chunks and binning emits exactly the view's entries, so
no step can overflow a capacity and ``overflow`` stays False.  The JAX
trainer's visible, row and entry capacities, its SizeFeedback, capacity
buckets and overflow retry guard fixed capacities the port does not have,
and are not carried over.  ``CapacityParams.primitive_capacity`` stays: the
model is padded to it, so densification appends into the padded tail and
prunes by compaction exactly as the JAX package does, with
``active_count`` primitives live.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import config as cfg
from ..ops import losses
from ..ops import pose as pose_ops
from ..ops import raster as raster_ops
from ..render import render, render_batch, render_preprocess
from ..scene import cluster
from ..scene.gaussians import (GaussianModel, create_gaussians, pad_params,
                               pad_to_chunk)
from ..utils import resolve_device
from . import densify, statistics
from .optimizer import AdamState, LearningRates, init_adam, sparse_adam_step


class TrainState(NamedTuple):
    params: GaussianModel
    adam: AdamState
    active_count: int     # live primitives (a multiple of the chunk size)
    step: int             # optimizer steps taken


class CameraBatch(NamedTuple):
    """Per-frame camera tensors on the device."""

    view: torch.Tensor      # [F, 4, 4]
    proj: torch.Tensor      # [F, 4, 4]
    planes: torch.Tensor    # [F, 6, 4]
    center: torch.Tensor    # [F, 3]
    images: torch.Tensor    # [F, 3, H, W] float32 in [0, 1]


def masked_chunk_aabb(params: GaussianModel, active_count: int,
                      chunk_size: int):
    """Per-chunk AABBs with inactive chunks pushed out of every frustum."""
    scale = torch.exp(params.scale)
    norm = torch.sqrt(torch.sum(params.rot ** 2, dim=0, keepdim=True))
    rot = params.rot / torch.clamp(norm, min=1e-12)
    origin, extend = cluster.chunk_aabb(params.xyz, scale, rot, chunk_size)
    nchunks = origin.shape[-1]
    chunk_active = (torch.arange(nchunks, device=origin.device)
                    < active_count // chunk_size)
    origin = torch.where(chunk_active, origin, torch.full_like(origin, 1e9))
    extend = torch.where(chunk_active, extend, torch.zeros_like(extend))
    return origin, extend


def view_loss(op: cfg.OptimizationParams, pp: cfg.PipelineParams, img,
              gt_image, scale, transmitance):
    """One view's training loss: fused L1+SSIM, the optional scale
    regulariser over its visible primitives and the transmittance term."""
    loss = losses.fused_l1_ssim_loss(img, gt_image, op.lambda_dssim)
    if op.reg_weight > 0.0:
        loss = loss + torch.mean(scale ** 2) * op.reg_weight
    if pp.enable_transmitance:
        loss = loss + torch.mean(torch.abs(1.0 - transmitance))
    return loss


def _adam_update(state: TrainState, culled_views,
                 op: cfg.OptimizationParams, spatial_lr_scale: float,
                 chunk_size: int):
    """Sparse chunk Adam from the parameters' gradients over the union of
    the views' visible chunks; clears the gradients."""
    params = state.params
    chunk_mask = None
    for c in culled_views:
        vis = cluster.scatter_chunk_mask(c.chunk_ids, c.num_visible_chunks,
                                         params.capacity // chunk_size)
        chunk_mask = vis if chunk_mask is None else chunk_mask | vis
    lrs = LearningRates.from_config(op, spatial_lr_scale, state.step)
    sparse_adam_step(params, {k: v.grad for k, v in
                              params.fields().items()},
                     state.adam, lrs, chunk_mask, chunk_size)
    params.zero_grad(set_to_none=True)


def view_raster_stats(out, sink, pp: cfg.PipelineParams, img_h: int,
                      img_w: int) -> raster_ops.RasterStats:
    """One view's densification statistics after the loss's backward: the
    gradients of the stats sink (``'cuda'`` backend, the same kernel run as
    the parameter gradients) or, without a sink, the explicit
    ``raster_stats`` pass from the cotangents of the raster outputs, which
    the caller kept with ``retain_grad``."""
    if sink is not None:
        return raster_ops.RasterStats(*[s.grad for s in sink])
    tile_h, tile_w = pp.tile_size
    tiles_x = math.ceil(img_w / tile_w)
    tiles_total = math.ceil(img_h / tile_h) * tiles_x
    aux = out.aux
    d_trans = aux.tiles_trans.grad
    if d_trans is None:
        d_trans = torch.zeros_like(aux.tiles_trans)
    return raster_ops.raster_stats(
        aux.mean_pix, aux.inv_cov, aux.color_chan, aux.opacity, aux.table,
        aux.tiles_color, aux.tiles_trans, aux.tiles_color.grad, d_trans,
        tiles_total, tiles_x, tile_h, tile_w, img_h, img_w,
        backend=pp.raster_backend)


def make_train_step(lp: cfg.ModelParams, op: cfg.OptimizationParams,
                    pp: cfg.PipelineParams, caps: cfg.CapacityParams,
                    img_h: int, img_w: int, spatial_lr_scale: float,
                    sh_degree: int, collect_stats: bool,
                    learnable_pose: bool = False):
    """Build the per-iteration step for one configuration.

    Returns ``step(state, stats, chunk_origin, chunk_extend, view, proj,
    planes, center, gt_image) -> (state, stats, metrics)``.  The step
    updates the model and its moments in place and returns the state with
    ``step`` advanced; ``metrics`` holds device tensors (``loss``,
    ``psnr``, ``sizes`` and, on statistics steps, ``tile_count``).

    With ``learnable_pose`` (op.learnable_viewproj) the step is
    ``step(..., gt_image, pose, frame_idx) -> (state, stats, pose,
    metrics)``: the view is rebuilt from the frame's row of ``pose.extr``
    with gradient (``ops.pose.camera_from_extr``; the ``view``, ``planes``
    and ``center`` arguments are not read), the frame's planes and centre
    from the same row without gradient, and the row is updated by
    ``sparse_pose_adam`` (JAX trainer.py:115-131).  The view's gradient
    reaches the row through the projection chain's autograd from the
    raster backward's outputs.  A step cannot overflow, so the pose update
    is always applied; ``metrics["extr_grad"]`` is the row's gradient.

    On statistics steps with the ``'cuda'`` backend the densification
    statistics ride the same backward-kernel run as the parameter
    gradients (the stats sink of ``ops.raster.rasterize``); the ``'torch'``
    backend keeps the loss's cotangent of the raster outputs and runs the
    explicit ``raster_stats`` pass, as the JAX trainer does on its jnp
    backend.
    """
    chunk_size = pp.cluster_size
    use_sink = collect_stats and pp.raster_backend == "cuda"

    def step(state: TrainState, stats: statistics.StatsState,
             chunk_origin, chunk_extend, view, proj, planes, center,
             gt_image, pose: Optional[pose_ops.PoseState] = None,
             frame_idx: Optional[int] = None):
        params = state.params
        params.zero_grad(set_to_none=True)
        if learnable_pose:
            extr_row = pose.extr[frame_idx].detach().requires_grad_(True)
            view, planes, center = pose_ops.camera_from_extr(extr_row, proj)
            # culling planes and SH view dirs carry no pose gradient
            # (reference: frustum/no_grad dirs, render/__init__.py:40)
            planes, center = planes.detach(), center.detach()
        culled = render_preprocess(params, chunk_origin, chunk_extend,
                                   planes, center, sh_degree, pp)
        sink = (raster_ops.zero_stats_sink(culled.xyz.shape[1],
                                           culled.xyz.device)
                if use_sink else None)
        out = render(culled, view, proj, img_h, img_w, pp, stats_sink=sink)
        aux = out.aux
        if collect_stats and not use_sink:
            aux.tiles_color.retain_grad()
            aux.tiles_trans.retain_grad()
        loss = view_loss(op, pp, out.img, gt_image, culled.scale,
                         out.transmitance)
        loss.backward()
        _adam_update(state, [culled], op, spatial_lr_scale, chunk_size)

        if collect_stats:
            stats = statistics.update_stats(
                stats, culled.chunk_ids, culled.valid,
                out.primitive_visible,
                view_raster_stats(out, sink, pp, img_h, img_w), chunk_size)

        metrics = {
            "loss": loss.detach(),
            "psnr": losses.psnr(out.img.detach(), gt_image),
            "sizes": out.sizes,
        }
        if collect_stats:
            # per-tile blend depth (reference update_tile_blend_count,
            # statistic_helper.py:68-79; feeds complexity_sorted_tiles)
            metrics["tile_count"] = aux.table.tile_count
        state = state._replace(step=state.step + 1)
        if not learnable_pose:
            return state, stats, metrics
        metrics["extr_grad"] = extr_row.grad
        pose = pose_ops.sparse_pose_adam(pose, frame_idx, extr_row.grad,
                                         lr=op.pose_lr)
        return state, stats, pose, metrics

    return step


def make_batch_train_step(lp: cfg.ModelParams, op: cfg.OptimizationParams,
                          pp: cfg.PipelineParams, caps: cfg.CapacityParams,
                          img_h: int, img_w: int, spatial_lr_scale: float,
                          sh_degree: int, batch_views: int,
                          collect_stats: bool):
    """The step over B views through ONE raster forward and ONE raster
    backward launch (``litegs_tpu/training/trainer.py::
    make_batch_train_step``).

    Returns ``step(state, stats, chunk_origin, chunk_extend, views [B, 4,
    4], projs, planes [B, 6, 4], centers [B, 3], gt_images [B, 3, H, W])
    -> (state, stats, metrics)``: ONE sparse-Adam update from the mean
    loss of the B views (render_batch over a merged B * T tile grid), with
    the union of the views' chunk masks, and on statistics steps one
    ``update_stats`` per view from its slice of the merged stats sink.
    ``metrics``: ``loss`` (the mean), ``psnr`` (the mean over views) and
    ``sizes`` [B, 3]; no ``tile_count`` (the JAX batched loop keeps no
    blend-depth telemetry).  The 'cuda' backend only, as JAX's is
    Pallas-only; no pose refinement.

    JAX's capacity bundle per group (``_group_caps_max``), its overflow
    no-op (``keep_old``) and the retry of overflowed groups guard fixed
    capacities; the port's tables are exact and cannot overflow, so none
    of them is carried over.
    """
    if pp.raster_backend != "cuda":
        raise ValueError("the batched step needs the 'cuda' raster backend")
    b = batch_views
    chunk_size = pp.cluster_size

    def step(state: TrainState, stats: statistics.StatsState,
             chunk_origin, chunk_extend, views, projs, planes, centers,
             gt_images):
        params = state.params
        params.zero_grad(set_to_none=True)
        culled = [render_preprocess(params, chunk_origin, chunk_extend,
                                    planes[v], centers[v], sh_degree, pp)
                  for v in range(b)]
        sink = None
        if collect_stats:
            m_total = sum(c.xyz.shape[1] for c in culled)
            sink = raster_ops.zero_stats_sink(m_total, params.xyz.device)
        out = render_batch(culled, views, projs, img_h, img_w, pp,
                           stats_sink=sink)
        trans = out.transmitance
        loss = sum(view_loss(op, pp, out.imgs[v], gt_images[v],
                             culled[v].scale,
                             None if trans is None else trans[v])
                   for v in range(b)) / b
        loss.backward()
        _adam_update(state, culled, op, spatial_lr_scale, chunk_size)

        if collect_stats:
            off = out.point_offsets
            for v, c in enumerate(culled):
                rstats = raster_ops.RasterStats(
                    *[s.grad[off[v]:off[v + 1]] for s in sink])
                stats = statistics.update_stats(
                    stats, c.chunk_ids, c.valid, out.primitive_visible[v],
                    rstats, chunk_size)
        imgs = out.imgs.detach()
        psnr = sum(losses.psnr(imgs[v], gt_images[v])
                   for v in range(b)) / b
        metrics = {"loss": loss.detach(), "psnr": psnr, "sizes": out.sizes}
        return state._replace(step=state.step + 1), stats, metrics

    return step


def make_eval_render(pp: cfg.PipelineParams, img_h: int, img_w: int,
                     sh_degree: int):
    """fn(params, active_count, view, proj, planes, center) -> (img,
    overflow), rendering one view without autograd."""
    @torch.no_grad()
    def eval_render(params, active_count, view, proj, planes, center):
        chunk_origin, chunk_extend = masked_chunk_aabb(
            params, active_count, pp.cluster_size)
        culled = render_preprocess(params, chunk_origin, chunk_extend,
                                   planes, center, sh_degree, pp)
        out = render(culled, view, proj, img_h, img_w, pp)
        return out.img, out.overflow

    return eval_render


@dataclasses.dataclass
class Trainer:
    """Stateful loop around the step (epoch loop, schedules,
    densification), mirroring litegs.training.start.

    The model lives on the device of ``data``.  Randomness (the default
    frame order, the densification draws) comes from a CPU
    ``torch.Generator`` seeded with ``seed``.
    """

    lp: cfg.ModelParams
    op: cfg.OptimizationParams
    pp: cfg.PipelineParams
    dp: cfg.DensifyParams
    caps: cfg.CapacityParams
    data: CameraBatch
    spatial_lr_scale: float
    seed: int = 0
    # per-frame extrinsics [F, 7] (qvec+tvec); required when
    # op.learnable_viewproj -- the pose-refinement initialization
    extr_init: Optional[np.ndarray] = None

    def __post_init__(self):
        self.device = self.data.images.device
        self.img_h = int(self.data.images.shape[2])
        self.img_w = int(self.data.images.shape[3])
        self.n_frames = int(self.data.images.shape[0])
        self.total_epochs = max(int(self.op.iterations) // self.n_frames, 1)
        self.densify_until = densify.densify_until_epoch(
            self.dp, self.total_epochs)
        self._step_cache = {}
        self.generator = torch.Generator().manual_seed(self.seed)
        # per-tile max blend count over the last statistics epoch
        self.tile_blend_max = None
        self.pose_state = None
        if self.op.learnable_viewproj:
            if self.extr_init is None:
                raise ValueError(
                    "learnable_viewproj requires extr_init ([F,7] per frame)")
            self.pose_state = pose_ops.init_pose_state(self.extr_init,
                                                       self.device)
        # B > 1 views per step (pp.batch_views): the 'cuda' backend without
        # learnable_viewproj; otherwise a loud fall back to B = 1, as JAX
        self.batch_views = 1
        if self.pp.batch_views > 1:
            if (self.pp.raster_backend == "cuda"
                    and not self.op.learnable_viewproj):
                self.batch_views = int(self.pp.batch_views)
            else:
                print("WARNING: batch_views > 1 requires the cuda backend "
                      "without learnable_viewproj; using B=1", flush=True)

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
        return statistics.init_stats(self.caps.primitive_capacity,
                                     self.device)

    # -- helpers -------------------------------------------------------

    def _sh_degree(self, epoch: int) -> int:
        return min(epoch // 5, self.lp.sh_degree)

    def is_densify_active(self, epoch: int) -> bool:
        return (self.dp.densify_from <= epoch < self.densify_until
                and epoch % self.dp.densification_interval == 0)

    def _collect_stats(self, epoch: int) -> bool:
        """Whether this epoch's steps collect densify statistics: the
        densify epoch itself in taming mode; every epoch before
        densify_until in official mode (original-3DGS accumulation)."""
        if self.dp.densify_mode == "official":
            return epoch < self.densify_until
        return self.is_densify_active(epoch)

    def _get_step(self, sh_degree: int, collect: bool):
        key = (sh_degree, collect)
        if key not in self._step_cache:
            self._step_cache[key] = make_train_step(
                self.lp, self.op, self.pp, self.caps, self.img_h,
                self.img_w, self.spatial_lr_scale, sh_degree, collect,
                learnable_pose=self.op.learnable_viewproj)
        return self._step_cache[key]

    def _get_batch_step(self, sh_degree: int, collect: bool, b: int):
        key = (sh_degree, collect, b)
        if key not in self._step_cache:
            self._step_cache[key] = make_batch_train_step(
                self.lp, self.op, self.pp, self.caps, self.img_h,
                self.img_w, self.spatial_lr_scale, sh_degree, b, collect)
        return self._step_cache[key]

    def _run_epoch_batched(self, state: TrainState, stats, frame_ids,
                           sh_deg: int, collect: bool, origin, extend):
        """Epoch loop of ``batch_views`` frames per optimizer step through
        one raster launch (JAX ``Trainer._run_epoch_batched``).  The
        leftover ``len % B`` frames run through the single-view step, so
        an epoch still sees every frame once.  As in JAX, the per-tile
        blend depth (``tile_blend_max``) is not updated; JAX's per-frame
        size feedback and overflow retry have nothing to do here."""
        bv = self.batch_views
        ids = [int(i) for i in frame_ids]
        cut = len(ids) - len(ids) % bv
        d = self.data
        pending = []
        for s in range(0, cut, bv):
            sel = torch.tensor(ids[s:s + bv], device=self.device)
            state, stats, metrics = self._get_batch_step(
                sh_deg, collect, bv)(
                state, stats, origin, extend, d.view[sel], d.proj[sel],
                d.planes[sel], d.center[sel], d.images[sel])
            pending.append(metrics)
        step_fn = self._get_step(sh_deg, collect)
        for i in ids[cut:]:
            state, stats, metrics = step_fn(
                state, stats, origin, extend, d.view[i], d.proj[i],
                d.planes[i], d.center[i], d.images[i])
            pending.append(metrics)
        got = torch.stack([torch.stack([m["loss"], m["psnr"]])
                           for m in pending]).cpu().numpy()
        return state, stats, {"loss": float(np.mean(got[:, 0])),
                              "psnr": float(np.mean(got[:, 1]))}

    # -- main loop -----------------------------------------------------

    def run_epoch(self, state: TrainState, stats, epoch: int,
                  frame_ids=None):
        """Train one epoch over ``frame_ids`` (default: a permutation from
        the Trainer's generator); returns (state, stats, mean_metrics).

        Metrics stay on the device until the epoch ends: one read-back
        per epoch.
        """
        sh_deg = self._sh_degree(epoch)
        collect = self._collect_stats(epoch)
        with torch.no_grad():
            origin, extend = masked_chunk_aabb(
                state.params, state.active_count, self.pp.cluster_size)
        if frame_ids is None:
            frame_ids = torch.randperm(self.n_frames,
                                       generator=self.generator).tolist()
        if self.batch_views > 1:
            return self._run_epoch_batched(state, stats, frame_ids, sh_deg,
                                           collect, origin, extend)
        step_fn = self._get_step(sh_deg, collect)
        d = self.data
        pending = []
        for i in frame_ids:
            i = int(i)
            args = (state, stats, origin, extend, d.view[i], d.proj[i],
                    d.planes[i], d.center[i], d.images[i])
            if self.pose_state is None:
                state, stats, metrics = step_fn(*args)
            else:
                state, stats, self.pose_state, metrics = step_fn(
                    *args, self.pose_state, i)
            pending.append(metrics)
        got = torch.stack([torch.stack([m["loss"], m["psnr"]])
                           for m in pending]).cpu().numpy()
        if collect:
            self.tile_blend_max = torch.stack(
                [m["tile_count"] for m in pending]).amax(dim=0).cpu().numpy()
        return state, stats, {"loss": float(np.mean(got[:, 0])),
                              "psnr": float(np.mean(got[:, 1]))}

    def epoch_boundary(self, state: TrainState, stats, epoch: int):
        """Densification, then the Morton resort, on the reference
        schedule (trainer.py:101-106, 201)."""
        params, adam, active, did = densify.densify_step(
            state.params, state.adam, stats, state.active_count, epoch,
            self.dp, self.densify_until, self.init_points_num,
            self.spatial_lr_scale, self.pp.cluster_size,
            generator=self.generator)
        if did:
            stats = self.init_stats()
        state = state._replace(params=params, adam=adam, active_count=active)
        # the resort runs at the START of epoch e when
        # (e - 1) % interval == 0; here at the end of epoch e-1
        if self.pp.cluster_size > 0 and (
                epoch % self.dp.densification_interval == 0):
            params, adam = densify.spatial_refine(state.params, state.adam,
                                                  state.active_count)
            state = state._replace(params=params, adam=adam)
        return state, stats

    def train(self, init_xyz, init_color, test_epochs=(), log_every=1,
              test_data: Optional[CameraBatch] = None, verbose=True):
        state = self.init_state(init_xyz, init_color)
        stats = self.init_stats()
        history = []
        t0 = time.time()
        for epoch in range(self.total_epochs):
            state, stats, metrics = self.run_epoch(state, stats, epoch)
            state, stats = self.epoch_boundary(state, stats, epoch)
            metrics["epoch"] = epoch
            metrics["active"] = state.active_count
            history.append(metrics)
            if verbose and (epoch % log_every == 0
                            or epoch == self.total_epochs - 1):
                print(f"[epoch {epoch}] loss={metrics['loss']:.4f} "
                      f"psnr={metrics['psnr']:.2f} "
                      f"active={metrics['active']}", flush=True)
            if epoch in test_epochs and test_data is not None:
                psnr = self.evaluate(state, test_data, epoch)
                if verbose:
                    print(f"[epoch {epoch}] test PSNR {psnr:.2f}",
                          flush=True)
        if verbose:
            print(f"training took {time.time() - t0:.1f}s "
                  f"({self.total_epochs * self.n_frames} iterations)",
                  flush=True)
        return state, stats, history

    def complexity_sorted_tiles(self):
        """Tile ids in descending blend-depth order from the last
        statistics epoch (reference statistic_helper.py:68-79), or None
        before any statistics epoch."""
        if self.tile_blend_max is None:
            return None
        return np.argsort(-self.tile_blend_max)

    def evaluate(self, state: TrainState, data: CameraBatch,
                 epoch: int) -> float:
        eval_fn = make_eval_render(self.pp, self.img_h, self.img_w,
                                   self._sh_degree(epoch))
        psnrs = []
        for i in range(data.images.shape[0]):
            img, _ = eval_fn(state.params, state.active_count, data.view[i],
                             data.proj[i], data.planes[i], data.center[i])
            psnrs.append(losses.psnr(img, data.images[i]))
        return float(torch.stack(psnrs).mean())

    # -- IO normalization hooks: the identity on one device; a trainer
    # over several devices gathers and re-places its sharded state through
    # the same interface, so training.start checkpoints any trainer alike
    def stats_for_io(self, stats):
        return stats

    def stats_from_io(self, host_stats):
        return host_stats

    def state_from_io(self, state: TrainState) -> TrainState:
        return state


def camera_batch_from_frames(cam, frames, images,
                             device="cuda") -> CameraBatch:
    """Camera tensors on ``device`` from data.camera objects."""
    dev = resolve_device(device)
    proj = cam.proj_matrix()
    views = np.stack([f.view_matrix() for f in frames])
    planes = np.stack([f.frustumplane(proj) for f in frames])
    centers = np.stack([f.camera_center() for f in frames])

    def to(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return CameraBatch(
        view=to(views),
        proj=to(np.broadcast_to(proj, views.shape)),
        planes=to(planes),
        center=to(centers),
        images=torch.as_tensor(images, dtype=torch.float32).to(dev),
    )
