"""Top-level training entry: COLMAP dataset in, trained ply out.

The port of ``litegs_tpu/training/start.py`` (reference
``litegs.training.start``, trainer.py:26-227): load the COLMAP
reconstruction, load every image onto the device (reference
device_preload, data.py:178-190), build the Trainer, run the epoch loop
with the reference's hooks (test PSNR at ``test_epochs``, ply export at
``save_epochs`` + finish, checkpoint at ``checkpoint_epochs``, resume from
``start_checkpoint``) and, with pose refinement, write the refined
extrinsics to ``viewproj.npz``.  ``pp.batch_views`` reaches the Trainer,
whose epochs then take B views per optimizer step; epochs, history and
the iteration counts printed here count views, as at B = 1.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import config as cfg
from .. import io as io_manager
from ..data.camera import camera_dataset_norm, load_image
from ..utils import resolve_device
from .trainer import CameraBatch, Trainer


def split_train_test(frames, eval_mode: bool, source_path: str):
    """Train/test split: ``train_test_split.json`` when present, else the
    standard every-8th holdout (reference trainer.py:40-48)."""
    split_file = os.path.join(source_path, "train_test_split.json")
    if os.path.exists(split_file):
        with open(split_file) as f:
            split = json.load(f)
        train_names = set(split.get("train", []))
        test_names = set(split.get("test", []))
        train = [f for f in frames
                 if f.name in train_names or os.path.splitext(f.name)[0]
                 in train_names]
        test = [f for f in frames
                if f.name in test_names or os.path.splitext(f.name)[0]
                in test_names]
        return train, test
    if eval_mode:
        train = [f for i, f in enumerate(frames) if i % 8 != 0]
        test = [f for i, f in enumerate(frames) if i % 8 == 0]
        return train, test
    return list(frames), []


def build_camera_batch(cams, frames, images_dir: str, resolution: int,
                       device="cuda") -> tuple[CameraBatch, int, int]:
    """Load + resize all images, build the camera tensors on ``device``.

    All frames must share one post-resize resolution (true for the standard
    benchmark datasets; the batch is a single stacked tensor).  Each
    frame's intrinsics are its camera's, scaled to the loaded size.
    """
    dev = resolve_device(device)
    imgs, views, projs, planes, centers = [], [], [], [], []
    scaled_cache: dict[tuple[int, int, int], object] = {}
    img_h = img_w = None
    for fr in frames:
        if hasattr(fr, "load_image"):
            # self-loading frame (data.video.VideoFrame: pixels pulled
            # from a video file by index; reference VideoFrame,
            # data.py:118-136)
            arr = fr.load_image(resolution)
        else:
            arr = load_image(os.path.join(images_dir, fr.name), resolution)
        _, h, w = arr.shape
        if img_h is None:
            img_h, img_w = h, w
        elif (h, w) != (img_h, img_w):
            raise ValueError(
                f"frame {fr.name} is {h}x{w}, expected {img_h}x{img_w}; "
                "mixed-resolution datasets are not supported yet")
        cam = cams[fr.camera_id]
        key = (fr.camera_id, w, h)
        if key not in scaled_cache:
            scaled_cache[key] = cam.scaled(w, h)
        proj = scaled_cache[key].proj_matrix()
        imgs.append(arr)
        views.append(fr.view_matrix())
        projs.append(proj)
        planes.append(fr.frustumplane(proj))
        centers.append(fr.camera_center())

    def to(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    # uint8 to the device, then the float32 division there
    images = torch.from_numpy(np.stack(imgs)).to(dev).float() / 255.0
    batch = CameraBatch(view=to(np.stack(views)), proj=to(np.stack(projs)),
                        planes=to(np.stack(planes)),
                        center=to(np.stack(centers)), images=images)
    return batch, img_h, img_w


def _ckpt_tree(trainer, state, stats):
    """Checkpoint tree: TrainState + densify stats accumulators (+ pose
    state when pose refinement is on).  Stats ride the checkpoint because
    official-mode densification accumulates across epochs between densify
    events; they pass through the trainer's stats_for_io hook so the file
    does not depend on how a trainer lays them out."""
    tree = {"state": state, "stats": trainer.stats_for_io(stats)}
    if trainer.pose_state is not None:
        tree["pose"] = trainer.pose_state
    return tree


def _pick_trainer(lp, op, pp, dp, caps, data, radius, extr_init):
    """The trainer for ``pp.parallel`` on one device: 'auto' and 'off' take
    the single-device Trainer; 'on' asks for the data-parallel trainer,
    which is not ported."""
    want = pp.parallel
    if want not in ("auto", "on", "off"):
        raise ValueError(f"pp.parallel must be auto|on|off, got {want!r}")
    if want == "on":
        raise NotImplementedError(
            "pp.parallel='on' (the data-parallel trainer) is not ported "
            "yet: ROADMAP Queue 1, item 13")
    return Trainer(lp=lp, op=op, pp=pp, dp=dp, caps=caps, data=data,
                   spatial_lr_scale=radius, extr_init=extr_init)


def start(lp: cfg.ModelParams, op: cfg.OptimizationParams,
          pp: cfg.PipelineParams, dp: cfg.DensifyParams,
          test_epochs: Sequence[int] = (),
          save_epochs: Sequence[int] = (),
          checkpoint_epochs: Sequence[int] = (),
          start_checkpoint: Optional[str] = None,
          verbose: bool = True, device="cuda"):
    """Train a scene end-to-end on ``device``. Returns (trainer, state,
    history); each history entry holds the epoch's train ``loss``,
    ``psnr``, ``active`` count and ``seconds`` (host clock, the epoch and
    its boundary), and ``test_psnr`` on test epochs."""
    dev = resolve_device(device)
    t_load = time.time()
    cams, frames, xyz, rgb = io_manager.load_colmap_result(lp.source_path)
    train_frames, test_frames = split_train_test(frames, lp.eval,
                                                 lp.source_path)
    images_dir = os.path.join(lp.source_path, lp.images)
    data, img_h, img_w = build_camera_batch(cams, train_frames, images_dir,
                                            lp.resolution, device=dev)
    test_data = None
    if test_frames:
        test_data, _, _ = build_camera_batch(cams, test_frames, images_dir,
                                             lp.resolution, device=dev)
    _, radius = camera_dataset_norm(train_frames)
    if verbose:
        print(f"loaded {len(train_frames)} train / {len(test_frames)} test "
              f"frames at {img_h}x{img_w}, {xyz.shape[0]} seed points, "
              f"radius {radius:.2f} ({time.time() - t_load:.1f}s)",
              flush=True)

    caps = cfg.auto_capacity(max(int(dp.target_primitives),
                                 xyz.shape[0] + 1))
    extr_init = None
    if op.learnable_viewproj:
        extr_init = np.stack([fr.extr_params() for fr in train_frames])
    trainer = _pick_trainer(lp, op, pp, dp, caps, data, radius, extr_init)

    state = trainer.init_state(xyz, rgb)
    stats = trainer.init_stats()
    start_epoch = 0
    if start_checkpoint:
        # the checkpoint carries the densify statistics beside the
        # TrainState (official mode accumulates across epochs, so resuming
        # mid-window must restore the window) and the pose state when pose
        # refinement is on (the reference pickles the optimizer wholesale,
        # learnable viewproj included, checkpoint.py:16-25)
        template = _ckpt_tree(trainer, state, stats)
        start_epoch, restored = io_manager.load_checkpoint(
            start_checkpoint, template)
        state = trainer.state_from_io(restored["state"])
        stats = trainer.stats_from_io(restored["stats"])
        if trainer.pose_state is not None:
            trainer.pose_state = restored["pose"]
        start_epoch += 1
        if verbose:
            print(f"resumed from {start_checkpoint} at epoch {start_epoch}",
                  flush=True)

    ckpt_dir = os.path.join(lp.model_path, "checkpoints")
    history = []
    t0 = time.time()
    for epoch in range(start_epoch, trainer.total_epochs):
        t_epoch = time.time()
        state, stats, metrics = trainer.run_epoch(state, stats, epoch)
        state, stats = trainer.epoch_boundary(state, stats, epoch)
        metrics["epoch"] = epoch
        metrics["active"] = int(state.active_count)
        metrics["seconds"] = time.time() - t_epoch
        history.append(metrics)
        if verbose:
            print(f"[epoch {epoch}] loss={metrics['loss']:.4f} "
                  f"psnr={metrics['psnr']:.2f} active={metrics['active']}",
                  flush=True)
        if epoch in test_epochs and test_data is not None:
            metrics["test_psnr"] = trainer.evaluate(state, test_data, epoch)
            print(f"[epoch {epoch}] test PSNR {metrics['test_psnr']:.2f}",
                  flush=True)
        if epoch in save_epochs:
            export_ply(lp.model_path, state,
                       iteration=(epoch + 1) * trainer.n_frames)
        if epoch in checkpoint_epochs:
            io_manager.save_checkpoint(
                ckpt_dir, epoch, _ckpt_tree(trainer, state, stats))
    elapsed = time.time() - t0
    if verbose:
        iters = trainer.total_epochs * trainer.n_frames
        print(f"takes: {elapsed:.1f}s ({iters} iterations)", flush=True)
    export_ply(lp.model_path, state, final=True)
    if trainer.pose_state is not None:
        # refined camera extrinsics (reference saves viewproj.pth,
        # trainer.py:221-222)
        np.savez(os.path.join(lp.model_path, "viewproj.npz"),
                 extr=trainer.pose_state.extr.cpu().numpy())
    return trainer, state, history


def export_ply(model_path: str, state, iteration: int = 0,
               final: bool = False) -> str:
    """Standard 3DGS export layout (reference trainer.py:204-222):
    point_cloud/{iteration_N | finish}/point_cloud.ply."""
    sub = "finish" if final else f"iteration_{iteration}"
    path = os.path.join(model_path, "point_cloud", sub, "point_cloud.ply")
    io_manager.save_ply(path, state.params,
                        active_count=int(state.active_count))
    return path
