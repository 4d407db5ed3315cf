"""Closed-loop synthetic training task: render ground-truth images from a
procedurally generated gaussian scene, then train a fresh model against
them (``litegs_tpu/data/synthetic_train.py``).  The scene and the init
cloud come from numpy seeds, so both packages build the same task.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import config as cfg
from ..scene import GaussianModel, create_gaussians, pad_params
from ..training.trainer import camera_batch_from_frames, make_eval_render
from ..utils import resolve_device
from . import synthetic


def make_gt_params(n_points: int, sh_degree: int, seed: int,
                   color_freq: float = 1.0, scale_shift: float = 0.0,
                   device="cuda"):
    """A 'ground-truth' scene: the standard init plus randomized opacity,
    anisotropic scales and random rotations, so images are non-trivial.

    ``scale_shift`` adds to the log-scales (large clouds pass -0.7, as
    the JAX bench does, to keep per-point tile footprints garden-like).
    Returns (model, xyz, rgb).
    """
    dev = resolve_device(device)
    xyz, rgb = synthetic.make_gaussian_cloud(n_points, seed=seed,
                                             freq=color_freq)
    params = create_gaussians(xyz, rgb, sh_degree, device=dev)
    rng = np.random.default_rng(seed + 1)
    op = rng.uniform(-1.0, 3.0, (1, n_points)).astype(np.float32)
    dscale = rng.uniform(-0.5, 0.8, (3, n_points)).astype(np.float32)
    rot = rng.standard_normal((4, n_points)).astype(np.float32)
    fields = {k: v.detach() for k, v in params.fields().items()}
    fields["opacity"] = torch.from_numpy(op).to(dev)
    fields["scale"] = fields["scale"] + torch.from_numpy(dscale).to(dev) \
        + scale_shift
    fields["rot"] = torch.from_numpy(rot).to(dev)
    return GaussianModel(**fields), xyz, rgb


def make_task(n_points=600, n_frames=8, img_h=64, img_w=96, sh_degree=2,
              seed=0, init_points=None, color_freq=1.0, device="cuda"):
    """Returns (train_data: CameraBatch, init_xyz, init_color).

    ``init_points`` < n_points subsamples the GT cloud for the model init
    (the SfM-sparse-init regime); ``color_freq`` > 1 sharpens the GT color
    field.
    """
    dev = resolve_device(device)
    cam, frames = synthetic.make_cameras(n_frames, img_h, img_w, seed=seed)
    gt_params, xyz, rgb = make_gt_params(
        n_points, sh_degree, seed, color_freq=color_freq,
        scale_shift=0.0 if n_points < 200_000 else -0.7, device=dev)
    gt_padded = pad_params(gt_params, cfg.round_up(n_points, 128))
    batch = camera_batch_from_frames(
        cam, frames, np.zeros((n_frames, 3, img_h, img_w), np.float32),
        device=dev)
    render_fn = make_eval_render(cfg.PipelineParams(), img_h, img_w,
                                 sh_degree)
    imgs = [render_fn(gt_padded, gt_padded.capacity, batch.view[i],
                      batch.proj[i], batch.planes[i], batch.center[i])[0]
            for i in range(n_frames)]
    data = batch._replace(images=torch.stack(imgs))
    # jitter the init point cloud so the task is non-trivial
    rng = np.random.default_rng(seed + 7)
    if init_points is not None:
        if init_points < xyz.shape[0]:
            keep = rng.choice(xyz.shape[0], size=init_points, replace=False)
            xyz, rgb = xyz[keep], rgb[keep]
        else:
            warnings.warn(
                f"init_points={init_points} >= n_points={xyz.shape[0]}: "
                "no subsampling applied (dense-init regime)")
    init_xyz = xyz + rng.normal(scale=0.01, size=xyz.shape).astype(
        np.float32)
    return data, init_xyz, rgb
