"""Sparse Adam optimizer and learning-rate schedule.

The port of ``litegs_tpu/training/optimizer.py`` (reference
SparseGaussianAdam + Scheduler, litegs/training/optimizer.py:9-95, kernel
compact.cu:320-417), with its semantics:

* plain exponential moving averages, NO bias correction, step =
  -lr * m / (sqrt(v) + eps) with eps (1e-15) outside the sqrt;
* only *visible* chunks are updated -- moments of culled chunks are neither
  decayed nor applied;
* per-group learning rates (optimizer.py:79-86) with the xyz rate following
  a log-linear decay over steps (optimizer.py:54-61), computed in float32.

The update runs in place, under ``torch.no_grad()``, on the parameters'
data and on the moment tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..scene.gaussians import FIELDS, GaussianModel
from ..utils import profiling

BETA1, BETA2 = 0.9, 0.999
EPS = 1e-15


class AdamState(NamedTuple):
    exp_avg: dict       # field name -> tensor shaped like the parameter
    exp_avg_sq: dict


def init_adam(params: GaussianModel) -> AdamState:
    def zeros():
        return {k: torch.zeros_like(v.detach())
                for k, v in params.fields().items()}
    return AdamState(exp_avg=zeros(), exp_avg_sq=zeros())


class LearningRates(NamedTuple):
    """Per-group learning rates; xyz follows the schedule."""

    xyz: float
    scale: float
    rot: float
    sh_0: float
    sh_rest: float
    opacity: float

    @classmethod
    def from_config(cls, op, spatial_lr_scale: float, step: int):
        return cls(
            xyz=xyz_lr(op, spatial_lr_scale, step),
            scale=op.scaling_lr,
            rot=op.rotation_lr,
            sh_0=op.feature_lr,
            sh_rest=op.feature_lr / 10.0,
            opacity=op.opacity_lr,
        )


def xyz_lr(op, spatial_lr_scale: float, step: int) -> float:
    """Log-lerp schedule (reference optimizer.py:54-61): interpolate
    between init and final rates in log space over position_lr_max_steps,
    in float32 as the JAX package does."""
    f32 = np.float32
    t = np.clip(f32(step) / f32(op.position_lr_max_steps), f32(0), f32(1))
    log_lerp = np.exp(f32(math.log(op.position_lr_init * spatial_lr_scale))
                      * (f32(1) - t)
                      + f32(math.log(op.position_lr_final * spatial_lr_scale))
                      * t)
    return float(log_lerp)


@torch.no_grad()
def sparse_adam_step(params: GaussianModel, grads: dict, state: AdamState,
                     lrs: LearningRates, chunk_mask, chunk_size: int):
    """One masked Adam step, in place on ``params`` and ``state``.

    Args:
      grads: field name -> gradient (None counts as zero).
      chunk_mask: [N // chunk_size] bool -- chunks visible this iteration.
    """
    prim_mask = chunk_mask.repeat_interleave(chunk_size)
    for name in FIELDS:
        p = getattr(params, name).data
        m, v = state.exp_avg[name], state.exp_avg_sq[name]
        g = grads.get(name)
        if g is None:
            g = torch.zeros_like(p)
        # a pageable copy to the device: a host wait on the card
        profiling.host_wait("adam.lr_copy")
        lr = torch.tensor(getattr(lrs, name), dtype=p.dtype, device=p.device)
        m_new = BETA1 * m + (1 - BETA1) * g
        v_new = BETA2 * v + (1 - BETA2) * g * g
        step = -lr * m_new / (torch.sqrt(v_new) + EPS)
        mask = prim_mask.expand_as(p)
        m.copy_(torch.where(mask, m_new, m))
        v.copy_(torch.where(mask, v_new, v))
        p.copy_(torch.where(mask, p + step, p))
