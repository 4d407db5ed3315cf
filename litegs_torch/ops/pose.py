"""Differentiable camera: extrinsics -> view/frustum/center, plus the
sparse per-frame pose optimizer.

The port of ``litegs_tpu/ops/pose.py``: the reference's CreateViewProj
fused op (wrapper.py:772-791, kernel compact.cu:17-316: camera quaternion
+ translation -> view/proj/viewproj/frustum with the quaternion
normalization's gradient) and the pose path of its trainer
(trainer.py:84-122: a per-frame extr embedding trained with SparseAdam,
lr 1e-4; intrinsics stay fixed).  The gradient comes from autograd.

``camera_from_extr`` forms its 4x4 product as an explicit float32 sum, so
no matmul precision setting (TF32) reaches it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import math as um
from ..utils import resolve_device

POSE_LR = 1e-4   # reference trainer.py:89
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def quat_to_rotmat(q):
    """Unit quaternion (w,x,y,z) -> rotation matrix [3,3] (differentiable;
    the formula of utils.math.qvec2rotmat)."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]),
    ])


def camera_from_extr(extr, proj):
    """extr [7] = (qvec wxyz, tvec) -> (view [4,4], planes [6,4],
    center [3]), all differentiable w.r.t. extr (the caller detaches
    planes and center: culling and the SH view directions carry no
    gradient, as the reference's frustum output of CreateViewProj)."""
    q = extr[:4]
    q = q / torch.clamp(torch.linalg.vector_norm(q), min=1e-12)
    t = extr[4:7]
    R = quat_to_rotmat(q)                       # world -> cam
    zero = torch.zeros((3, 1), dtype=extr.dtype, device=extr.device)
    one = torch.ones(1, dtype=extr.dtype, device=extr.device)
    view = torch.cat([torch.cat([R.T, zero], dim=1),       # row-vector form
                      torch.cat([t, one])[None]], dim=0)
    center = -torch.sum(R * t[:, None], dim=0)              # -R^T t
    viewproj = torch.sum(view[:, :, None] * proj[None, :, :], dim=1)
    planes = um.viewproj_to_frustumplane(viewproj)
    return view, planes, center


class PoseState(NamedTuple):
    """Per-frame learnable extrinsics + sparse Adam moments."""

    extr: torch.Tensor   # [F, 7]
    m: torch.Tensor      # [F, 7]
    v: torch.Tensor      # [F, 7]
    step: torch.Tensor   # scalar int32


def init_pose_state(extr_init, device="cuda") -> PoseState:
    dev = resolve_device(device)
    extr = torch.tensor(np.asarray(extr_init, np.float32), device=dev)
    return PoseState(extr=extr, m=torch.zeros_like(extr),
                     v=torch.zeros_like(extr),
                     step=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def sparse_pose_adam(pose: PoseState, frame_idx: int, grad_row,
                     lr: float = POSE_LR) -> PoseState:
    """SparseAdam row update (torch.optim.SparseAdam semantics: only the
    touched row's moments advance; bias correction uses the global step).
    Returns a new PoseState; ``pose`` is left as it was."""
    step = pose.step + 1
    m_row = BETA1 * pose.m[frame_idx] + (1 - BETA1) * grad_row
    v_row = BETA2 * pose.v[frame_idx] + (1 - BETA2) * grad_row * grad_row
    t = step.to(torch.float32)
    corr = torch.sqrt(1 - BETA2 ** t) / (1 - BETA1 ** t)
    upd = lr * corr * m_row / (torch.sqrt(v_row) + EPS)
    extr, m, v = pose.extr.clone(), pose.m.clone(), pose.v.clone()
    extr[frame_idx] -= upd
    m[frame_idx] = m_row
    v[frame_idx] = v_row
    return PoseState(extr=extr, m=m, v=v, step=step)
