"""Image quality metrics: PSNR, SSIM, LPIPS (gated).

PSNR and SSIM are ``ops/losses.py``'s, returned as floats.  LPIPS needs
pretrained VGG weights that this package does not ship: ``lpips_fn`` reads
them from a local file (``ops/lpips.py``) and returns None without one, so
the evaluation reports 'n/a', as the JAX package does.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .ops import losses
from .ops import lpips as lpips_ops


def psnr(img, gt) -> float:
    return float(losses.psnr(torch.as_tensor(img), torch.as_tensor(gt)))


def ssim(img, gt) -> float:
    return float(losses.ssim(torch.as_tensor(img), torch.as_tensor(gt)))


def lpips_fn() -> Optional[Callable]:
    """lpips(img, gt) -> float, or None when no weights are available.

    The weights come from the npz of ``ops.lpips.default_weight_path``
    (env ``LPIPS_WEIGHTS``); a file that lacks a key counts as absent, as
    in the JAX package.  The network is built on the first image's device
    (and on any other device an image arrives on).  There is no fallback
    to the ``lpips`` package.
    """
    try:
        weights = lpips_ops.load_weights()
    except ValueError:
        return None
    if weights is None:
        return None
    nets = {}

    def run(img, gt):
        img = torch.as_tensor(img)
        if img.device not in nets:
            nets[img.device] = lpips_ops.LPIPSVGG(weights, device=img.device)
        gt = torch.as_tensor(gt).to(img.device)
        return float(nets[img.device](img, gt))

    return run
