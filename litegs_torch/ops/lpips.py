"""LPIPS perceptual distance (VGG16 backbone) as a PyTorch module.

The port of ``litegs_tpu/ops/lpips.py``.  The reference evaluates
LPIPS-vgg through torchmetrics (example_metrics.py:95), which downloads
pretrained weights at first use; here the weights load from a local
``.npz`` (env ``LPIPS_WEIGHTS`` or ``~/.cache/litegs_tpu/lpips_vgg.npz``,
the file ``scripts/export_lpips_weights.py`` writes for both packages).
Without the file the metric reports unavailable.

The computation is the standard LPIPS formulation (Zhang et al., CVPR'18,
as the ``lpips`` package implements it, v0.1 with normalize=True): the
input mapped [0,1] -> [-1,1], then the scaling layer; VGG16 conv features
tapped at relu{1_2, 2_2, 3_3, 4_3, 5_3} with 2x2/2 max pools (VALID, so
odd sizes floor); channel unit-normalisation with the eps outside the
sqrt; the squared difference weighted by the learned 1x1 linear weights;
the spatial mean; the sum over taps.

The 3x3 convolutions are ``F.conv2d`` (cuDNN on the card), run with TF32
off: the JAX package asks for full float32 precision, and TF32's ten-bit
mantissa moves the distance by about 1e-3 relative.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import resolve_device

# VGG16 feature config up to conv5_3: channel widths per conv layer, with
# 'M' = 2x2 max pool.  LPIPS taps after the relu preceding each pool (and
# the final relu).
_VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512)
# indices (within conv layers only) after which features are tapped
_TAPS = (1, 3, 6, 9, 12)
N_CONVS = len([c for c in _VGG_CFG if c != "M"])
# lpips ScalingLayer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def default_weight_path() -> str:
    return os.environ.get(
        "LPIPS_WEIGHTS",
        os.path.expanduser("~/.cache/litegs_tpu/lpips_vgg.npz"))


def load_weights(path: Optional[str] = None):
    """{"convs": [(w, b)], "lins": [lin]} as float32 numpy arrays, or None
    when the file is absent.

    Expected npz keys: ``conv{i}_weight`` [out, in, 3, 3] (torch layout),
    ``conv{i}_bias`` [out] for i in 0..12, and ``lin{k}`` [C_k] for k in
    0..4 (the lpips 1x1 calibration weights, squeezed).  A missing key
    raises ValueError.
    """
    path = path or default_weight_path()
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        try:
            convs = [(np.asarray(data[f"conv{i}_weight"], np.float32),
                      np.asarray(data[f"conv{i}_bias"], np.float32))
                     for i in range(N_CONVS)]
            lins = [np.asarray(data[f"lin{k}"], np.float32)
                    for k in range(len(_TAPS))]
        except KeyError as e:
            raise ValueError(f"LPIPS weight file {path} missing key: {e}")
    return {"convs": convs, "lins": lins}


def _full_fp32():
    """cuDNN with TF32 off for the enclosed convolutions, other flags as
    they are."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class LPIPSVGG(nn.Module):
    """LPIPS-vgg between images in [0, 1].

    ``forward(img, gt)`` takes [3, H, W] (returns a 0-d tensor) or
    [B, 3, H, W] (returns [B]); the images are cast to the module's dtype.
    """

    def __init__(self, weights: dict, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.convs = nn.ModuleList()
        for w, b in weights["convs"]:
            conv = nn.Conv2d(w.shape[1], w.shape[0], 3, padding=1)
            conv.weight.data = torch.as_tensor(np.asarray(w, np.float32))
            conv.bias.data = torch.as_tensor(np.asarray(b, np.float32))
            self.convs.append(conv)
        for k, lin in enumerate(weights["lins"]):
            self.register_buffer(f"lin{k}", torch.as_tensor(
                np.asarray(lin, np.float32)).reshape(1, -1, 1, 1))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))
        self.requires_grad_(False)
        self.to(dev)

    def features(self, x):
        """x [B, 3, H, W] in [0, 1] -> the tapped feature maps."""
        x = (2.0 * x - 1.0 - self.shift) / self.scale
        feats = []
        ci = 0
        for c in _VGG_CFG:
            if c == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(self.convs[ci](x))
                if ci in _TAPS:
                    feats.append(x)
                ci += 1
        return feats

    @torch.no_grad()
    def forward(self, img, gt):
        single = img.dim() == 3
        if single:
            img, gt = img[None], gt[None]
        dtype = self.shift.dtype
        with _full_fp32():
            fa = self.features(img.to(dtype))
            fb = self.features(gt.to(dtype))
        total = 0.0
        for k, (a, b) in enumerate(zip(fa, fb)):
            # lpips.normalize_tensor adds eps OUTSIDE the sqrt
            na = a / (torch.sqrt(torch.sum(a * a, dim=1, keepdim=True))
                      + 1e-10)
            nb = b / (torch.sqrt(torch.sum(b * b, dim=1, keepdim=True))
                      + 1e-10)
            d = (na - nb) ** 2
            total = total + torch.sum(getattr(self, f"lin{k}") * d,
                                      dim=1).mean(dim=(1, 2))
        return total[0] if single else total


def lpips_distance(img, gt, module: LPIPSVGG) -> float:
    """LPIPS between two [3, H, W] images in [0, 1]."""
    return float(module(torch.as_tensor(img), torch.as_tensor(gt)))
