"""Camera model and per-frame data (host side, numpy).

The camera stack of ``litegs_tpu/data/camera.py``: DX-style row-vector
matrices, per-frame view matrices and frustum planes, the camera
normalization used for the spatial learning-rate scale, and image loading
with the reference's resize policy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..utils import math as um


@dataclasses.dataclass
class PinholeCamera:
    """Reference PinHoleCameraInfo (litegs/data.py:35-57)."""

    id: int
    width: int
    height: int
    focal_x: float
    focal_y: float
    z_near: float = 0.01
    z_far: float = 5000.0

    @property
    def recp_tan_half_fov_x(self) -> float:
        return self.focal_x / (self.width * 0.5)

    @property
    def recp_tan_half_fov_y(self) -> float:
        return self.focal_y / (self.height * 0.5)

    def proj_matrix(self) -> np.ndarray:
        return um.get_project_matrix(self.z_near, self.z_far,
                                     self.recp_tan_half_fov_x,
                                     self.recp_tan_half_fov_y)

    def scaled(self, width: int, height: int) -> "PinholeCamera":
        sx, sy = width / self.width, height / self.height
        return dataclasses.replace(self, width=width, height=height,
                                   focal_x=self.focal_x * sx,
                                   focal_y=self.focal_y * sy)


@dataclasses.dataclass
class FrameInfo:
    """Reference ImageFrame (litegs/data.py:61-116)."""

    id: int
    qvec: np.ndarray          # COLMAP world->cam rotation quaternion (wxyz)
    tvec: np.ndarray          # COLMAP translation
    camera_id: int
    name: str
    img_source: Optional[str] = None
    image: Optional[np.ndarray] = None   # [3, H, W] uint8 when loaded

    def view_matrix(self) -> np.ndarray:
        R = um.qvec2rotmat(self.qvec)
        return um.get_view_matrix(R, self.tvec)

    def camera_center(self) -> np.ndarray:
        R = um.qvec2rotmat(self.qvec)
        return -R.T @ np.asarray(self.tvec)

    def frustumplane(self, proj_matrix: np.ndarray) -> np.ndarray:
        return um.viewproj_to_frustumplane(self.view_matrix() @ proj_matrix)

    def extr_params(self) -> np.ndarray:
        return np.concatenate([self.qvec, self.tvec]).astype(np.float32)


def camera_dataset_norm(frames: list[FrameInfo]) -> tuple[np.ndarray, float]:
    """Scene translate/radius from camera centers (litegs/data.py:217-234)."""
    centers = np.stack([f.camera_center() for f in frames], axis=1)
    avg = centers.mean(axis=1, keepdims=True)
    diagonal = np.linalg.norm(centers - avg, axis=0).max()
    radius = float(diagonal * 1.1)
    return -avg.flatten(), radius


def load_image(path: str, downsample: int = -1) -> np.ndarray:
    """Load an image as [3, H, W] uint8 with LiteGS's resize policy
    (litegs/data.py:86-110): explicit 1/2/4/8 downsample, or auto-rescale
    widths > 1600 px."""
    import PIL.Image
    image = PIL.Image.open(path)
    orig_w, orig_h = image.size
    if downsample in (1, 2, 4, 8):
        resolution = (round(orig_w / downsample), round(orig_h / downsample))
    else:
        if downsample == -1:
            global_down = orig_w / 1600 if orig_w > 1600 else 1
        else:
            global_down = orig_w / downsample
        scale = float(global_down)
        resolution = (int(orig_w / scale), int(orig_h / scale))
    arr = np.array(image.resize(resolution), dtype=np.uint8)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    return arr[..., :3].transpose(2, 0, 1)
