"""COLMAP sparse-reconstruction loader.

The port of ``litegs_tpu/io/colmap.py`` (numpy only): reads cameras,
images and points3D in COLMAP's binary or text format and produces the
camera/frame objects plus the seed point cloud, mirroring the reference
loader (litegs/io_manager/colmap.py:76-325) including its points3D -> ply
cache behavior (colmap.py:307-320).  Either package reads the other's
cache.
"""
from __future__ import annotations

import os
import struct
import numpy as np

from ..data.camera import FrameInfo, PinholeCamera
from . import ply as ply_io

# COLMAP camera models: id -> (name, #params)
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def _read(f, fmt: str):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def _pinhole_from_params(cam_id, model_name, width, height, params):
    """Focal extraction per model (reference colmap.py:196-247 supports
    SIMPLE_PINHOLE/PINHOLE and warns-and-approximates for radial models)."""
    if model_name == "SIMPLE_PINHOLE":
        fx = fy = params[0]
    elif model_name == "PINHOLE":
        fx, fy = params[0], params[1]
    elif model_name in ("SIMPLE_RADIAL", "RADIAL", "SIMPLE_RADIAL_FISHEYE",
                        "RADIAL_FISHEYE", "FOV"):
        fx = fy = params[0]
    elif model_name in ("OPENCV", "OPENCV_FISHEYE", "FULL_OPENCV",
                        "THIN_PRISM_FISHEYE"):
        fx, fy = params[0], params[1]
    else:
        raise ValueError(f"unsupported COLMAP camera model {model_name}")
    return PinholeCamera(id=cam_id, width=int(width), height=int(height),
                         focal_x=float(fx), focal_y=float(fy))


def read_cameras_binary(path: str) -> dict[int, PinholeCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = _CAMERA_MODELS[model_id]
            params = _read(f, f"<{n_params}d")
            cams[cam_id] = _pinhole_from_params(cam_id, name, w, h, params)
    return cams


def read_cameras_text(path: str) -> dict[int, PinholeCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cam_id, model = int(el[0]), el[1]
            w, h = int(el[2]), int(el[3])
            params = [float(x) for x in el[4:]]
            cams[cam_id] = _pinhole_from_params(cam_id, model, w, h, params)
    return cams


def read_images_binary(path: str) -> list[FrameInfo]:
    frames = []
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<i4d3di")
            image_id, qw, qx, qy, qz, tx, ty, tz, cam_id = vals
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            f.seek(24 * n_pts, os.SEEK_CUR)  # skip 2D points (x,y,id3D)
            frames.append(FrameInfo(
                id=image_id, qvec=np.array([qw, qx, qy, qz]),
                tvec=np.array([tx, ty, tz]), camera_id=cam_id,
                name=name.decode()))
    return frames


def read_images_text(path: str) -> list[FrameInfo]:
    frames = []
    expect_points = False  # every image line is followed by a 2D-point
    with open(path) as f:  # line, which may be empty
        for ln in f:
            s = ln.strip()
            if s.startswith("#"):
                continue
            if expect_points:
                expect_points = False
                continue
            if not s:
                continue
            el = s.split()
            frames.append(FrameInfo(
                id=int(el[0]),
                qvec=np.array([float(x) for x in el[1:5]]),
                tvec=np.array([float(x) for x in el[5:8]]),
                camera_id=int(el[8]), name=el[9]))
            expect_points = True
    return frames


def read_points3d_binary(path: str) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3), np.float32)
        rgb = np.empty((n, 3), np.uint8)
        for i in range(n):
            data = _read(f, "<Q3d3Bd")
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            (track_len,) = _read(f, "<Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return xyz, rgb.astype(np.float32) / 255.0


def read_points3d_text(path: str) -> tuple[np.ndarray, np.ndarray]:
    xyz, rgb = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            xyz.append([float(x) for x in el[1:4]])
            rgb.append([float(x) for x in el[4:7]])
    return (np.asarray(xyz, np.float32),
            np.asarray(rgb, np.float32) / 255.0)


def _sparse_dir(source_path: str) -> str:
    for cand in ("sparse/0", "sparse"):
        d = os.path.join(source_path, cand)
        if os.path.isdir(d):
            return d
    raise FileNotFoundError(f"no COLMAP sparse dir under {source_path}")


def load_frames(source_path: str
                ) -> tuple[dict[int, PinholeCamera], list[FrameInfo]]:
    """Cameras + frames, binary preferred, text fallback
    (reference colmap.py:169-194)."""
    d = _sparse_dir(source_path)
    if os.path.exists(os.path.join(d, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(d, "cameras.bin"))
        frames = read_images_binary(os.path.join(d, "images.bin"))
    else:
        cams = read_cameras_text(os.path.join(d, "cameras.txt"))
        frames = read_images_text(os.path.join(d, "images.txt"))
    frames.sort(key=lambda fr: fr.name)
    return cams, frames


def load_pointcloud(source_path: str) -> tuple[np.ndarray, np.ndarray]:
    """Seed point cloud with the reference's ply caching
    (colmap.py:307-320): points3D.bin is converted to points3D.ply once."""
    d = _sparse_dir(source_path)
    cache = os.path.join(d, "points3D.ply")
    if os.path.exists(cache):
        return ply_io.load_pointcloud_ply(cache)
    if os.path.exists(os.path.join(d, "points3D.bin")):
        xyz, rgb = read_points3d_binary(os.path.join(d, "points3D.bin"))
    else:
        xyz, rgb = read_points3d_text(os.path.join(d, "points3D.txt"))
    try:
        ply_io.save_pointcloud_ply(cache, xyz, rgb)
    except OSError:
        pass  # read-only dataset dir: skip the cache
    return xyz, rgb


def load_colmap_result(source_path: str):
    """(cameras, frames, xyz, rgb) -- reference colmap.py:322-325."""
    cams, frames = load_frames(source_path)
    xyz, rgb = load_pointcloud(source_path)
    return cams, frames, xyz, rgb
