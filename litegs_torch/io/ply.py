"""3DGS-standard PLY model import/export.

The port of ``litegs_tpu/io/ply.py``, byte-compatible with it, with the
reference (litegs/io_manager/ply.py:7-87) and with the wider 3DGS
ecosystem: binary_little_endian PLY with per-vertex properties x, y, z,
nx, ny, nz, f_dc_0..2, f_rest_0..(3K-1), opacity, scale_0..2, rot_0..3.
On disk attributes are channel-last; in memory the model is channel-first
[C, N] (transposed on load/save exactly like the reference, ply.py:80-85).

Self-contained reader/writer (no ``plyfile``); handles the
binary_little_endian float32 layout every 3DGS tool emits, plus ascii as a
fallback.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..scene.gaussians import GaussianModel, params_from_numpy
from ..utils import resolve_device


def _property_names(sh_degree: int) -> list[str]:
    n_rest = ((sh_degree + 1) ** 2 - 1) * 3
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(n_rest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def save_ply(path: str, params: GaussianModel,
             active_count: Optional[int] = None) -> None:
    """Write raw (pre-activation) gaussian parameters as a standard ply.

    Matches the reference's attribute order and the channel transpose
    (ply.py:7-45).  sh_rest is stored coefficient-major ([K, 3] flattened
    K*3), the 3DGS convention.  Only the first ``active_count`` primitives
    are copied to the host.
    """
    n = params.capacity if active_count is None else int(active_count)

    def host(t):
        return t.detach()[..., :n].cpu().numpy()

    xyz = host(params.xyz).T                                     # [N, 3]
    normals = np.zeros_like(xyz)
    f_dc = host(params.sh_0)[0].T                                # [N, 3]
    k = params.sh_rest.shape[0] // 3
    # flat [K*3, N] -> [K, 3, N] -> [N, 3, K] -> [N, 3K] channel-major
    # like the reference (ply.py:20-23: transpose(1,2).flatten -> [N, 3*K]
    # with rgb-major)
    f_rest = host(params.sh_rest).reshape(k, 3, n)
    f_rest = f_rest.transpose(2, 1, 0).reshape(n, 3 * k)
    opacity = host(params.opacity).T                             # [N, 1]
    scale = host(params.scale).T                                 # [N, 3]
    rot = host(params.rot).T                                     # [N, 4]

    attrs = np.concatenate(
        [xyz, normals, f_dc, f_rest, opacity, scale, rot],
        axis=1).astype("<f4")
    names = _property_names(params.sh_degree)
    if attrs.shape[1] != len(names):
        raise ValueError(f"{attrs.shape[1]} columns for {len(names)} "
                         "properties")

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {p}" for p in names]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(attrs.tobytes())


def _parse_header(f):
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a ply file")
    fmt = None
    n_vertex = 0
    props = []
    saw_vertex = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated ply header")
        tokens = line.strip().split()
        if not tokens:
            continue
        if tokens[0] == b"format":
            fmt = tokens[1].decode()
        elif tokens[0] == b"element":
            if tokens[1] == b"vertex":
                n_vertex = int(tokens[2])
                saw_vertex = True
            elif saw_vertex:
                break  # vertex properties complete; later elements ignored
            else:
                # the binary reader consumes vertex records from the start
                # of the data section, so a ply whose first element is not
                # vertex would be silently misparsed -- refuse instead
                raise ValueError(
                    "ply parser requires the vertex element first "
                    f"(found 'element {tokens[1].decode()}')")
        elif tokens[0] == b"property" and saw_vertex:
            props.append((tokens[1].decode(), tokens[2].decode()))
        elif tokens[0] == b"end_header":
            break
    return fmt, n_vertex, props


_DTYPES = {"float": "<f4", "float32": "<f4", "double": "<f8",
           "uchar": "u1", "uint8": "u1", "char": "i1", "short": "<i2",
           "ushort": "<u2", "int": "<i4", "uint": "<u4"}


def read_ply_vertices(path: str) -> dict[str, np.ndarray]:
    """Read the vertex element of a ply file into {property: [N] array}."""
    with open(path, "rb") as f:
        fmt, n, props = _parse_header(f)
        dtype = np.dtype([(name, _DTYPES[ty]) for ty, name in props])
        if fmt == "binary_little_endian":
            data = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype,
                                 count=n)
        elif fmt == "ascii":
            raw = np.loadtxt(f, max_rows=n, ndmin=2)
            data = np.zeros(n, dtype=dtype)
            for i, (_, name) in enumerate(props):
                data[name] = raw[:, i]
        else:
            raise ValueError(f"unsupported ply format {fmt}")
    return {name: np.asarray(data[name]) for _, name in props}


def load_ply(path: str, device="cuda") -> GaussianModel:
    """Load a 3DGS ply into a channel-first GaussianModel on ``device``
    (ply.py:47-87).  Its capacity is the file's vertex count."""
    device = resolve_device(device)
    v = read_ply_vertices(path)
    n = v["x"].shape[0]
    xyz = np.stack([v["x"], v["y"], v["z"]]).astype(np.float32)
    sh_0 = np.stack([v[f"f_dc_{i}"] for i in range(3)]).astype(
        np.float32)[None]                                         # [1, 3, N]
    n_rest = len([k for k in v if k.startswith("f_rest_")])
    k = n_rest // 3
    if n_rest:
        rest = np.stack([v[f"f_rest_{i}"] for i in range(n_rest)])
        sh_rest = rest.reshape(3, k, n).transpose(1, 0, 2).reshape(
            k * 3, n).astype(np.float32)                   # flat [K*3, N]
    else:
        sh_rest = np.zeros((0, n), np.float32)
    opacity = v["opacity"][None].astype(np.float32)
    scale = np.stack([v[f"scale_{i}"] for i in range(3)]).astype(np.float32)
    rot = np.stack([v[f"rot_{i}"] for i in range(4)]).astype(np.float32)
    return params_from_numpy(dict(xyz=xyz, scale=scale, rot=rot, sh_0=sh_0,
                                  sh_rest=sh_rest, opacity=opacity),
                             device=device)


def save_pointcloud_ply(path: str, xyz: np.ndarray,
                        rgb: np.ndarray) -> None:
    """Seed point-cloud cache ply (x,y,z,red,green,blue), the format the
    reference writes for points3D (colmap.py:307-320)."""
    n = xyz.shape[0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z",
              "property uchar red", "property uchar green",
              "property uchar blue", "end_header"]
    dtype = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                      ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    data = np.zeros(n, dtype=dtype)
    data["x"], data["y"], data["z"] = xyz.T.astype(np.float32)
    rgb8 = np.clip(rgb * 255.0 if rgb.dtype.kind == "f" else rgb,
                   0, 255).astype(np.uint8)
    data["red"], data["green"], data["blue"] = rgb8.T
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.tobytes())


def load_pointcloud_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load a seed point cloud: returns (xyz [N,3] f32, rgb [N,3] f32)."""
    v = read_ply_vertices(path)
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    rgb = np.stack([v["red"], v["green"], v["blue"]], axis=1)
    if rgb.dtype == np.uint8:
        rgb = rgb.astype(np.float32) / 255.0
    return xyz, rgb.astype(np.float32)
