"""The benchmark's scene, made from ``--seed``: cameras, target images and
a model with the statistics of a trained one, on the device, in a few
large calls.

Nothing here calls the program: the program is handed these tensors, and
the reference gets the same ones.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SH_C0 = 0.28209479177387814
# parked values of the padded tail of the primitive axis (never rendered)
PAD = {"xyz": 1e8, "scale": -15.0, "rot": 0.0, "sh_0": 0.0, "sh_rest": 0.0,
       "opacity": -30.0}


def _look_at(center):
    """World -> camera rotation rows for a camera at ``center`` looking at
    the origin, +z forward."""
    fwd = -center / np.linalg.norm(center)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(fwd, up)) > 0.95:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd])


def camera_tensors(centers, img_h: int, img_w: int, fov_deg: float,
                   device) -> dict:
    """view [F, 4, 4], proj [F, 4, 4], planes [F, 6, 4], center [F, 3]
    (row-vector matrices, frustum planes left/right/bottom/top/near/far)."""
    focal = (img_w * 0.5) / math.tan(math.radians(fov_deg) / 2)
    rx, ry = focal / (img_w * 0.5), focal / (img_h * 0.5)
    zn, zf = 0.01, 5000.0
    proj = np.array([[rx, 0, 0, 0], [0, ry, 0, 0],
                     [0, 0, zf / (zf - zn), -zf * zn / (zf - zn)],
                     [0, 0, 1, 0]], np.float32).T
    views, planes = [], []
    for c in centers:
        rot = _look_at(c)
        rt = np.eye(4)
        rt[:3, :3] = rot
        rt[:3, 3] = -rot @ c
        view = np.float32(rt.T)
        vp = view @ proj
        col = [vp[:, j] for j in range(4)]
        planes.append(np.stack([col[3] + col[0], col[3] - col[0],
                                col[3] + col[1], col[3] - col[1], col[2],
                                col[3] - col[2]]))
        views.append(view)
    n = len(centers)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return {"view": t(views), "proj": t(np.broadcast_to(proj, (n, 4, 4))),
            "planes": t(planes), "center": t(centers)}


def capture_centers(n: int, radius: float, seed: int):
    """The capture's camera centres: a jittered ring around the scene,
    elevation 37-78 degrees from the pole, all looking at the origin."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        theta = 2 * np.pi * (i / n + 0.1 * rng.random())
        phi = np.arccos(np.clip(0.2 + 0.6 * rng.random(), -1, 1))
        out.append(radius * np.array([np.sin(phi) * np.cos(theta),
                                      np.sin(phi) * np.sin(theta),
                                      np.cos(phi)]))
    return np.array(out)


def orbit_centers(n: int, radius: float, seed: int):
    """A viewer's flight: one turn around the scene at an elevation drawn
    from the seed, with a slow bob and a small jitter per pose."""
    rng = np.random.default_rng(seed)
    start = 2 * np.pi * rng.random()
    phi0 = np.arccos(0.3 + 0.4 * rng.random())
    out = []
    for i in range(n):
        theta = start + 2 * np.pi * i / n + 0.01 * rng.standard_normal()
        phi = phi0 + 0.08 * np.sin(4 * np.pi * i / n)
        r = radius * (1.0 + 0.05 * np.sin(2 * np.pi * i / n))
        out.append(r * np.array([np.sin(phi) * np.cos(theta),
                                 np.sin(phi) * np.sin(theta), np.cos(phi)]))
    return np.array(out)


def spatial_lr_scale(centers) -> float:
    """1.1 times the largest distance of a camera from the cameras' mean
    (3DGS's scene radius)."""
    c = np.asarray(centers)
    return float(np.linalg.norm(c - c.mean(0), axis=1).max() * 1.1)


def targets(n: int, img_h: int, img_w: int, seed: int, device,
            group: int = 16):
    """[n, 3, H, W] float32 in [0, 1]: per view and channel a smooth field
    (two low-frequency waves) with a fine texture (a high-frequency wave
    at a random angle), parameters drawn from the seed on the device."""
    g = torch.Generator(device=device).manual_seed(seed + 1)
    out = torch.empty((n, 3, img_h, img_w), dtype=torch.float32,
                      device=device)
    y = torch.linspace(0, 1, img_h, device=device)[:, None]
    x = torch.linspace(0, 1, img_w, device=device)[None, :]
    for v0 in range(0, n, group):
        k = min(group, n - v0)
        p = torch.rand((k, 3, 8, 1, 1), generator=g, device=device)
        two_pi = 2 * math.pi
        low = (0.5 + 0.25 * torch.sin(two_pi * ((1 + 3 * p[:, :, 0]) * x
                                                 + p[:, :, 1]))
               * torch.cos(two_pi * ((1 + 3 * p[:, :, 2]) * y + p[:, :, 3])))
        ang = two_pi * p[:, :, 4]
        freq = 60 + 80 * p[:, :, 5]
        fine = 0.12 * torch.sin(two_pi * freq * (torch.cos(ang) * x
                                                 + torch.sin(ang) * y)
                                + two_pi * p[:, :, 6])
        out[v0:v0 + k] = torch.clamp(low + fine * p[:, :, 7], 0.0, 1.0)
    return out


def _part_bits(v):
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    return (v | (v << 2)) & 0x9249249


def morton_order(xyz):
    """Stable Z-order of [3, N] positions (10 bits per axis over their
    box), the order a trained model is kept in."""
    lo = xyz.amin(1, keepdim=True)
    span = torch.clamp(xyz.amax(1, keepdim=True) - lo, min=1e-12)
    q = torch.clamp((xyz - lo) / span * 1023, 0, 1023).to(torch.int32)
    code = _part_bits(q[0]) | (_part_bits(q[1]) << 1) | (_part_bits(q[2]) << 2)
    return torch.sort(code, stable=True).indices


def model(active: int, capacity: int, sh_degree: int, seed: int,
          extent: float, device, m: dict) -> dict:
    """Raw parameters [C, capacity] of a model with the statistics of a
    trained one; the first ``active`` primitives are live, Z-ordered.

    ``m`` (the configuration's ``assumed.model``) gives the log-scale
    offset from the density's spacing and its per-axis spread, the share
    and logit means of the opaque and the faint opacities, and the spread
    of the higher SH bands.
    """
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    n = active
    d = randn(3, n)
    d = d * (extent / torch.clamp(torch.linalg.vector_norm(d, dim=0), min=1.0))
    xyz = d * rand(1, n) ** (1.0 / 3.0)
    # spacing of `active` points spread over the ball's volume
    spacing = (4.0 / 3.0 * math.pi * extent ** 3 / n) ** (1.0 / 3.0)
    scale = (math.log(spacing) + m["log_scale_offset"]
             + m["log_scale_spread"] * randn(3, n))
    rot = randn(4, n)
    rot = rot / torch.linalg.vector_norm(rot, dim=0, keepdim=True)
    opaque = rand(n) < m["opaque_share"]
    logit = torch.where(opaque, m["opaque_logit"], m["faint_logit"]) + randn(n)
    x, y, z = xyz
    rgb = torch.stack([
        0.5 + 0.38 * torch.sin(2.1 * x + 0.3) * torch.cos(1.7 * z),
        0.5 + 0.38 * torch.sin(1.3 * y + 1.1) * torch.cos(2.3 * x),
        0.5 + 0.38 * torch.sin(1.9 * z + 2.0) * torch.cos(1.1 * y)])
    rgb = torch.clamp(rgb + 0.05 * randn(3, n), 0.0, 1.0)
    k = (sh_degree + 1) ** 2 - 1
    live = {"xyz": xyz, "scale": scale, "rot": rot,
            "sh_0": ((rgb - 0.5) / SH_C0)[None],
            "sh_rest": m["sh_rest_spread"] * randn(3 * k, n),
            "opacity": logit[None]}
    order = morton_order(xyz)
    out = {}
    for key, v in live.items():
        full = torch.full((*v.shape[:-1], capacity), PAD[key],
                          dtype=torch.float32, device=device)
        if key == "rot":
            full[0] = 1.0
        full[..., :n] = v[..., order]
        out[key] = full.contiguous()
    return out


def to_host(raw: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in raw.items()}
