"""Plain reference of LiteGS's training step: render, L1 + SSIM, the
gradients by autograd (the blend in blocks of whole tiles), and sparse
Adam over the visible chunks.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import render as R
from . import statistics as S

FIELDS = ("xyz", "scale", "rot", "sh_0", "sh_rest", "opacity")
BETA1, BETA2, EPS = 0.9, 0.999, 1e-15


def _window(size: int = 11, sigma: float = 1.5):
    xs = np.arange(size) - size // 2
    g = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return [float(v) for v in (g / g.sum()).astype(np.float32)]


def _blur(img, win):
    """Separable zero-padded Gaussian blur of [C, H, W] (shift and add,
    float32 throughout)."""
    r = len(win) // 2

    def axis(x, dim):
        pad = (r, r, 0, 0) if dim == 2 else (0, 0, r, r)
        xp = F.pad(x, pad)
        n = x.shape[dim]
        acc = None
        for i, w in enumerate(win):
            term = xp.narrow(dim, i, n) * w
            acc = term if acc is None else acc + term
        return acc

    return axis(axis(img, 1), 2)


def ssim(img, gt):
    """Mean SSIM: 11x11 Gaussian window, sigma 1.5, C1 = 0.01^2,
    C2 = 0.03^2, zero padding."""
    win = _window()
    mx, my = _blur(img, win), _blur(gt, win)
    sx = _blur(img * img, win) - mx * mx
    sy = _blur(gt * gt, win) - my * my
    sxy = _blur(img * gt, win) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mx * my + c1) * (2 * sxy + c2))
            / ((mx * mx + my * my + c1) * (sx + sy + c2))).mean()


def loss_fn(img, gt, lambda_dssim: float):
    return ((1.0 - lambda_dssim) * (img - gt).abs().mean()
            + lambda_dssim * (1.0 - ssim(img, gt)))


def xyz_lr(lr_init: float, lr_final: float, max_steps: int, scale: float,
           step: int) -> float:
    """Log-linear decay of the position learning rate, in float32."""
    f = np.float32
    t = np.clip(f(step) / f(max_steps), f(0), f(1))
    return float(np.exp(f(math.log(lr_init * scale)) * (f(1) - t)
                        + f(math.log(lr_final * scale)) * t))


def learning_rates(opt: dict, spatial_scale: float, step: int) -> dict:
    return {"xyz": xyz_lr(opt["position_lr_init"], opt["position_lr_final"],
                          opt["position_lr_max_steps"], spatial_scale, step),
            "scale": opt["scaling_lr"], "rot": opt["rotation_lr"],
            "sh_0": opt["feature_lr"], "sh_rest": opt["feature_lr"] / 10.0,
            "opacity": opt["opacity_lr"]}


def grads(raw, active: int, cam, gt, sh_degree: int, img_h: int, img_w: int,
          tile: tuple, chunk: int, lambda_dssim: float, max_pairs: int,
          low=None, loss_rows=None, stats=None):
    """(loss, {field: gradient}, visible chunk ids) of one view.

    The blend runs twice per block: once without autograd for the image
    the loss needs, then with autograd to carry the loss's gradient of
    that block's tiles back to the points; autograd takes it on through
    projection, SH and activation to the raw parameters.  ``loss_rows``
    takes the loss over the image's first rows only (a planted fault).
    ``stats`` (a dict of ``statistics.zeros``) gets the view's
    statistics added, from the same blend and backward.
    """
    tile_h, tile_w = tile
    leaves = {k: v.detach().requires_grad_(True) for k, v in raw.items()}
    vis = R.preprocess(leaves, active, cam, sh_degree, chunk)
    proj = R.project(vis, cam, img_h, img_w)
    table = R.bin_tiles(proj, vis.opacity, img_h, img_w, tile_h, tile_w)
    _, tiles = R.render_view(vis, proj, table, img_h, img_w, tile_h, tile_w,
                             max_pairs, low=low)
    tiles.requires_grad_(True)
    img = torch.clamp(R.tiles_to_img(tiles, img_h, img_w, tile_h, tile_w),
                      0.0, 1.0)
    rows = img_h if loss_rows is None else loss_rows
    loss = loss_fn(img[:, :rows], gt[:, :rows], lambda_dssim)
    (d_tiles,) = torch.autograd.grad(loss, [tiles])
    pts = [t.detach().requires_grad_(True) for t in
           (proj.mean_pix, proj.inv_cov, vis.color, vis.opacity)]
    tiles_x = math.ceil(img_w / tile_w)
    sums = None if stats is None else S.view_sums(pts[3].shape[0],
                                                  pts[3].device)
    for t0, t1 in R.tile_blocks(table, max_pairs, tile_h * tile_w):
        out = R.blend_block(table, t0, t1, *pts, tile_w, tile_h, tiles_x,
                            low=low, pairs=stats is not None)
        if stats is not None:
            sp, raw, weight = out[2]
            raw.retain_grad()
        out[0].backward(d_tiles[t0:t1])
        if stats is not None:
            S.add_pairs(sums, sp, raw.detach(), raw.grad, weight.detach(),
                        pts[3].detach())
    if stats is not None:
        touched = torch.bincount(table.point, minlength=sums.shape[1]) > 0
        d_mean = (pts[0].grad if pts[0].grad is not None
                  else torch.zeros_like(pts[0]))
        S.add_view(stats, vis.ids, chunk, touched, sums, d_mean, img_h, img_w)
    outs = [proj.mean_pix, proj.inv_cov, vis.color, vis.opacity]
    torch.autograd.backward(outs, [p.grad if p.grad is not None
                                   else torch.zeros_like(p) for p in pts])
    g = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
         for k, v in leaves.items()}
    return loss.detach(), g, vis.ids


@torch.no_grad()
def adam(raw, m, v, g, lrs: dict, chunk_ids, chunk: int):
    """Adam without bias correction, step -lr m / (sqrt(v) + 1e-15), on
    the primitives of the visible chunks only, in place."""
    n = raw["xyz"].shape[-1]
    mask = torch.zeros(n // chunk, dtype=torch.bool, device=raw["xyz"].device)
    mask[chunk_ids] = True
    mask = mask.repeat_interleave(chunk)
    for k in FIELDS:
        m_new = BETA1 * m[k] + (1 - BETA1) * g[k]
        v_new = BETA2 * v[k] + (1 - BETA2) * g[k] * g[k]
        upd = -torch.tensor(lrs[k], dtype=raw[k].dtype,
                            device=raw[k].device) * m_new / (torch.sqrt(v_new) + EPS)
        sel = mask.expand_as(raw[k])
        m[k].copy_(torch.where(sel, m_new, m[k]))
        v[k].copy_(torch.where(sel, v_new, v[k]))
        raw[k].copy_(torch.where(sel, raw[k] + upd, raw[k]))


def run_steps(raw, active: int, cams, gts, step0: int, sh_degree: int,
              img_h: int, img_w: int, tile: tuple, chunk: int, opt: dict,
              spatial_scale: float, max_pairs: int, low=None, fault=None,
              first_stats=None):
    """Train ``len(cams)`` steps from ``raw`` with zero moments, in place.

    Returns (losses, the first step's gradients).  ``fault`` (a name in
    ``FAULTS``) plants one of the faults the comparison has to catch;
    ``first_stats`` gets the first step's statistics (``grads``).
    """
    m = {k: torch.zeros_like(v) for k, v in raw.items()}
    v = {k: torch.zeros_like(x) for k, x in raw.items()}
    losses, first = [], None
    for i, (cam, gt) in enumerate(zip(cams, gts)):
        loss, g, ids = grads(
            raw, active, cam, gt, sh_degree, img_h, img_w, tile, chunk,
            opt["lambda_dssim"], max_pairs, low=low,
            loss_rows=img_h // 2 if fault == "half_batch" else None,
            stats=first_stats if i == 0 else None)
        if fault == "colour_grad_doubled":
            g["sh_0"], g["sh_rest"] = 2 * g["sh_0"], 2 * g["sh_rest"]
        losses.append(float(loss))
        if first is None:
            first = {k: x.detach().clone() for k, x in g.items()}
        if fault != "state_unchanged":
            adam(raw, m, v, g, learning_rates(opt, spatial_scale, step0 + i),
                 ids, chunk)
    return losses, first


FAULTS = ("state_unchanged", "half_batch", "colour_grad_doubled")
