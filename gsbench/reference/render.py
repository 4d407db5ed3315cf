"""Plain reference of one view's render: cull, activate, SH, project,
bin, blend.

Channel-first [C, N] tensors.  Raw parameters are a dict of
``xyz [3, N]``, ``scale [3, N]`` (log), ``rot [4, N]`` (w, x, y, z),
``sh_0 [1, 3, N]``, ``sh_rest [3 K, N]`` (band-major) and ``opacity
[1, N]`` (logit).  Cameras use row-vector matrices: ``p_view = p_h @ V``,
``p_clip = p_view @ P``.  The blend runs over groups of whole tiles
(:func:`tile_blocks`) so that a full-size view fits in the card's memory.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

ALPHA_MIN = 1.0 / 256.0
ALPHA_MAX = 255.0 / 256.0
T_MIN = 1.0 / 8192.0
# sqrt(2 ln 255): a chunk's box holds every point to alpha 1/255
EXTEND = math.sqrt(2.0 * math.log(255.0))
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


# -- activation, culling -------------------------------------------------

def rotation_rows(q):
    """Unit quaternion [4, N] -> the rows of R as [3, 3, N] (row-vector
    convention: a point's offset is eps @ R)."""
    r, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y + r * z),
                     2 * (x * z - r * y)]),
        torch.stack([2 * (x * y - r * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z + r * x)]),
        torch.stack([2 * (x * z + r * y), 2 * (y * z - r * x),
                     1 - 2 * (x * x + y * y)])])


def unit_quat(rot):
    norm = torch.sqrt(torch.sum(rot ** 2, dim=0, keepdim=True))
    return rot / torch.clamp(norm, min=1e-12)


def chunk_boxes(raw, active: int, chunk: int):
    """Per-chunk AABB (centre, half-extent) of the live chunks; chunks
    past ``active`` are pushed out of every frustum."""
    m = rotation_rows(unit_quat(raw["rot"])) * torch.exp(raw["scale"])[:, None]
    ext = torch.sum(m.abs(), dim=0) * EXTEND
    hi = (raw["xyz"] + ext).reshape(3, -1, chunk).amax(-1)
    lo = (raw["xyz"] - ext).reshape(3, -1, chunk).amin(-1)
    origin, half = (hi + lo) * 0.5, (hi - lo) * 0.5
    live = torch.arange(origin.shape[1], device=origin.device) < active // chunk
    return (torch.where(live, origin, torch.full_like(origin, 1e9)),
            torch.where(live, half, torch.zeros_like(half)))


def visible_chunks(planes, origin, half):
    """Ids of chunks whose box is not wholly behind one frustum plane."""
    normals, d = planes[:, :3], planes[:, 3]
    pushed = normals @ origin + normals.abs() @ half + d[:, None]
    return torch.nonzero(~torch.any(pushed < 0, dim=0)).flatten()


def gather(arr, ids, chunk: int):
    lead = arr.shape[:-1]
    c = arr.reshape(*lead, arr.shape[-1] // chunk, chunk)
    return torch.index_select(c, len(lead), ids).reshape(*lead, -1)


def sh_color(deg: int, sh0, rest, dirs):
    """SH degrees 0-3 at unit directions, +0.5, clamped at 0."""
    if not 0 <= deg <= 3:
        raise ValueError(f"SH degree {deg} not in 0..3")
    band = [sh0[0]] + [rest[3 * k:3 * k + 3] for k in range(rest.shape[0] // 3)]
    out = SH_C0 * band[0]
    if deg > 0:
        x, y, z = dirs[0][None], dirs[1][None], dirs[2][None]
        out = out - SH_C1 * y * band[1] + SH_C1 * z * band[2] - SH_C1 * x * band[3]
        if deg > 1:
            xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
            out = (out + SH_C2[0] * xy * band[4] + SH_C2[1] * yz * band[5]
                   + SH_C2[2] * (2.0 * zz - xx - yy) * band[6]
                   + SH_C2[3] * xz * band[7] + SH_C2[4] * (xx - yy) * band[8])
            if deg > 2:
                out = (out + SH_C3[0] * y * (3 * xx - yy) * band[9]
                       + SH_C3[1] * xy * z * band[10]
                       + SH_C3[2] * y * (4 * zz - xx - yy) * band[11]
                       + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * band[12]
                       + SH_C3[4] * x * (4 * zz - xx - yy) * band[13]
                       + SH_C3[5] * z * (xx - yy) * band[14]
                       + SH_C3[6] * x * (xx - 3 * yy) * band[15])
    return torch.clamp(out + 0.5, min=0.0)


class Visible(NamedTuple):
    """The visible chunks' points, activated (differentiable from raw)."""

    ids: torch.Tensor      # [V] chunk ids
    xyz: torch.Tensor      # [3, M]
    scale: torch.Tensor    # [3, M]
    rot: torch.Tensor      # [4, M] unit
    color: torch.Tensor    # [3, M]
    opacity: torch.Tensor  # [M]


def preprocess(raw, active: int, cam, sh_degree: int, chunk: int) -> Visible:
    with torch.no_grad():
        origin, half = chunk_boxes({k: v.detach() for k, v in raw.items()},
                                   active, chunk)
        ids = visible_chunks(cam["planes"], origin, half)
    xyz = gather(raw["xyz"], ids, chunk)
    dirs = xyz.detach() - cam["center"][:, None]
    dirs = dirs / torch.clamp(torch.sqrt(torch.sum(dirs ** 2, 0, keepdim=True)),
                              min=1e-12)
    color = sh_color(sh_degree, gather(raw["sh_0"], ids, chunk),
                     gather(raw["sh_rest"], ids, chunk), dirs)
    return Visible(ids, xyz, torch.exp(gather(raw["scale"], ids, chunk)),
                   unit_quat(gather(raw["rot"], ids, chunk)), color,
                   torch.sigmoid(gather(raw["opacity"], ids, chunk)[0]))


# -- projection ------------------------------------------------------------

class Projected(NamedTuple):
    ndc: torch.Tensor       # [2, M]
    depth: torch.Tensor     # [M] view-space z
    mean_pix: torch.Tensor  # [2, M]
    inv_cov: torch.Tensor   # [3, M] (a, b, c) of the inverse 2-D covariance


def project(vis: Visible, cam, img_h: int, img_w: int) -> Projected:
    """EWA projection: view and clip transforms, the ray-space Jacobian
    (not differentiated, clamped to 1.3 times the frustum and z >= 0.01),
    cov2d = T M^T M T^T + 0.3 I, its inverse (0 where |det| <= 1e-12)."""
    view, proj = cam["view"], cam["proj"]
    xyz_h = torch.cat([vis.xyz, torch.ones_like(vis.xyz[:1])])
    vpos = view.T @ xyz_h
    hom = proj.T @ vpos
    w = hom[3]
    inv_w = torch.where(w.abs() > 1e-12,
                        1.0 / torch.where(w == 0, torch.ones_like(w), w),
                        torch.zeros_like(w))
    ndc = hom[:2] * inv_w
    with torch.no_grad():
        fx, fy = proj[0, 0] * img_w * 0.5, proj[1, 1] * img_h * 0.5
        tz = vpos[2]
        lx, ly = tz / proj[0, 0] * 1.3, tz / proj[1, 1] * 1.3
        tx = torch.minimum(torch.maximum(vpos[0], -lx), lx)
        ty = torch.minimum(torch.maximum(vpos[1], -ly), ly)
        rz = 1.0 / torch.clamp(tz, min=1e-2)
        j00, j11 = fx * rz, fy * rz
        j20, j21 = -fx * tx * rz * rz, -fy * ty * rz * rz
    m = rotation_rows(vis.rot) * vis.scale[:, None]        # M[j][k]
    v3 = view[:3, :3]
    t = [[j00 * v3[k, 0] + j20 * v3[k, 2] for k in range(3)],
         [j11 * v3[k, 1] + j21 * v3[k, 2] for k in range(3)]]
    m2 = [[t[u][0] * m[j][0] + t[u][1] * m[j][1] + t[u][2] * m[j][2]
           for j in range(3)] for u in range(2)]
    a = m2[0][0] ** 2 + m2[0][1] ** 2 + m2[0][2] ** 2 + 0.3
    b = m2[0][0] * m2[1][0] + m2[0][1] * m2[1][1] + m2[0][2] * m2[1][2]
    c = m2[1][0] ** 2 + m2[1][1] ** 2 + m2[1][2] ** 2 + 0.3
    det = a * c - b * b
    inv_det = torch.where(det.abs() > 1e-12,
                          1.0 / torch.where(det == 0, torch.ones_like(det), det),
                          torch.zeros_like(det))
    mean_pix = torch.stack([(ndc[0] * 0.5 + 0.5) * img_w - 0.5,
                            (ndc[1] * 0.5 + 0.5) * img_h - 0.5])
    return Projected(ndc, vpos[2], mean_pix,
                     torch.stack([c * inv_det, -b * inv_det, a * inv_det]))


# -- binning ---------------------------------------------------------------

class Table(NamedTuple):
    point: torch.Tensor       # [E] point of each entry, tile-major, depth order
    tile: torch.Tensor        # [E] tile of each entry
    tile_start: torch.Tensor  # [T]
    tile_count: torch.Tensor  # [T]


def _i32(x):
    return torch.clamp(x, -float(1 << 30), float(1 << 30)).to(torch.int32)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _x_span(px, py, a, b, c, t, disc, y0, y1):
    """x-extent of the ellipse {q <= t} inside the band y0 <= y <= y1."""
    dy = torch.sqrt(torch.clamp(-t * a / disc, min=0.0))
    h0 = torch.minimum(torch.maximum(y0 - py, -dy), dy)
    h1 = torch.minimum(torch.maximum(y1 - py, -dy), dy)
    dx = torch.sqrt(torch.clamp(-t * c / disc, min=0.0))
    hx = (b / c) * dx
    e_min = torch.minimum(torch.maximum(hx, h0), h1)
    e_max = torch.minimum(torch.maximum(-hx, h0), h1)
    s_min = torch.sqrt(torch.clamp(disc * e_min * e_min + t * a, min=0.0))
    s_max = torch.sqrt(torch.clamp(disc * e_max * e_max + t * a, min=0.0))
    return px + (-b * e_min - s_min) / a, px + (-b * e_max + s_max) / a


def _y_span(px, py, a, b, c, t, disc, x0, x1):
    """y-extent of the ellipse {q <= t} inside the band x0 <= x <= x1."""
    dx = torch.sqrt(torch.clamp(-t * c / disc, min=0.0))
    e0 = torch.minimum(torch.maximum(x0 - px, -dx), dx)
    e1 = torch.minimum(torch.maximum(x1 - px, -dx), dx)
    dy = torch.sqrt(torch.clamp(-t * a / disc, min=0.0))
    ey = (b / a) * dy
    e_min = torch.minimum(torch.maximum(ey, e0), e1)
    e_max = torch.minimum(torch.maximum(-ey, e0), e1)
    s_min = torch.sqrt(torch.clamp(disc * e_min * e_min + t * c, min=0.0))
    s_max = torch.sqrt(torch.clamp(disc * e_max * e_max + t * c, min=0.0))
    return py + (-b * e_min - s_min) / c, py + (-b * e_max + s_max) / c


@torch.no_grad()
def bin_tiles(p: Projected, opacity, img_h: int, img_w: int, tile_h: int,
              tile_w: int) -> Table:
    """Every (point, tile) whose tile box the ellipse o exp(-q/2) >= 1/255
    touches, for points inside 1.3x the NDC box, in front of z = 0.2 and
    with a positive-definite inverse covariance; grouped by tile, in depth
    order within a tile (stable)."""
    dev = opacity.device
    tiles_x, tiles_y = math.ceil(img_w / tile_w), math.ceil(img_h / tile_h)
    ndc, z, ic = p.ndc.detach(), p.depth.detach(), p.inv_cov.detach()
    a, b, c = ic[0], ic[1], ic[2]
    disc = b * b - a * c
    op = opacity.detach()
    vis = ((ndc[0].abs() <= 1.3) & (ndc[1].abs() <= 1.3) & (z > 0.2)
           & (op >= 1.0 / 255.0) & (a > 0) & (c > 0) & (disc < 0))
    px = (ndc[0] * 0.5 + 0.5) * img_w - 0.5
    py = (ndc[1] * 0.5 + 0.5) * img_h - 0.5
    t = 2.0 * torch.log(torch.clamp(op, min=1e-12) * 255.0)
    one = torch.ones_like(a)
    a = torch.where(vis, a, one)
    c = torch.where(vis, c, one)
    disc = torch.where(vis, disc, -one)
    t = torch.where(vis, t, torch.zeros_like(t))
    dx = torch.sqrt(torch.clamp(-t * c / disc, min=0.0))
    dy = torch.sqrt(torch.clamp(-t * a / disc, min=0.0))
    x0 = torch.clamp(torch.floor((px - dx) / tile_w), 0, tiles_x).to(torch.int32)
    x1 = torch.clamp(torch.floor((px + dx + tile_w - 1) / tile_w), 0,
                     tiles_x).to(torch.int32)
    y0 = torch.clamp(torch.floor((py - dy) / tile_h), 0, tiles_y).to(torch.int32)
    y1 = torch.clamp(torch.floor((py + dy + tile_h - 1) / tile_h), 0,
                     tiles_y).to(torch.int32)
    ylo, yhi = _y_span(px, py, a, b, c, t, disc, x0.float() * tile_w,
                       x1.float() * tile_w)
    r0 = _clip(_i32(torch.floor(ylo / tile_h)), y0, y1)
    r1 = _clip(_i32(torch.floor(yhi / tile_h)) + 1, y0, y1)
    nrows = torch.where(vis & (x1 > x0), torch.clamp(r1 - r0, min=0),
                        torch.zeros_like(r0))
    key = torch.where(vis & (nrows > 0), z, torch.full_like(z, float("inf")))
    order = torch.sort(key, stable=True).indices
    nrows = nrows[order].long()
    row_pt = torch.repeat_interleave(order, nrows)
    first = torch.cumsum(nrows, 0) - nrows
    row_y = (r0[row_pt] + torch.arange(row_pt.numel(), device=dev)
             - torch.repeat_interleave(first, nrows)).to(torch.int32)
    xlo, xhi = _x_span(px[row_pt], py[row_pt], a[row_pt], b[row_pt],
                       c[row_pt], t[row_pt], disc[row_pt],
                       row_y.float() * tile_h, (row_y + 1).float() * tile_h)
    tmin = _clip(_i32(torch.floor(xlo / tile_w)), x0[row_pt], x1[row_pt])
    tmax = _clip(_i32(torch.floor(xhi / tile_w)) + 1, x0[row_pt], x1[row_pt])
    ntiles = torch.clamp(tmax - tmin, min=0).long()
    ent_row = torch.repeat_interleave(torch.arange(row_pt.numel(), device=dev),
                                      ntiles)
    efirst = torch.cumsum(ntiles, 0) - ntiles
    rank = torch.arange(ent_row.numel(), device=dev) - efirst[ent_row]
    tile = row_y.long()[ent_row] * tiles_x + tmin.long()[ent_row] + rank
    tile, perm = torch.sort(tile, stable=True)
    count = torch.bincount(tile, minlength=tiles_x * tiles_y)
    return Table(row_pt[ent_row][perm], tile, torch.cumsum(count, 0) - count,
                 count)


# -- blending ----------------------------------------------------------------

def tile_blocks(table: Table, max_pairs: int, npix: int):
    """Consecutive tile ranges [t0, t1) of at most ``max_pairs`` (entry,
    pixel) pairs each (a tile alone may exceed it)."""
    limit = max(max_pairs // npix, 1)
    ends = torch.cumsum(table.tile_count, 0).cpu()
    out, t0, done = [], 0, 0
    n = ends.numel()
    while t0 < n:
        t1 = int(torch.searchsorted(ends, done + limit, right=True))
        t1 = max(t1, t0 + 1)
        out.append((t0, t1))
        done = int(ends[t1 - 1])
        t0 = t1
    return out


def blend_block(table: Table, t0: int, t1: int, mean_pix, inv_cov, color,
                opacity, tile_w: int, tile_h: int, tiles_x: int,
                low=None, counts=False, pairs=False):
    """Front-to-back blend of the tiles [t0, t1) (differentiable).

    alpha = min(o exp(-q/2), 255/256), straight-through at the clamp,
    dropped below 1/256; a pixel takes entries while its transmittance
    before them is above 1/8192.  Running sums along the entries are
    taken in float64, pixel-major ([P, E]) so that each is a scan along
    contiguous memory.  ``low`` (a dtype) rounds the per-point inputs and
    each pair's alpha to that type, as a kernel computing in it would.
    Returns (colour [t1 - t0, C, P], transmittance [t1 - t0, P]) and with
    ``counts`` also (contributing pairs, entries up to the tile's last
    stop, the points of those entries) as (int, int, point ids), or with
    ``pairs`` (each entry's point [E], each pair's unclamped alpha
    o exp(-q/2) [P, E], its blend weight alpha T [P, E], 0 where the pair
    does not contribute): the per-pair values the statistics sum.
    """
    e0 = int(table.tile_start[t0])
    e1 = int(table.tile_start[t1 - 1] + table.tile_count[t1 - 1])
    sp = table.point[e0:e1]
    tl = table.tile[e0:e1]
    npix = tile_h * tile_w
    if low is not None:
        inv_cov, color, opacity = (x.to(low).to(x.dtype)
                                   for x in (inv_cov, color, opacity))
    pix = torch.arange(npix, device=sp.device)
    px = ((tl % tiles_x)[None] * tile_w + (pix % tile_w)[:, None]).float()
    py = ((tl // tiles_x)[None] * tile_h + (pix // tile_w)[:, None]).float()
    dx = mean_pix[0][sp][None] - px
    dy = mean_pix[1][sp][None] - py
    a, b, c = (inv_cov[i][sp][None] for i in range(3))
    power = -0.5 * (a * dx * dx + 2.0 * b * dx * dy + c * dy * dy)
    raw = opacity[sp][None] * torch.exp(power)
    if low is not None:
        raw = raw + (raw.to(low).to(raw.dtype) - raw).detach()
    clamped = raw + (torch.clamp(raw, max=ALPHA_MAX) - raw).detach()
    ok = raw >= ALPHA_MIN
    alpha = torch.where(ok, clamped, torch.zeros_like(clamped))
    # entries are grouped by tile: tile k of the block owns [start, end)
    start = (table.tile_start[t0:t1] - e0).long()
    end = start + table.tile_count[t0:t1].long()
    first = start[tl - t0]                      # each entry's tile start

    def running(x):
        """Inclusive float64 running sums along the entries, with a zero
        column in front: [P, E + 1]."""
        cum = torch.cumsum(x.double(), 1)
        return torch.cat([torch.zeros_like(cum[:, :1]), cum], 1)

    def excl(x):
        cum = running(x)
        return (cum[:, :-1] - cum[:, first]).to(x.dtype)

    def tile_sums(x):
        cum = running(x)
        return (cum[:, end] - cum[:, start]).to(x.dtype).T

    live = torch.exp(excl(torch.log1p(-alpha).detach())) > T_MIN
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))
    log_t = torch.log1p(-alpha)
    weight = alpha * torch.exp(excl(log_t))
    col = torch.stack([tile_sums(color[ch][sp][None] * weight)
                       for ch in range(color.shape[0])], 1)
    trans = torch.exp(tile_sums(log_t))
    if pairs:
        return col, trans, (sp, raw, weight)
    if not counts:
        return col, trans
    walked = live.any(0)
    return col, trans, (int((ok & live).sum()), int(walked.sum()),
                        sp[walked])


def render_view(vis: Visible, proj: Projected, table: Table, img_h: int,
                img_w: int, tile_h: int, tile_w: int, max_pairs: int,
                low=None, counts=False):
    """The blend of every tile, block by block, without autograd: (image
    [3, H, W] clamped to [0, 1], tile-layout colour [T, 3, P], and with
    ``counts`` the work counts: contributing pairs, entries up to their
    tile's last stop, and the points those entries name)."""
    tiles_x = math.ceil(img_w / tile_w)
    ntiles = table.tile_count.numel()
    npix = tile_h * tile_w
    dev = vis.color.device
    tiles = torch.zeros((ntiles, 3, npix), dtype=vis.color.dtype, device=dev)
    work = [0, 0]
    needed = torch.zeros(vis.color.shape[1], dtype=torch.bool, device=dev)
    with torch.no_grad():
        args = (proj.mean_pix.detach(), proj.inv_cov.detach(),
                vis.color.detach(), vis.opacity.detach())
        for t0, t1 in tile_blocks(table, max_pairs, npix):
            out = blend_block(table, t0, t1, *args, tile_w, tile_h, tiles_x,
                              low=low, counts=counts)
            tiles[t0:t1] = out[0]
            if counts:
                work = [work[0] + out[2][0], work[1] + out[2][1]]
                needed[out[2][2]] = True
    img = torch.clamp(tiles_to_img(tiles, img_h, img_w, tile_h, tile_w), 0, 1)
    if not counts:
        return img, tiles
    return img, tiles, (work[0], work[1], int(needed.sum()))


def tiles_to_img(tiles, img_h: int, img_w: int, tile_h: int, tile_w: int):
    """[T, C, tile_h * tile_w] -> [C, H, W] (padding cropped)."""
    ty, tx = math.ceil(img_h / tile_h), math.ceil(img_w / tile_w)
    c = tiles.shape[1]
    img = tiles.reshape(ty, tx, c, tile_h, tile_w).permute(2, 0, 3, 1, 4)
    return img.reshape(c, ty * tile_h, tx * tile_w)[:, :img_h, :img_w]


def render(raw, active: int, cam, sh_degree: int, img_h: int, img_w: int,
           tile_h: int, tile_w: int, chunk: int, max_pairs: int, low=None,
           counts=False):
    """One view's image from raw parameters, without autograd."""
    with torch.no_grad():
        vis = preprocess(raw, active, cam, sh_degree, chunk)
        proj = project(vis, cam, img_h, img_w)
        table = bin_tiles(proj, vis.opacity, img_h, img_w, tile_h, tile_w)
        return render_view(vis, proj, table, img_h, img_w, tile_h, tile_w,
                           max_pairs, low=low, counts=counts)
