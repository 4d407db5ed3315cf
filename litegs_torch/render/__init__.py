"""Render pipeline: cull -> compact -> activate -> project -> bin -> raster.

The pipeline of ``litegs_tpu/render/__init__.py`` (render_preprocess,
render and render_batch), sized exactly from the data: culling keeps
exactly the visible chunks and the binning table holds exactly the view's
entries, so nothing can overflow (``overflow`` stays False).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import PipelineParams
from ..ops import binning as binning_ops
from ..ops import projection
from ..ops import raster as raster_ops
from ..scene import cluster
from ..scene.gaussians import GaussianModel
from ..utils import math as um
from ..utils import profiling
from ..utils import sh as sh_utils


class CulledGaussians(NamedTuple):
    """Visible-compacted, activated gaussians."""

    xyz: torch.Tensor        # [3, Mv]
    scale: torch.Tensor      # [3, Mv] activated
    rot: torch.Tensor        # [4, Mv] unit quaternions
    color: torch.Tensor      # [3, Mv] view-dependent RGB
    opacity: torch.Tensor    # [Mv] activated
    valid: torch.Tensor      # [Mv] bool (all True)
    chunk_ids: torch.Tensor  # [Mv/chunk] gathered chunk ids
    num_visible_chunks: int
    overflow: bool           # always False


class RenderAux(NamedTuple):
    """Per-view intermediates of :func:`render`."""

    table: binning_ops.BinningResult
    mean_pix: torch.Tensor
    inv_cov: torch.Tensor
    color_chan: torch.Tensor
    opacity: torch.Tensor
    tiles_color: torch.Tensor   # unclamped accumulation [T, C, P]
    tiles_trans: torch.Tensor   # [T, P]


class RenderedView(NamedTuple):
    img: torch.Tensor                     # [3, H, W] in [0, 1]
    transmitance: Optional[torch.Tensor]  # [1, H, W] or None
    depth: Optional[torch.Tensor]         # [1, H, W] or None
    primitive_visible: torch.Tensor       # [Mv] bool
    overflow: bool                        # always False
    sizes: torch.Tensor                   # [3]: visible prims, rows, entries
    aux: RenderAux


@profiling.spanned("preprocess")
def render_preprocess(params: GaussianModel, chunk_origin, chunk_extend,
                      frustumplane, cam_center, actived_sh_degree: int,
                      pp: PipelineParams) -> CulledGaussians:
    """Frustum-cull chunks, gather visible ones, activate, evaluate SH
    (reference render/__init__.py:11-48, compact.cu:825-893)."""
    chunk_size = pp.cluster_size
    visibility = um.frustum_culling_aabb(frustumplane, chunk_origin,
                                         chunk_extend)
    if pp.disable_culling:
        # keep every chunk except the pushed-out inactive ones
        visibility = torch.any(chunk_extend > 0.0, dim=0)
    chunk_ids, num_vis = cluster.visible_chunk_ids(visibility)

    def gather(arr):
        return cluster.gather_chunks(arr, chunk_ids, chunk_size)

    xyz = gather(params.xyz)
    scale = torch.exp(gather(params.scale))
    rot_raw = gather(params.rot)
    norm = torch.sqrt(torch.sum(rot_raw ** 2, dim=0, keepdim=True))
    rot = rot_raw / torch.clamp(norm, min=1e-12)
    opacity = torch.sigmoid(gather(params.opacity)[0])

    # view-dependent color; directions carry no gradient, as in the
    # reference (render/__init__.py:40-43)
    dirs = xyz.detach() - cam_center[:, None]
    dirs = dirs / torch.clamp(
        torch.sqrt(torch.sum(dirs ** 2, dim=0, keepdim=True)), min=1e-12)
    color = torch.clamp(
        sh_utils.sh_to_rgb_split(actived_sh_degree, gather(params.sh_0),
                                 gather(params.sh_rest), dirs), min=0.0)
    valid = torch.ones(xyz.shape[-1], dtype=torch.bool, device=xyz.device)
    return CulledGaussians(xyz=xyz, scale=scale, rot=rot, color=color,
                           opacity=opacity, valid=valid, chunk_ids=chunk_ids,
                           num_visible_chunks=num_vis, overflow=False)


@profiling.spanned("project")
def _project(culled: CulledGaussians, view_matrix, proj_matrix,
             img_h: int, img_w: int):
    xyz_h = projection.homogeneous(culled.xyz)
    view_pos, ndc = projection.mvp_transform(xyz_h, view_matrix, proj_matrix)
    jac = projection.rayspace_jacobian(view_pos, proj_matrix, img_h, img_w)
    cov2d = projection.cov2d_fused(culled.scale, culled.rot, jac,
                                   view_matrix)
    return view_pos, ndc, projection.inverse_2x2_sym(cov2d)


def estimate_view_sizes(culled: CulledGaussians, view_matrix, proj_matrix,
                        img_h: int, img_w: int, pp: PipelineParams):
    """Upper-bound (visible, rows, entries) for one view: projection and
    reductions only, no expansions."""
    tile_h, tile_w = pp.tile_size
    view_pos, ndc, inv_cov = _project(culled, view_matrix, proj_matrix,
                                      img_h, img_w)
    return binning_ops.estimate_table_sizes(
        ndc, view_pos[2], inv_cov, culled.opacity, culled.valid,
        img_h, img_w, tile_h, tile_w)


def _view_inputs(culled: CulledGaussians, view_matrix, proj_matrix,
                 img_h: int, img_w: int, pp: PipelineParams):
    """One view's raster inputs: (table, mean_pix, inv_cov, color_chan,
    sizes), projection and binning as :func:`render` runs them."""
    tile_h, tile_w = pp.tile_size
    view_pos, ndc, inv_cov = _project(culled, view_matrix, proj_matrix,
                                      img_h, img_w)
    view_z = view_pos[2]
    table = binning_ops.build_tile_table(
        ndc.detach(), view_z.detach(), inv_cov.detach(),
        culled.opacity.detach(), culled.valid, img_h, img_w, tile_h, tile_w)
    mean_pix = projection.ndc_to_pixel(ndc, img_h, img_w)
    channels = [culled.color]
    if pp.enable_depth:
        channels.append(view_z[None])
    sizes = torch.tensor([culled.num_visible_chunks * pp.cluster_size,
                          table.num_rows, table.num_entries])
    return table, mean_pix, inv_cov, torch.cat(channels, dim=0), sizes


def _tile_grid(img_h: int, img_w: int, pp: PipelineParams):
    tile_h, tile_w = pp.tile_size
    return math.ceil(img_w / tile_w), math.ceil(img_h / tile_h)


def _images(tiles_color, tiles_trans, img_h: int, img_w: int,
            pp: PipelineParams):
    """(img, transmitance, depth) of one view's tile-layout outputs."""
    tile_h, tile_w = pp.tile_size
    img_all = um.tiles_to_img(tiles_color, img_h, img_w, tile_h, tile_w)
    img = torch.clamp(img_all[:3], 0.0, 1.0)
    depth = img_all[3:4] if pp.enable_depth else None
    trans = None
    if pp.enable_transmitance:
        trans = um.tiles_to_img(tiles_trans[:, None], img_h, img_w,
                                tile_h, tile_w)
    return img, trans, depth


def render(culled: CulledGaussians, view_matrix, proj_matrix,
           img_h: int, img_w: int, pp: PipelineParams,
           stats_sink=None) -> RenderedView:
    """Project visible gaussians and rasterize one view (reference
    render/__init__.py:50-94): MVP -> transform matrix -> ray-space
    Jacobian -> cov2d -> inverse -> binning -> raster.  Differentiable
    end to end.

    ``stats_sink``: optional ``ops.raster.zero_stats_sink(Mv)``; the loss's
    gradient with respect to it is the view's RasterStats (see
    ``ops.raster.rasterize``).
    """
    tile_h, tile_w = pp.tile_size
    tiles_x, tiles_y = _tile_grid(img_h, img_w, pp)
    table, mean_pix, inv_cov, color_chan, sizes = _view_inputs(
        culled, view_matrix, proj_matrix, img_h, img_w, pp)
    tiles_color, tiles_trans, _ = raster_ops.rasterize(
        mean_pix, inv_cov, color_chan, culled.opacity, table,
        tiles_x * tiles_y, tiles_x, tile_h, tile_w,
        backend=pp.raster_backend, stats_sink=stats_sink, img_h=img_h,
        img_w=img_w)
    img, trans, depth = _images(tiles_color, tiles_trans, img_h, img_w, pp)
    aux = RenderAux(table=table, mean_pix=mean_pix, inv_cov=inv_cov,
                    color_chan=color_chan, opacity=culled.opacity,
                    tiles_color=tiles_color, tiles_trans=tiles_trans)
    return RenderedView(img=img, transmitance=trans, depth=depth,
                        primitive_visible=table.primitive_visible,
                        overflow=False, sizes=sizes, aux=aux)


class RenderedBatch(NamedTuple):
    """B views rendered by ONE raster launch (see :func:`render_batch`)."""

    imgs: torch.Tensor                    # [B, 3, H, W] in [0, 1]
    transmitance: Optional[torch.Tensor]  # [B, 1, H, W] or None
    depth: Optional[torch.Tensor]         # [B, 1, H, W] or None
    primitive_visible: tuple              # B tensors [M_v] bool
    overflow: bool                        # always False
    sizes: torch.Tensor                   # [B, 3] per view
    # B + 1 ints: view v's points are [off[v], off[v + 1]) of the merged
    # [sum M_v] point axis
    point_offsets: tuple
    aux: RenderAux                        # the merged table and inputs


def render_batch(culled_list, view_mats, proj_mats, img_h: int, img_w: int,
                 pp: PipelineParams, stats_sink=None) -> RenderedBatch:
    """Render B views through ONE rasterize() call
    (``litegs_tpu/render/__init__.py::render_batch``).

    Projection and binning stay per view, exactly as in :func:`render`;
    the per-view tables merge into one table over B * T tiles
    (``binning.concat_tables``) and the per-view attributes concatenate
    along the point axis, so one forward and one backward kernel launch
    serve all B views.  Autograd splits the merged per-point gradients
    back through each view's projection chain.  All views share one
    (img_h, img_w).

    ``stats_sink``: optional ``ops.raster.zero_stats_sink(sum M_v)``; view
    v's RasterStats are its gradients' slice
    ``[point_offsets[v], point_offsets[v + 1])``.
    """
    tile_h, tile_w = pp.tile_size
    tiles_x, tiles_y = _tile_grid(img_h, img_w, pp)
    tiles_total = tiles_x * tiles_y
    b = len(culled_list)
    per_view = [_view_inputs(c, view_mats[v], proj_mats[v], img_h, img_w,
                             pp) for v, c in enumerate(culled_list)]
    tables, mean_pixs, inv_covs, colors, sizes = zip(*per_view)
    merged = binning_ops.concat_tables(tables, tiles_total)
    opacity = torch.cat([c.opacity for c in culled_list])
    mean_pix, inv_cov, color_chan = (torch.cat(x, dim=1) for x in
                                     (mean_pixs, inv_covs, colors))
    tiles_color, tiles_trans, _ = raster_ops.rasterize(
        mean_pix, inv_cov, color_chan, opacity, merged, b * tiles_total,
        tiles_x, tile_h, tile_w, backend=pp.raster_backend,
        stats_sink=stats_sink, img_h=img_h, img_w=img_w, tiles_y=tiles_y)

    views = [_images(tiles_color[v * tiles_total:(v + 1) * tiles_total],
                     tiles_trans[v * tiles_total:(v + 1) * tiles_total],
                     img_h, img_w, pp) for v in range(b)]

    def stack(k):
        return None if views[0][k] is None else torch.stack(
            [x[k] for x in views])

    offsets = [0]
    for t in tables:
        offsets.append(offsets[-1] + t.primitive_visible.shape[0])
    aux = RenderAux(table=merged, mean_pix=mean_pix, inv_cov=inv_cov,
                    color_chan=color_chan, opacity=opacity,
                    tiles_color=tiles_color, tiles_trans=tiles_trans)
    return RenderedBatch(
        imgs=stack(0), transmitance=stack(1), depth=stack(2),
        primitive_visible=tuple(t.primitive_visible for t in tables),
        overflow=False, sizes=torch.stack(sizes), point_offsets=tuple(offsets),
        aux=aux)
