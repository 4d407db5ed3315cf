"""Chunked (clustered) primitive organization.

Primitives are grouped into fixed-size chunks for coarse frustum culling,
as in ``litegs_tpu/scene/cluster.py``: flat [C, N] arrays with N a multiple
of the chunk size, chunking as indexing arithmetic.  Visible chunks are
compacted exactly (no fixed capacity).
"""
from __future__ import annotations

import math

import torch

from ..ops import projection
from ..utils import profiling

# sqrt(2 ln 255): ellipse radius (in stddevs) where alpha falls to 1/255 for
# a fully opaque gaussian (reference cluster.py:37).
_EXTEND_COEFF = math.sqrt(2.0 * math.log(255.0))


def chunk_aabb(xyz, scale_act, rot_unit, chunk_size: int = 128):
    """Per-chunk axis-aligned bounding boxes.

    Per-point extent = sqrt(2 ln 255) * row-abs-sum of M = R*S, then
    min/max over each chunk.

    Returns (origin [3, C], extend [3, C]) with C = N // chunk_size.
    """
    n = xyz.shape[-1]
    if n % chunk_size:
        raise ValueError(f"{n} points is not a multiple of {chunk_size}")
    m = projection.create_transform_matrix(scale_act, rot_unit)  # [3,3,N]
    point_ext = torch.sum(m.abs(), dim=0) * _EXTEND_COEFF        # [3,N]
    hi = (xyz + point_ext).reshape(3, -1, chunk_size).amax(dim=-1)
    lo = (xyz - point_ext).reshape(3, -1, chunk_size).amin(dim=-1)
    return (hi + lo) * 0.5, (hi - lo) * 0.5


def visible_chunk_ids(visibility):
    """Indices of the visible chunks, in ascending (stable) order.

    Returns (chunk_ids [V] int64, num_visible int).
    """
    profiling.host_wait("cull.nonzero")
    ids = torch.nonzero(visibility).flatten()
    return ids, ids.shape[0]


def gather_chunks(arr, chunk_ids, chunk_size: int = 128):
    """Gather chunks from a flat [.., N] array -> [.., V*chunk_size]."""
    lead = arr.shape[:-1]
    # explicit chunk count: a [0, N] array (sh_rest at degree 0) leaves -1
    # ambiguous
    chunked = arr.reshape(*lead, arr.shape[-1] // chunk_size, chunk_size)
    out = torch.index_select(chunked, len(lead), chunk_ids)
    return out.reshape(*lead, chunk_ids.shape[0] * chunk_size)


def scatter_chunk_mask(chunk_ids, num_visible: int, num_chunks: int):
    """Boolean [num_chunks] mask marking the first ``num_visible`` ids."""
    mask = torch.zeros(num_chunks, dtype=torch.bool, device=chunk_ids.device)
    # the True is copied from the host: a host wait on the card
    profiling.host_wait("adam.chunk_mask")
    mask[chunk_ids[:num_visible]] = True
    return mask
