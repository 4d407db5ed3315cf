"""Morton (Z-order) spatial sorting of primitives.

10 bits per axis packed into an int32 key, normalized to a bounding box,
and a stable sort: the codes and order of ``litegs_tpu/scene/morton.py``
where every point is live.

One departure from the JAX package: given an active mask,
:func:`spatial_sort_indices` boxes the live points only, as LiteGS does
(litegs/scene/point.py:49-57, over the points it holds).  The JAX package
boxes every slot of the capacity, parked ones (xyz 1e8) included, which
quantizes every live point to code 0 and leaves the order as it was.
"""
from __future__ import annotations

import torch


def _part_bits_10(v):
    """Spread the low 10 bits of v so they occupy every 3rd bit."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def morton_codes(xyz, box_mask=None):
    """3D Morton codes from positions.

    Args:
      xyz: [3, N] positions.
      box_mask: optional [N] bool; the box is taken over the points it
        marks (default: every point).  Points outside the box clamp to
        its faces.
    Returns:
      [N] int32 codes.
    """
    if box_mask is None:
        mins = xyz.amin(dim=1, keepdim=True)
        maxs = xyz.amax(dim=1, keepdim=True)
    else:
        out = ~box_mask
        mins = xyz.masked_fill(out, float("inf")).amin(dim=1, keepdim=True)
        maxs = xyz.masked_fill(out, -float("inf")).amax(dim=1, keepdim=True)
    scale = (1 << 10) - 1
    denom = torch.clamp(maxs - mins, min=1e-12)
    q = torch.clamp((xyz - mins) / denom * scale, 0, scale).to(torch.int32)
    return (_part_bits_10(q[0]) | (_part_bits_10(q[1]) << 1)
            | (_part_bits_10(q[2]) << 2))


def spatial_sort_indices(xyz, active_mask=None):
    """Stable Morton-order permutation over the live points' box; inactive
    points sort to the end in their order."""
    codes = morton_codes(xyz, active_mask)
    if active_mask is not None:
        codes = torch.where(active_mask, codes,
                            torch.full_like(codes, 0x7FFFFFFF))
    return torch.sort(codes, stable=True).indices
