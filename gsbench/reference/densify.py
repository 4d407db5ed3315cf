"""Plain reference of LiteGS's density control at an epoch's end
(litegs/training/densify.py, DensityControllerTamingGS) and the Morton
resort that follows it (litegs/scene/point.py:86-154, called at
trainer.py:104-106).

On a statistics epoch ``e`` with densify_from <= e < densify_until:

* the budget (densify.py:304-305): the linear ramp from the initial
  points to ``target_primitives`` between densify_from and densify_until,
  ``min(max(int(target - N), 1) + pruned, N)``, trimmed to whole chunks;
* the selection (:286-292, :308): score = var(fragment error) x
  fragments x sigmoid(opacity)^2, var = E[x^2] - E[x]^2 over fragments
  + 1, and ``budget`` primitives drawn without replacement in proportion
  to it;
* split or clone (:309-325): a drawn primitive whose largest scale is
  above percent_dense x the scene extent is split, its copy offset by
  (scale x N(0, 1)) rotated and its scale divided by 1.6; else its copy
  is a clone;
* the 'weight' prune (:273-284): primitives whose blend weight summed to
  0 over the statistics epoch, among those the statistics saw;
* every ``opacity_reset_interval``-th epoch the 'decay' (:224-237):
  opacity halved, at least 1/128, every Adam moment cleared;
* then the Morton resort (point.py:27-154): Z-order codes of the live
  points over their own bounding box, a stable sort, the moments moved
  with their primitives.

Departures from LiteGS, each the port's documented design:

* the model is [C, capacity] arrays with the first ``active`` live:
  copies are written to the tail in index order with zero moments, and a
  prune moves the kept primitives to the front in order (LiteGS
  concatenates and masks tensors of the live points);
* appended and pruned counts are trimmed to whole chunks of ``chunk``
  (densify.py:148-154, 203-210), the selection is Gumbel top-k over one
  uniform draw per slot of the capacity, and the split offsets take one
  normal draw per axis and slot, both from the trainer's CPU generator
  (LiteGS: ``torch.multinomial`` and ``torch.normal`` on the card);
* a prune that would remove more than 80 % of the live points raises
  (LiteGS asserts, densify.py:146-147);
* Morton codes have 10 bits per axis (LiteGS: 21), which keeps every
  chunk's neighbourhood.
"""
from __future__ import annotations

import math

import torch

from . import render as R

FIELDS = ("xyz", "scale", "rot", "sh_0", "sh_rest", "opacity")
MOMENTS = ("exp_avg", "exp_avg_sq")
FAULTS = ("split_unshrunk", "draws_swapped", "prune_skipped")


def densify_until(dp: dict, total_epochs: int) -> int:
    """densify_until < 0 resolves to the last opacity reset before 80 % of
    the epochs, plus one (trainer.py:94-95)."""
    if dp["densify_until"] >= 0:
        return dp["densify_until"]
    every = dp["opacity_reset_interval"]
    return int(total_epochs * 0.8 / every) * every + 1


def ramp_target(dp: dict, until: int, init: int, epoch: int) -> float:
    """The budget's ramp after ``epoch``'s event."""
    span = max(until - dp["densify_from"], 1)
    return ((dp["target_primitives"] - init) / span
            * (epoch - dp["densify_from"]) + init)


def budget(dp: dict, until: int, init: int, epoch: int, active: int,
           pruned: int, chunk: int, capacity: int) -> int:
    grow = max(int(ramp_target(dp, until, init, epoch) - active), 1)
    b = min(grow + pruned, active, capacity - active)
    return b // chunk * chunk


def score(leaves: dict, stats: dict, active: int):
    """var(fragment error) x fragments x opacity^2 over the live points."""
    denom = stats["frag_count"] + 1.0
    mean = stats["err_sum"] / denom
    mean_sq = stats["err_sq_sum"] / denom
    var = torch.clamp(torch.nan_to_num(mean_sq - mean * mean), min=0.0)
    op = torch.sigmoid(leaves["opacity"][0])
    s = torch.clamp(torch.nan_to_num(var * stats["frag_count"] * op * op),
                    min=0.0)
    s[active:] = 0.0
    return s


def draws(generator_state, n: int, device, fault=None):
    """(uniform [n] in [1e-10, 1), normal [3, n]) from the trainer's
    generator, in the order the event draws them."""
    g = torch.Generator()
    g.set_state(generator_state)
    if fault == "draws_swapped":
        normal = torch.randn((3, n), generator=g)
        uniform = torch.rand(n, generator=g).clamp_(min=1e-10)
    else:
        uniform = torch.rand(n, generator=g).clamp_(min=1e-10)
        normal = torch.randn((3, n), generator=g)
    return uniform.to(device), normal.to(device)


def _permute(leaves: dict, perm) -> dict:
    return {k: v[..., perm] for k, v in leaves.items()}


def split_clone(leaves, stats, active, epoch, dp, until, init, extent,
                chunk, uniform, normal, fault=None):
    """Append the drawn primitives' copies; returns (leaves, active,
    appended)."""
    n = leaves["xyz"].shape[-1]
    live = torch.arange(n, device=leaves["xyz"].device) < active
    pruned = int(((stats["weight_sum"] == 0) & live).sum())
    b = budget(dp, until, init, epoch, active, pruned, chunk, n)
    s = score(leaves, stats, active)
    keys = torch.where(s > 0, torch.log(s) - torch.log(-torch.log(uniform)),
                       torch.full_like(s, -math.inf))
    drawn = torch.sort(keys, descending=True, stable=True).indices[:b]
    idx = torch.sort(drawn[s[drawn] > 0]).values
    scale = torch.exp(leaves["scale"][:, idx])
    split = scale.amax(0) > dp["percent_dense"] * extent
    rows = R.rotation_rows(R.unit_quat(leaves["rot"][:, idx]))
    shift = ((normal[:, idx] * scale)[:, None] * rows).sum(0)
    copy = {k: leaves[k][..., idx] for k in FIELDS}
    copy["xyz"] = torch.where(split, copy["xyz"] + shift, copy["xyz"])
    if fault != "split_unshrunk":
        copy["scale"] = torch.where(split, torch.log(scale / 1.6),
                                    copy["scale"])
    out = {k: v.clone() for k, v in leaves.items()}
    dest = slice(active, active + idx.numel())
    for k in FIELDS:
        out[k][..., dest] = copy[k]
        for m in MOMENTS:
            out[f"{m}.{k}"][..., dest] = 0.0
    # copies past the last whole chunk stay in the tail, not live
    kept = idx.numel() // chunk * chunk
    return out, active + kept, kept


def weight_prune(leaves, stats, active, seen, chunk, fault=None):
    """Remove the first whole chunks' worth of primitives (among the
    ``seen`` the statistics cover) whose blend weight summed to 0;
    returns (leaves, active, pruned)."""
    n = leaves["xyz"].shape[-1]
    idx = torch.arange(n, device=leaves["xyz"].device)
    gone = (stats["weight_sum"] == 0) & (idx < seen) & (idx < active)
    count = int(gone.sum())
    if count > 0.8 * max(active, 1):
        raise RuntimeError(f"prune of {count} of {active} primitives")
    cut = 0 if fault == "prune_skipped" else count // chunk * chunk
    gone &= torch.cumsum(gone.int(), 0) <= cut
    live = idx < active
    order = torch.cat([idx[live & ~gone], idx[gone], idx[~live]])
    return _permute(leaves, order), active - cut, cut


def decay(leaves):
    """Opacity halved (at least 1/128), every moment cleared."""
    out = dict(leaves)
    op = torch.clamp(torch.sigmoid(leaves["opacity"]) * 0.5, min=1.0 / 128)
    out["opacity"] = torch.log(op / (1.0 - op))
    for m in MOMENTS:
        for k in FIELDS:
            out[f"{m}.{k}"] = torch.zeros_like(leaves[f"{m}.{k}"])
    return out


def _spread10(v):
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    return (v | (v << 2)) & 0x9249249


def resort(leaves, active, box="live"):
    """Stable Z-order of the live points, 10 bits per axis over the live
    points' box; the rest keep their order behind them.  ``box=
    'capacity'`` takes the box of every slot, parked ones included
    (never LiteGS: it shows what such a box does)."""
    xyz = leaves["xyz"]
    n = xyz.shape[-1]
    ref = xyz[:, :active] if box == "live" else xyz
    lo = ref.amin(1, keepdim=True)
    span = torch.clamp(ref.amax(1, keepdim=True) - lo, min=1e-12)
    q = torch.clamp((xyz[:, :active] - lo) / span * 1023, 0, 1023)
    q = q.to(torch.int32)
    code = _spread10(q[0]) | (_spread10(q[1]) << 1) | (_spread10(q[2]) << 2)
    order = torch.sort(code, stable=True).indices
    rest = torch.arange(active, n, device=xyz.device)
    return _permute(leaves, torch.cat([order, rest]))


@torch.no_grad()
def event(leaves, stats, active, epoch, dp, until, init, extent, chunk,
          generator_state, fault=None, box="live"):
    """One epoch end: densify on a statistics epoch, the decay on a reset
    epoch, the resort every interval.  ``leaves``: the parameters and
    moments (``FIELDS`` and ``"<moment>.<field>"`` for each of
    ``MOMENTS``) [..., capacity]; ``stats`` as
    ``statistics.zeros``.  Returns {"leaves", "active", "appended",
    "pruned"}."""
    appended = pruned = 0
    every = dp["densification_interval"]
    if dp["densify_from"] <= epoch < until:
        if epoch % every == 0:
            n = leaves["xyz"].shape[-1]
            uniform, normal = draws(generator_state, n,
                                    leaves["xyz"].device, fault)
            seen = active
            leaves, active, appended = split_clone(
                leaves, stats, active, epoch, dp, until, init, extent, chunk,
                uniform, normal, fault)
            leaves, active, pruned = weight_prune(leaves, stats, active,
                                                  seen, chunk, fault)
        if epoch % dp["opacity_reset_interval"] == 0:
            leaves = decay(leaves)
    if epoch % every == 0:
        leaves = resort(leaves, active, box)
    return {"leaves": leaves, "active": active, "appended": appended,
            "pruned": pruned}
