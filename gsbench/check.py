"""The numbers that decide ``correct``: what the timed path produced held
to the reference, each against the limit set for the cell
(``limits/<cell>.json``)."""
from __future__ import annotations

import json
from pathlib import Path

import torch

from .reference.train import BETA1

LIMITS = Path(__file__).resolve().parent / "limits"
# a leaf whose reference gradient is under this share of the median
# leaf's is nought to rounding: Adam moves it by round-off alone
NOUGHT_SHARE = 1e-3


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Per leaf | |prog| - |ref| | / max(|ref leaf|, |median leaf|)."""
    pn, rn = _norms(prog), _norms(ref)
    med = float(torch.tensor(sorted(rn.values())).median())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in rn}


def loss_gaps(prog: dict, ref: dict) -> list:
    return [abs(a - b) / abs(b) for a, b in
            zip(prog["losses"], ref["losses"])]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: ``losses`` (each step), ``grad`` (the first
    step's gradients; the program's worked out from Adam's first moment,
    m = (1 - beta1) g), ``delta`` (the parameters' change over the steps).

    loss_gap: the first step's |loss - reference| / reference (the later
    steps' losses carry Adam's first update, whose sign on gradients at
    rounding level is rounding's: ``loss_gaps`` has every step's);
    grad_gap, step_gap: the worst leaf's gap of norms (``leaf_gaps``),
    over the leaves whose reference gradient is not nought."""
    rn = _norms(ref["grad"])
    med = float(torch.tensor(sorted(rn.values())).median())
    keep = [k for k, v in rn.items() if v >= NOUGHT_SHARE * med]
    loss_gap = loss_gaps(prog, ref)[0]
    grad = {k: v / (1 - BETA1) for k, v in prog["m1"].items()}
    grad_gaps = leaf_gaps(grad, ref["grad"])
    step_gaps = leaf_gaps(prog["delta"], ref["delta"])
    return {"loss_gap": loss_gap,
            "grad_gap": max(grad_gaps[k] for k in keep),
            "step_gap": max(step_gaps[k] for k in keep)}


def stats_numbers(prog: dict, ref: dict) -> dict:
    """stats_gap: the worst statistics field's ||prog - ref|| / ||ref||
    (a gap of norms would not see rounding, which averages out in a
    norm)."""
    return {"stats_gap": max(field_gaps(prog, ref).values())}


def field_gaps(prog: dict, ref: dict) -> dict:
    out = {}
    for k, r in ref.items():
        r = r.double()
        d = prog[k].double().to(r.device) - r
        out[k] = float(torch.linalg.vector_norm(d)
                       / max(float(torch.linalg.vector_norm(r)), 1e-30))
    return out


# a value of a primitive disagrees beyond rounding where
# |prog - ref| > EVENT_REL |ref| + EVENT_ABS max |ref of its leaf|
EVENT_REL, EVENT_ABS = 1e-5, 1e-6


def disagreeing(prog: dict, ref: dict, n: int):
    """[n] bool: the primitive has a parameter or moment that disagrees
    (NaN disagrees)."""
    bad = None
    for k, r in ref.items():
        r = r[..., :n].reshape(-1, n)
        p = prog[k][..., :n].reshape(-1, n).to(r.device)
        tol = EVENT_REL * r.abs() + EVENT_ABS * r.abs().max()
        off = ~((p - r).abs() <= tol)
        bad = off.any(0) if bad is None else bad | off.any(0)
    return bad


def event_numbers(prog: dict, prog_active: int, ref: dict,
                  ref_active: int) -> dict:
    """An epoch boundary's output (parameters and moments [..., capacity])
    against the reference's replay of it.  event_count_gap: |live
    primitives - reference's|; event_mismatch_share: the share of the
    reference's live primitives whose values disagree (those one side
    lacks count as disagreeing); event_gap: the worst leaf's gap of norms
    over the live primitives both sides hold (``leaf_gaps``)."""
    n = min(prog_active, ref_active)
    bad = int(disagreeing(prog, ref, n).sum())
    gaps = leaf_gaps({k: v[..., :n] for k, v in prog.items()},
                     {k: v[..., :n].to(prog[k].device)
                      for k, v in ref.items()})
    return {"event_count_gap": abs(prog_active - ref_active),
            "event_mismatch_share": (bad + abs(prog_active - ref_active))
            / max(ref_active, 1),
            "event_gap": max(gaps.values())}


def image_numbers(prog_imgs, ref_imgs) -> dict:
    """img_rms_gap: the worst frame's root-mean-square pixel gap;
    img_max_gap: the largest pixel gap of any frame."""
    rms, mx = 0.0, 0.0
    for p, r in zip(prog_imgs, ref_imgs):
        d = (p.double() - r.double())
        rms = max(rms, float(torch.sqrt(torch.mean(d * d))))
        mx = max(mx, float(d.abs().max()))
    return {"img_rms_gap": rms, "img_max_gap": mx}


def limits(cell: str) -> dict:
    return json.loads((LIMITS / f"{cell}.json").read_text())["limits"]


def judge(numbers: dict, lim: dict):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit."""
    shown = {k: {"value": v, "limit": lim[k]} for k, v in numbers.items()}
    ok = all(v <= lim[k] for k, v in numbers.items())
    return ok, shown
