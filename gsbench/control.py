"""The control and the planted faults, read at a cell's own size.

    python3 -m gsbench.control --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the cell's inputs as a run does, computes the
reference, then puts in the program's place the reference computed with
the rasterizer's inputs and each pair's alpha rounded to bfloat16 (the
control), and the reference with each fault of ``FAULTS`` planted; it
prints the cell's numbers for each, one JSON line per seed and variant,
against the cell's limits.  A loop module with a ``readings(run)`` of its
own (``loops/densify.py``) reads its variants, and the program's numbers
beside them, its own way.  The benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from . import check
from .loops import serve, train
from .reference.train import BETA1
from .run import new_run

TRAIN_VARIANTS = ("bfloat16", "half_batch", "colour_grad_doubled")
SERVE_VARIANTS = ("bfloat16", "stale_frame", "half_tiles", "pixel_altered")


def _as_program(ref: dict) -> dict:
    return {"losses": ref["losses"],
            "m1": {k: v * (1 - BETA1) for k, v in ref["grad"].items()},
            "delta": ref["delta"]}


def train_readings(run, variants=TRAIN_VARIANTS) -> dict:
    train.inputs(run)
    run.raw = run.gts = None
    truth = train.reference_steps(run)
    out = {}
    for v in variants:
        low = torch.bfloat16 if v == "bfloat16" else None
        fault = None if v == "bfloat16" else v
        out[v] = check.train_numbers(
            _as_program(train.reference_steps(run, low=low, fault=fault)),
            truth)
    return out


def serve_readings(run, variants=SERVE_VARIANTS) -> dict:
    serve.inputs(run)
    run.raw = None
    frames = run.check_frames
    truth = serve.reference_images(run, frames)
    out = {}
    for v in variants:
        if v == "bfloat16":
            imgs = serve.reference_images(run, frames, low=torch.bfloat16)
        elif v == "stale_frame":
            imgs = [truth[0]] + truth[:-1]
        elif v == "half_tiles":
            imgs = [torch.cat([t[:, :t.shape[1] // 2],
                               torch.zeros_like(t[:, t.shape[1] // 2:])], 1)
                    for t in truth]
        else:
            imgs = [t.clone() for t in truth]
            imgs[0][0, 0, 0] += 0.5
        out[v] = check.image_numbers(imgs, truth)
    return out


def readings_of(run):
    """The cell's readings: its loop module's ``readings`` where it has
    one, else those of its kind of loop."""
    loop = importlib.import_module(f"gsbench.loops.{run.traffic['loop']}")
    own = getattr(loop, "readings", None)
    if own is not None:
        return own
    kind = run.traffic.get("kind", run.traffic["loop"])
    return train_readings if kind == "train" else serve_readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gsbench.control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lim = check.limits(args.workload)
    for seed in args.seeds:
        run = new_run(args.workload, seed, "cuda")
        fn = readings_of(run)
        for variant, numbers in fn(run).items():
            print(json.dumps({"cell": args.workload, "seed": seed,
                              "variant": variant, "numbers": numbers,
                              "fails": sorted(k for k, v in numbers.items()
                                              if not v <= lim[k])}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
