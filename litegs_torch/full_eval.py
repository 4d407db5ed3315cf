"""Benchmark-suite runner (the port of the root ``full_eval.py``; reference
full_eval.py): train + evaluate every scene of MipNeRF-360 /
Tanks&Temples / Deep Blending on the card through the port's command line,
scrape wall-clock and metrics, aggregate into CSV.

    python -m litegs_torch.full_eval --mipnerf360 <dir> \
        --tanksandtemples <dir> --deepblending <dir> --output_path results

Each scene runs ``python -m litegs_torch.example_train`` and then
``python -m litegs_torch.example_metrics``, from a directory where
``litegs_torch`` imports (the repository root).  ``--dry_run`` prints the
commands.  The per-scene budgets, image folders, the 40k-iteration rule
for Tanks&Temples, the regexes and the CSV columns are the root script's.
"""
from __future__ import annotations

import argparse
import csv
import os
import re
import subprocess
import sys

# Per-scene primitive budgets (reference full_eval.py:19-33)
SCENE_BUDGETS = {
    "bicycle": 6_000_000, "flowers": 4_000_000, "garden": 6_000_000,
    "stump": 5_000_000, "treehill": 4_000_000, "room": 1_500_000,
    "counter": 1_200_000, "kitchen": 1_800_000, "bonsai": 1_300_000,
    "truck": 2_500_000, "train": 1_100_000,
    "drjohnson": 3_300_000, "playroom": 2_300_000,
}
# Image folders per dataset (reference full_eval.py:68-73)
OUTDOOR = ("bicycle", "flowers", "garden", "stump", "treehill")
MIPNERF360 = OUTDOOR + ("room", "counter", "kitchen", "bonsai")
TANKS = ("truck", "train")
DEEPBLEND = ("drjohnson", "playroom")

TIME_RE = re.compile(r"takes:\s*([0-9.]+)s")
METRIC_RE = re.compile(
    r"(train|test): SSIM ([0-9.]+)\s+PSNR ([0-9.]+)\s+LPIPS (\S+)")


def run_scene(scene_dir, model_dir, images, iterations, primitives,
              extra_args, dry_run=False):
    train_cmd = [sys.executable, "-m", "litegs_torch.example_train",
                 "-s", scene_dir,
                 "-m", model_dir, "-i", images, "--eval",
                 "--iterations", str(iterations),
                 "--target_primitives", str(primitives)] + extra_args
    eval_cmd = [sys.executable, "-m", "litegs_torch.example_metrics",
                "-s", scene_dir, "-m", model_dir, "-i", images,
                "--skip_train"]
    if dry_run:
        print(" ".join(train_cmd))
        print(" ".join(eval_cmd))
        return None
    out1 = subprocess.run(train_cmd, capture_output=True, text=True)
    print(out1.stdout[-2000:], file=sys.stderr)
    if out1.returncode != 0:
        print(out1.stderr[-2000:], file=sys.stderr)
        return {"error": "train failed"}
    out2 = subprocess.run(eval_cmd, capture_output=True, text=True)
    print(out2.stdout[-2000:], file=sys.stderr)
    row = {}
    m = TIME_RE.search(out1.stdout)
    if m:
        row["time_s"] = float(m.group(1))
    for split, ssim, psnr, lpips in METRIC_RE.findall(out2.stdout):
        row[f"{split}_ssim"] = float(ssim)
        row[f"{split}_psnr"] = float(psnr)
        row[f"{split}_lpips"] = None if lpips == "n/a" else float(lpips)
    return row


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mipnerf360", type=str, default=None)
    parser.add_argument("--tanksandtemples", type=str, default=None)
    parser.add_argument("--deepblending", type=str, default=None)
    parser.add_argument("--output_path", type=str, default="eval_results")
    parser.add_argument("--iterations", type=int, default=30000)
    parser.add_argument("--primitives", type=int, default=0,
                        help="override per-scene budgets (0 = use table)")
    parser.add_argument("--dry_run", action="store_true")
    parser.add_argument("extra", nargs="*", default=[],
                        help="extra args forwarded to example_train")
    args = parser.parse_args(argv)

    jobs = []
    if args.mipnerf360:
        for s in MIPNERF360:
            img = "images_4" if s in OUTDOOR else "images_2"
            jobs.append((s, os.path.join(args.mipnerf360, s), img,
                         args.iterations))
    if args.tanksandtemples:
        for s in TANKS:  # T&T runs 40k iterations (full_eval.py:75-80)
            it = args.iterations if args.iterations != 30000 else 40000
            jobs.append((s, os.path.join(args.tanksandtemples, s),
                         "images", it))
    if args.deepblending:
        for s in DEEPBLEND:
            jobs.append((s, os.path.join(args.deepblending, s), "images",
                         args.iterations))
    if not jobs:
        parser.error("no dataset roots given")

    os.makedirs(args.output_path, exist_ok=True)
    rows = []
    for scene, sdir, images, iters in jobs:
        budget = args.primitives or SCENE_BUDGETS.get(scene, 1_000_000)
        model_dir = os.path.join(args.output_path, scene)
        print(f"=== {scene} ({budget} primitives, {iters} iters) ===",
              flush=True)
        res = run_scene(sdir, model_dir, images, iters, budget, args.extra,
                        args.dry_run)
        if res is not None:
            res.update({"scene": scene, "primitives": budget})
            rows.append(res)
    if rows:
        csv_path = os.path.join(args.output_path, "results.csv")
        keys = sorted({k for r in rows for k in r})
        with open(csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {csv_path}")


if __name__ == "__main__":
    main()
