"""PSNR-vs-primitive-count scaling curve (the port of
``scripts/scale_curve.py``; reference scripts/scale_curve.py): sweep
target_primitives for one scene on the card and tabulate the curve used
to reproduce the reference's LiteGS_ParamScale comparison.

    python -m litegs_torch.scale_curve -s <scene_dir> -m <out_dir>
"""
import argparse
import csv
import os
import re
import subprocess
import sys

BUDGETS = [300_000, 500_000, 1_000_000, 2_000_000, 4_000_000, 6_000_000]
ROW_RE = re.compile(r"test: SSIM ([0-9.]+)\s+PSNR ([0-9.]+)")


def parse_row(budget: int, metrics_stdout: str):
    """The curve's row from example_metrics' output, or None."""
    m = ROW_RE.search(metrics_stdout)
    if m is None:
        return None
    return {"primitives": budget, "ssim": float(m.group(1)),
            "psnr": float(m.group(2))}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-s", "--source_path", required=True)
    parser.add_argument("-m", "--model_path", default="scale_curve")
    parser.add_argument("--iterations", type=int, default=10000)
    parser.add_argument("--budgets", type=int, nargs="*", default=BUDGETS)
    args, extra = parser.parse_known_args(argv)
    rows = []
    for budget in args.budgets:
        mdir = os.path.join(args.model_path, f"p{budget}")
        print(f"=== {budget} primitives ===", flush=True)
        subprocess.run(
            [sys.executable, "-m", "litegs_torch.example_train", "-s",
             args.source_path, "-m", mdir, "--eval", "--iterations",
             str(args.iterations), "--target_primitives", str(budget)]
            + extra, check=False)
        out = subprocess.run(
            [sys.executable, "-m", "litegs_torch.example_metrics", "-s",
             args.source_path, "-m", mdir, "--skip_train"],
            capture_output=True, text=True)
        row = parse_row(budget, out.stdout)
        if row:
            rows.append(row)
            print(rows[-1], flush=True)
    os.makedirs(args.model_path, exist_ok=True)
    path = os.path.join(args.model_path, "scale_curve.csv")
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["primitives", "ssim", "psnr"])
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
