"""Aggregate full_eval CSVs into markdown/latex tables with
repeat-averaging (the port of ``scripts/print_results.py``; reference
scripts/print_results.py), optionally with 95% confidence intervals over
repeats (Student t; an addition over the reference, whose
print_conf_results aggregates fixed configurations).

    python -m litegs_torch.print_results results/results.csv [--latex]
"""
import argparse
import csv
import math
import sys
from collections import defaultdict


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("csvs", nargs="+")
    parser.add_argument("--latex", action="store_true")
    parser.add_argument("--conf", action="store_true",
                        help="append 95%% confidence intervals over repeats")
    args = parser.parse_args(argv)
    rows = defaultdict(list)
    for path in args.csvs:
        with open(path) as f:
            for row in csv.DictReader(f):
                rows[row["scene"]].append(row)
    cols = ["time_s", "test_ssim", "test_psnr", "test_lpips"]
    if args.latex:
        print("scene & " + " & ".join(cols) + r" \\")
    else:
        print("| scene | " + " | ".join(cols) + " |")
        print("|---" * (len(cols) + 1) + "|")
    for scene in sorted(rows):
        vals = []
        for c in cols:
            xs = [float(r[c]) for r in rows[scene]
                  if r.get(c) not in (None, "", "None")]
            if not xs:
                vals.append("n/a")
                continue
            mean = sum(xs) / len(xs)
            cell = f"{mean:.4g}"
            if args.conf and len(xs) > 1:
                var = sum((x - mean) ** 2 for x in xs) / (len(xs) - 1)
                # two-sided 95% Student-t quantiles (df 1..30, then ~z)
                t95 = [12.71, 4.30, 3.18, 2.78, 2.57, 2.45, 2.36, 2.31,
                       2.26, 2.23, 2.20, 2.18, 2.16, 2.14, 2.13, 2.12,
                       2.11, 2.10, 2.09, 2.09, 2.08, 2.07, 2.07, 2.06,
                       2.06, 2.06, 2.05, 2.05, 2.05, 2.04]
                df = len(xs) - 1
                t = t95[df - 1] if df <= 30 else 1.96
                ci = t * math.sqrt(var / len(xs))
                cell += f" ±{ci:.2g}"
            vals.append(cell)
        if args.latex:
            print(f"{scene} & " + " & ".join(vals) + r" \\")
        else:
            print(f"| {scene} | " + " | ".join(vals) + " |")


if __name__ == "__main__":
    main()
