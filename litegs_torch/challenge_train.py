"""Speed-challenge training run on the card (the port of the root
``3dgs_challenge_train.py``; reference 3dgs_challenge_train.py): 5,000
iterations, the wall-clock seconds written to JSON for the leaderboard
harness.

    python -m litegs_torch.challenge_train -s <colmap_scene_dir> \
        -m <output_dir> --timing_json <output_dir>/train_time.json

Takes the root script's flags.  (A module name cannot start with a digit
in an ``import`` statement, hence this file's name.)
"""
import argparse
import dataclasses
import json
import os
import time

from . import config as cfg
from . import training


def main(argv=None, device="cuda"):
    """Parse ``argv`` and train on ``device`` for 5,000 iterations; returns
    the timing record written to ``--timing_json``."""
    parser = argparse.ArgumentParser()
    cfg.add_cmdline_args(parser)
    parser.add_argument("--timing_json", type=str, default="train_time.json")
    args = parser.parse_args(argv)
    lp, op, pp, dp = cfg.extract_groups(args)
    op = dataclasses.replace(op, iterations=5000,
                             position_lr_max_steps=5000)
    t0 = time.time()
    training.start(lp, op, pp, dp, device=device)
    elapsed = time.time() - t0
    os.makedirs(os.path.dirname(args.timing_json) or ".", exist_ok=True)
    result = {"train_time_s": elapsed, "scene": lp.source_path}
    with open(args.timing_json, "w") as f:
        json.dump(result, f)
    print(f"challenge train: {elapsed:.1f}s")
    return result


if __name__ == "__main__":
    main()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
