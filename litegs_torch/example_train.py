"""Command-line training of a COLMAP scene on the card (the port's
``example_train.py``; reference example_train.py:7-27).

    python -m litegs_torch.example_train -s <colmap_scene_dir> \
        -m <output_dir> --target_primitives 1000000 --iterations 10000

Takes the root script's flags.  Resume with ``--start_checkpoint
<output_dir>/checkpoints/chkpnt<E>.npz``.  On N cards, data-parallel:

    torchrun --nproc_per_node N -m litegs_torch.example_train \
        -s <colmap_scene_dir> -m <output_dir> --parallel on
"""
import argparse

from . import config as cfg
from .training.start import start


def parse_epoch_list(s):
    return [int(x) for x in s.split(",") if x] if s else []


def main(argv=None, device="cuda"):
    """Parse ``argv`` and train on ``device``; returns start's (trainer,
    state, history)."""
    parser = argparse.ArgumentParser(description="Train a 3DGS scene")
    cfg.add_cmdline_args(parser)
    parser.add_argument("--test_epochs", type=str, default="",
                        help="comma-separated epoch list for test PSNR")
    parser.add_argument("--save_epochs", type=str, default="",
                        help="comma-separated epoch list for ply export")
    parser.add_argument("--checkpoint_epochs", type=str, default="",
                        help="comma-separated epoch list for checkpoints")
    parser.add_argument("--start_checkpoint", type=str, default=None)
    args = parser.parse_args(argv)
    lp, op, pp, dp = cfg.extract_groups(args)
    if not lp.source_path:
        parser.error("--source_path/-s is required")
    return start(lp, op, pp, dp,
                 test_epochs=parse_epoch_list(args.test_epochs),
                 save_epochs=parse_epoch_list(args.save_epochs),
                 checkpoint_epochs=parse_epoch_list(args.checkpoint_epochs),
                 start_checkpoint=args.start_checkpoint, device=device)


if __name__ == "__main__":
    main()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
