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
import os
import subprocess
import sys

from . import config as cfg
from .training.start import start
from .utils import resolve_device

# runs main on the CPU in a child process (the module's __main__ takes the
# card)
_CPU_CHILD = ("import sys; from litegs_torch import example_train; "
              "example_train.main(sys.argv[1:], device='cpu')")


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


def command(device="cuda") -> list:
    """The argv prefix that trains with this module's main on ``device``
    in a process of its own."""
    if resolve_device(device).type == "cuda":
        return [sys.executable, "-m", "litegs_torch.example_train"]
    return [sys.executable, "-c", _CPU_CHILD]


def train_variants(variants: dict, argv, model_path: str, device="cuda"):
    """The ablation scripts' loop: ``argv`` gives -s, -m (default
    ``model_path``), --iterations and extra flags for every run; each
    variant (name -> its flags) trains in a process of its own under
    ``<model_path>/<name>`` with --eval, and a failed variant does not stop
    the next.  Returns {name: exit code}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-s", "--source_path", required=True)
    parser.add_argument("-m", "--model_path", default=model_path)
    parser.add_argument("--iterations", type=int, default=10000)
    args, extra = parser.parse_known_args(argv)
    train = command(device)
    codes = {}
    for name, flags in variants.items():
        cmd = train + ["-s", args.source_path,
                       "-m", os.path.join(args.model_path, name), "--eval",
                       "--iterations", str(args.iterations)] + flags + extra
        print(f"=== {name} ===", flush=True)
        codes[name] = subprocess.run(cmd, check=False).returncode
    return codes


if __name__ == "__main__":
    main()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
