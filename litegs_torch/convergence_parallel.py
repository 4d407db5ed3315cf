"""Data-parallel convergence parity: sequential against data-parallel
training (the port of ``scripts/convergence_parallel.py``).

One data-parallel step applies ONE optimizer update from the mean gradient
of D views where the sequential trainer applies D updates.  This trains
the synthetic closed-loop task (``data.synthetic_train``: 500 points, 8
frames, 48x64, SH 1, seed 3) four ways:

  A. the sequential Trainer (the reference's semantics);
  B. ParallelTrainer, lr_scale 1, at equal images seen;
  C. ParallelTrainer, lr_scale sqrt(D), at equal images seen;
  D. ParallelTrainer, lr_scale 1, at equal optimizer updates (D times the
     images).

D is the world size: one rank per process, NCCL between cards, gloo on the
CPU.  Every rank runs every arm (the sequential one alike on each); rank 0
writes the table, by default to CONVERGENCE_TORCH.md at the repository's
root.  ``CONV_ITERS`` (default 192) sets the iterations.

    torchrun --nproc_per_node D -m litegs_torch.convergence_parallel

On the CPU (gloo), through a child that asks for the CPU:

    CONV_ITERS=192 torchrun --nproc_per_node 8 --no-python python -c \
        "from litegs_torch import convergence_parallel as c; c.main(device='cpu')"
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

from . import config as cfg
from . import parallel
from .data import synthetic_train
from .parallel.trainer import ParallelTrainer
from .training.trainer import Trainer
from .utils import resolve_device

N_FRAMES = 8
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "CONVERGENCE_TORCH.md")


def runs(iters: int, d: int):
    """The data-parallel arms: (label, lr_scale, iterations)."""
    return (
        # equal images seen (D x fewer optimizer updates)
        ("parallel_equal_images_lr1", 1.0, iters),
        ("parallel_equal_images_lrsqrtD", math.sqrt(d), iters),
        # equal optimizer updates (D x more images: the multi-card
        # deployment, more data per unit wall-clock, same schedule length)
        ("parallel_equal_updates_lr1", 1.0, iters * d),
    )


def command(d: int, iters: int, device) -> str:
    """The command line that reproduces a run at world size ``d``."""
    if device.type == "cuda":
        return (f"CONV_ITERS={iters} torchrun --nproc_per_node {d} -m "
                "litegs_torch.convergence_parallel")
    return (f"CONV_ITERS={iters} torchrun --nproc_per_node {d} --no-python "
            "python -c \"from litegs_torch import convergence_parallel as "
            "c; c.main(device='cpu')\"")


def table(results: dict, d: int, iters: int, device) -> str:
    """The markdown record: the run, the table, and what its numbers
    show."""
    lines = [
        "# Data-parallel convergence parity of litegs_torch", "",
        f"Synthetic closed-loop task (500 points, {N_FRAMES} frames, 48x64, "
        "SH 1, seed 3), raster backend `torch`, on "
        f"{'the card' if device.type == 'cuda' else 'the CPU'} over D = "
        f"{d} ranks ({'NCCL' if device.type == 'cuda' else 'gloo'}); "
        "sequential = 1 view per update; parallel = D views per "
        "mean-gradient update with sharded statistics and sharded "
        "densification (`ParallelTrainer`). Written by "
        "`litegs_torch/convergence_parallel.py`:", "",
        f"    {command(d, iters, device)}", "",
        "| run | lr_scale | images seen | updates | final train PSNR (dB) |",
        "|---|---|---|---|---|",
    ]
    for label, r in results.items():
        lines.append(f"| {label} | {r['lr_scale']:.4g} | {r['images']} | "
                     f"{r['updates']} | {r['psnr']:.2f} |")
    seq = results["sequential"]["psnr"]
    img1 = results["parallel_equal_images_lr1"]["psnr"]
    imgs = results["parallel_equal_images_lrsqrtD"]["psnr"]
    upd = results["parallel_equal_updates_lr1"]["psnr"]
    lines += [
        "",
        f"At equal images, lr_scale 1 ends {img1 - seq:+.2f} dB from the "
        f"sequential run and lr_scale sqrt(D) {imgs - img1:+.2f} dB from "
        f"lr_scale 1. At equal updates, lr_scale 1 ends {upd - seq:+.2f} "
        "dB from the sequential run.",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None, device="cuda"):
    """Join the process group (torchrun's environment, or one already
    initialised), train the four arms on ``device`` and, on rank 0, write
    the table.  Returns {label: {lr_scale, images, updates, psnr}}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--output", default=DEFAULT_OUT,
                        help="where rank 0 writes the table")
    args = parser.parse_args(argv)
    dev = resolve_device(device)
    parallel.initialize_distributed(device=dev)
    d, rank = parallel.world()

    iters = int(os.environ.get("CONV_ITERS", 192))
    data, init_xyz, init_color = synthetic_train.make_task(
        n_points=500, n_frames=N_FRAMES, img_h=48, img_w=64, sh_degree=1,
        seed=3, device=dev)
    lp = cfg.ModelParams(sh_degree=1)
    op = cfg.OptimizationParams(iterations=iters,
                                position_lr_max_steps=iters)
    pp = cfg.PipelineParams(raster_backend="torch", adaptive_capacity=False)
    dp = cfg.DensifyParams(densification_interval=2, densify_from=1,
                           densify_until=8, opacity_reset_interval=10**9,
                           target_primitives=1024)
    caps = cfg.CapacityParams(primitive_capacity=2048,
                              visible_capacity=2048,
                              row_capacity=8192, entry_capacity=32768)

    def record(label, scale, trainer, state, hist, t0):
        results[label] = {"lr_scale": scale,
                          "images": trainer.total_epochs * trainer.n_frames,
                          "updates": int(state.step),
                          "psnr": hist[-1]["psnr"]}
        if rank == 0:
            print(json.dumps({"run": label, "psnr": hist[-1]["psnr"],
                              "s": round(time.time() - t0, 1)}), flush=True)

    results = {}
    t0 = time.time()
    seq = Trainer(lp=lp, op=op, pp=pp, dp=dp, caps=caps, data=data,
                  spatial_lr_scale=4.4)
    state, _, hist = seq.train(init_xyz, init_color, verbose=False)
    record("sequential", 1.0, seq, state, hist, t0)

    for label, scale, it in runs(iters, d):
        t0 = time.time()
        op_r = cfg.OptimizationParams(iterations=it,
                                      position_lr_max_steps=it)
        par = ParallelTrainer(lp=lp, op=op_r, pp=pp, dp=dp, caps=caps,
                              data=parallel.shard_camera_batch(data),
                              spatial_lr_scale=4.4, lr_scale=scale,
                              device=dev)
        state, _, hist = par.train(init_xyz, init_color, verbose=False)
        record(label, scale, par, state, hist, t0)

    if rank == 0:
        with open(args.output, "w") as f:
            f.write(table(results, d, iters, dev))
        print("wrote", os.path.abspath(args.output), file=sys.stderr)
    return results


if __name__ == "__main__":
    main()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
