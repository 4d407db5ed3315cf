"""End-to-end convergence check on the card, no dataset needed (the port
of ``scripts/synthetic_convergence.py``).

Trains against ground-truth renders of a procedurally generated gaussian
scene (the closed-loop task of ``data.synthetic_train``) with the full
pipeline -- the raster and binning kernels, densification -- and reports
train PSNR over epochs, with the JAX script's flags, defaults and printed
lines.

    python -m litegs_torch.synthetic_convergence --points 20000 --iters 1200

Densify toward 1M from a sparse init (the command of CONVERGENCE_r5.md):

    python -m litegs_torch.synthetic_convergence --points 1200000 \
        --init_points 150000 --color_freq 3.0 --target 1000000 --frames 10 \
        --sh_degree 3 --tile 32x24 --static_caps --iters 6000
"""
import argparse
import time

from . import config as cfg
from .data import synthetic_train
from .training import statistics
from .training.trainer import Trainer
from .utils import resolve_device

# the JAX script's backend names: its Pallas kernels map to the port's
# hand-written kernels, its jnp path to the plain PyTorch path
BACKENDS = {"pallas": "cuda", "jnp": "torch", "cuda": "cuda",
            "torch": "torch"}


def main(argv=None, device="cuda"):
    """Parse ``argv`` and train on ``device``.  Returns one record per
    epoch: epoch, psnr, loss, active and the seconds since training
    started (host clock)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--points", type=int, default=20000)
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--width", type=int, default=384)
    parser.add_argument("--iters", type=int, default=1200)
    parser.add_argument("--target", type=int, default=60000)
    parser.add_argument("--sh_degree", type=int, default=2)
    parser.add_argument("--backend", type=str, default="cuda",
                        choices=sorted(BACKENDS),
                        help="raster backend: cuda (the kernels) or torch "
                             "(the plain path); the JAX script's pallas "
                             "and jnp name them too")
    parser.add_argument("--densify_mode", type=str, default="taming",
                        choices=["taming", "official"])
    parser.add_argument("--init_points", type=int, default=None,
                        help="subsample the GT cloud to this many init "
                             "points (SfM-sparse-init regime; the model "
                             "must densify toward the GT density)")
    parser.add_argument("--color_freq", type=float, default=1.0,
                        help="GT color-field frequency multiplier; > 1 "
                             "adds texture finer than the init splats, "
                             "keeping densification scores alive")
    parser.add_argument("--static_caps", action="store_true",
                        help="accepted for the JAX script's command lines "
                             "and without effect: the port sizes its "
                             "buffers from the data and has no capacity "
                             "buckets")
    parser.add_argument("--tile", type=str, default="16x32",
                        help="tile size HxW (16x32 suits the small "
                             "default frame; use 32x24 at garden scale)")
    args = parser.parse_args(argv)
    dev = resolve_device(device)
    backend = BACKENDS[args.backend]

    t0 = time.time()
    data, init_xyz, init_color = synthetic_train.make_task(
        n_points=args.points, n_frames=args.frames, img_h=args.height,
        img_w=args.width, sh_degree=args.sh_degree, seed=0,
        init_points=args.init_points, color_freq=args.color_freq,
        device=dev)
    print(f"scene built in {time.time()-t0:.1f}s", flush=True)

    lp = cfg.ModelParams(sh_degree=args.sh_degree)
    op = cfg.OptimizationParams(iterations=args.iters,
                                position_lr_max_steps=args.iters)
    th, tw = map(int, args.tile.split("x"))
    pp = cfg.PipelineParams(raster_backend=backend, tile_size=(th, tw),
                            adaptive_capacity=not args.static_caps)
    total_epochs = max(args.iters // args.frames, 1)
    dp = cfg.DensifyParams(densification_interval=4, densify_from=3,
                           densify_until=int(total_epochs * 0.7),
                           opacity_reset_interval=10 ** 9,
                           target_primitives=args.target,
                           densify_mode=args.densify_mode)
    caps = cfg.auto_capacity(max(args.target, args.points) + 1)
    trainer = Trainer(lp=lp, op=op, pp=pp, dp=dp, caps=caps, data=data,
                      spatial_lr_scale=4.0)
    state = trainer.init_state(init_xyz, init_color)
    stats = statistics.init_stats(caps.primitive_capacity, dev)
    history = []
    t0 = time.time()
    for epoch in range(trainer.total_epochs):
        state, stats, m = trainer.run_epoch(state, stats, epoch)
        state, stats = trainer.epoch_boundary(state, stats, epoch)
        history.append({"epoch": epoch, "psnr": m["psnr"],
                        "loss": m["loss"], "active": int(state.active_count),
                        "seconds": time.time() - t0})
        if epoch % 10 == 0 or epoch == trainer.total_epochs - 1:
            print(f"[epoch {epoch:4d}] psnr={m['psnr']:.2f} "
                  f"loss={m['loss']:.4f} active={int(state.active_count)} "
                  f"({time.time()-t0:.0f}s)", flush=True)
    iters = trainer.total_epochs * trainer.n_frames
    dt = time.time() - t0
    # a step of the port cannot overflow (training/trainer.py), so the
    # count the JAX script prints is 0 here by construction
    print(f"final train PSNR {m['psnr']:.2f} dB; {iters} iters in "
          f"{dt:.0f}s = {iters/dt:.2f} it/s; overflows=0", flush=True)
    return history


if __name__ == "__main__":
    main()
