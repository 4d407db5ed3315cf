"""Offline metric evaluation of a trained model on the card (the port's
``example_metrics.py``; reference example_metrics.py:92-156): re-render the
train/test splits from a saved ply and report SSIM / PSNR / LPIPS (LPIPS
"n/a": no weights ship).

    python -m litegs_torch.example_metrics -s <scene_dir> -m <model_dir>
"""
import argparse
import os

from . import config as cfg
from . import evaluation
from . import io as io_manager
from .training.start import build_camera_batch, split_train_test
from .utils import resolve_device


def find_ply(model_path: str) -> str:
    finish = os.path.join(model_path, "point_cloud", "finish",
                          "point_cloud.ply")
    if os.path.exists(finish):
        return finish
    root = os.path.join(model_path, "point_cloud")
    iters = sorted((d for d in os.listdir(root)
                    if d.startswith("iteration_")),
                   key=lambda d: int(d.split("_")[1]))
    if not iters:
        raise FileNotFoundError(f"no point_cloud under {model_path}")
    return os.path.join(root, iters[-1], "point_cloud.ply")


def main(argv=None, device="cuda"):
    """Parse ``argv`` and score on ``device``; returns {split: score_split
    result}."""
    parser = argparse.ArgumentParser()
    cfg.add_cmdline_args(parser)
    parser.add_argument("--ply", type=str, default=None,
                        help="explicit ply path (default: latest export)")
    parser.add_argument("--dump_images", action="store_true")
    parser.add_argument("--skip_train", action="store_true")
    args = parser.parse_args(argv)
    lp, _, pp, _ = cfg.extract_groups(args)
    dev = resolve_device(device)

    ply_path = args.ply or find_ply(lp.model_path)
    params = io_manager.load_ply(ply_path, device=dev)
    sh_degree = params.sh_degree
    print(f"loaded {params.capacity} gaussians (SH degree {sh_degree}) "
          f"from {ply_path}", flush=True)
    params, active = evaluation.prepare_model(params, pp)

    cams, frames, _, _ = io_manager.load_colmap_result(lp.source_path)
    train_frames, test_frames = split_train_test(frames, True,
                                                 lp.source_path)
    images_dir = os.path.join(lp.source_path, lp.images)
    splits = [] if args.skip_train else [("train", train_frames)]
    splits.append(("test", test_frames))
    results = {}
    for name, split_frames in splits:
        if not split_frames:
            continue
        batch, _, _ = build_camera_batch(cams, split_frames, images_dir,
                                         lp.resolution, device=dev)
        dump = (os.path.join(lp.model_path, f"renders_{name}")
                if args.dump_images else None)
        res = evaluation.score_split(params, active, batch, pp, sh_degree,
                                     dump_dir=dump)
        results[name] = res
        lp_str = f"{res['lpips']:.4f}" if res["lpips"] is not None else "n/a"
        print(f"{name}: SSIM {res['ssim']:.4f}  PSNR {res['psnr']:.2f}  "
              f"LPIPS {lp_str}  ({res['n_views']} views)", flush=True)
    return results


if __name__ == "__main__":
    main()
