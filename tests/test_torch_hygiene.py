"""litegs_torch stands alone: no JAX, no litegs_tpu, no quiet CPU fallback.

This file imports neither JAX nor litegs_tpu itself.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "litegs_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_import_leaves_no_jax_module():
    code = ("import sys, litegs_torch; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN}]"
            "; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_imports_jax_or_litegs_tpu():
    files = sorted((ROOT / "litegs_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        bad = set(_imported_roots(path)) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from litegs_torch.data import synthetic
    from litegs_torch.scene import create_gaussians, params_from_numpy
    from litegs_torch.training.trainer import camera_batch_from_frames
    xyz, rgb = synthetic.make_gaussian_cloud(10, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_gaussians(xyz, rgb, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({k: np.zeros((3, 4), np.float32) for k in (
            "xyz", "scale", "rot", "sh_0", "sh_rest", "opacity")})
    cam, frames = synthetic.make_cameras(1, 8, 8, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        camera_batch_from_frames(cam, frames, np.zeros((1, 3, 8, 8)))
    # the data-parallel entry points and the LPIPS network
    from litegs_torch import config, parallel
    from litegs_torch.ops import lpips
    from litegs_torch.parallel.trainer import ParallelTrainer
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.initialize_distributed()
    assert parallel.initialize_distributed(device="cpu") == 1
    kw = dict(lp=config.ModelParams(), op=config.OptimizationParams(),
              pp=config.PipelineParams(), dp=config.DensifyParams(),
              caps=config.CapacityParams(256),
              data=camera_batch_from_frames(cam, frames,
                                            np.zeros((1, 3, 8, 8)), "cpu"),
              spatial_lr_scale=1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ParallelTrainer(**kw)
    assert ParallelTrainer(**kw, device="cpu").n_frames == 1
    weights = {"convs": [(np.zeros((o, i, 3, 3), np.float32),
                          np.zeros(o, np.float32)) for i, o in (
                             (3, 64), (64, 64), (64, 128), (128, 128),
                             (128, 256), (256, 256), (256, 256), (256, 512),
                             (512, 512), (512, 512), (512, 512), (512, 512),
                             (512, 512))],
               "lins": [np.ones(c, np.float32)
                        for c in (64, 128, 256, 512, 512)]}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lpips.LPIPSVGG(weights)
    assert float(lpips.LPIPSVGG(weights, device="cpu")(
        torch.zeros(3, 16, 16), torch.ones(3, 16, 16))) == 0.0


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """chip_smoke exits nonzero and prints no result without a card, and
    alone in a directory without the package."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((tmp_path, "chip_smoke.py"),
                        (ROOT, "chip_smoke.py")):
        if cwd == ROOT and torch.cuda.is_available():
            continue
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_training_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from litegs_torch.data import synthetic_train
    from litegs_torch.ops import raster
    from litegs_torch.training import statistics
    for fn in (lambda: synthetic_train.make_task(n_points=8, n_frames=1),
               lambda: statistics.init_stats(128),
               lambda: raster.zero_stats_sink(8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


def test_io_entry_points_default_to_cuda(tmp_path):
    """start, the command-line entry points (training, metrics, the bench
    and the speed challenge's pair) and the ply loader raise without a
    card unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from litegs_torch import (bench, challenge_eval, challenge_train, config,
                              example_metrics, example_train, io)
    from litegs_torch.training import start
    args = ["-s", str(tmp_path), "-m", str(tmp_path / "model")]
    timing = ["--timing_json", str(tmp_path / "t.json")]
    for fn in (lambda: start(*config.get_default_arg()),
               lambda: example_train.main(args),
               lambda: example_metrics.main(args),
               lambda: bench.main(),
               lambda: challenge_train.main(args + timing),
               lambda: challenge_eval.main(args + timing),
               lambda: io.load_ply(str(tmp_path / "missing.ply"))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


def test_io_and_pose_modules_import_no_jax():
    for rel in ("io/__init__.py", "io/checkpoint.py", "io/colmap.py",
                "io/ply.py", "data/video.py", "ops/pose.py",
                "training/start.py", "example_train.py",
                "example_metrics.py", "ops/lpips.py", "parallel/__init__.py",
                "parallel/densify.py", "parallel/trainer.py",
                "utils/profiling.py", "full_eval.py",
                "full_eval_aggressive.py", "scale_curve.py",
                "print_results.py", "bench.py", "challenge_train.py",
                "challenge_eval.py"):
        roots = set(_imported_roots(ROOT / "litegs_torch" / rel))
        assert not roots & set(FORBIDDEN), rel


def test_stream_gather_imports_no_jax():
    path = ROOT / "litegs_torch" / "ops" / "stream_gather.py"
    roots = set(_imported_roots(path))
    assert "torch" in roots and not roots & set(FORBIDDEN)


def test_streaming_binning_is_the_default_on_cuda_tensors():
    from litegs_torch import config
    from litegs_torch.ops import binning
    assert config.BINNING_STREAM is True
    assert binning.stream_route(None) == "keys"
    assert binning.stream_route(True) == "window"
    assert binning.stream_route(False) is None


def test_stream_gather_takes_the_plain_version_only_on_cpu_tensors():
    """A tensor that does not lie on the CPU never reaches a plain version,
    and without a compiler the kernel route raises instead of falling
    back."""
    from litegs_torch.ops import _kernels, stream_gather
    attrs = torch.zeros((2, 8), device="meta")
    counts = torch.ones(8, dtype=torch.int32, device="meta")
    before = stream_gather.PLAIN_CALLS
    for call in (lambda: stream_gather.expand_attrs(attrs, counts, 8),
                 lambda: stream_gather.expand_attrs_windowed(attrs, counts,
                                                             8),
                 lambda: stream_gather.gather_blocks(attrs, counts)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    assert stream_gather.PLAIN_CALLS == before
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernels build")
    assert _kernels.CSRC.joinpath("stream_gather.cu").exists()
    launches = dict(stream_gather.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        stream_gather._launch("expand_prefix_kernel", "litegs_expand_prefix")
    assert stream_gather.LAUNCHES == launches


def test_binning_kernels_take_only_cuda_tensors():
    """The 'keys' route's wrappers refuse tensors off the card, and without
    a compiler the kernel route raises instead of falling back."""
    from litegs_torch.ops import _kernels, binning_cuda
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA device"):
        binning_cuda.point_inputs(torch.zeros(4, 4), z, torch.zeros(3, 4), z,
                                  torch.ones(4, dtype=torch.bool))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernels build")
    assert _kernels.CSRC.joinpath("binning.cu").exists()
    launches = dict(binning_cuda.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        binning_cuda._launch("bin_count_kernel", "litegs_bin_count")
    assert binning_cuda.LAUNCHES == launches
