"""litegs_torch.bench against the root bench.py, on CPU.

* ``make_workload`` at 2,000 points and 64x96 against the root bench's
  scene built by the JAX package: ``make_cameras``, ``make_gaussian_cloud``,
  ``create_gaussians`` at SH 3 with log-scales - 0.7, padded to a multiple
  of 128 * 128, the ``default_rng(1)`` targets and the live chunks'
  bounds (of the port's model), within 1e-6; the log-scales within 1e-4: both packages take
  the kNN distances as |x|^2 + |y|^2 - 2 x.y in float32, whose rounding
  at this cloud's spacing (d^2 ~ 5e-3 against |x|^2 ~ 2) is ~5e-5 of d^2
  (tests/test_torch_elementwise.py holds the kNN itself).
* ``bench.main(device="cpu")`` at 500 points, 32x48 (two 32x24 tiles),
  2 frames and 2 iterations, in train mode, render mode and at
  ``BENCH_B=2``, prints exactly one stdout line whose keys are the keys of
  the root script's ``json.dumps`` dict of that mode, read from its source
  with ``ast`` by ``chip_smoke.root_bench_keys`` (the root script is
  neither imported nor run).  The train
  and render cases take the plain raster backend (``torch``); the batched
  step needs the ``cuda`` backend, as JAX's batched step needs Pallas, and
  on CPU tensors that backend's wrappers take their plain versions.
"""
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litegs_tpu import config as jcfg
from litegs_tpu.data import synthetic as jsynthetic
from litegs_tpu.scene import create_gaussians, pad_params
from litegs_tpu.scene.gaussians import GaussianParams
from litegs_tpu.training import trainer as jtrainer

from chip_smoke import root_bench_keys
from litegs_torch import bench
from litegs_torch.scene import params_to_numpy

N_POINTS, IMG_H, IMG_W, N_FRAMES = 2000, 64, 96, 2


@pytest.fixture
def one_thread():
    """One intra-op thread: the bench's runs here are small, and the suite
    runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_workload_matches_jax():
    got = bench.make_workload(N_POINTS, IMG_H, IMG_W, N_FRAMES,
                              device="cpu")
    cam, frames = jsynthetic.make_cameras(N_FRAMES, IMG_H, IMG_W, seed=0)
    xyz, rgb = jsynthetic.make_gaussian_cloud(N_POINTS, seed=0)
    params = create_gaussians(xyz, rgb, 3)
    params = params._replace(scale=params.scale - 0.7)
    params = pad_params(params, jcfg.round_up(N_POINTS, 128 * 128))
    gt = np.random.default_rng(1).random(
        (N_FRAMES, 3, IMG_H, IMG_W)).astype(np.float32)
    batch = jtrainer.camera_batch_from_frames(cam, frames, gt)

    assert got.active_count == N_POINTS
    assert got.params.capacity == 128 * 128
    tp = params_to_numpy(got.params)
    # the chunk bounds of the port's own model (its scales differ from
    # JAX's by the kNN's rounding)
    origin, extend = jtrainer.masked_chunk_aabb(
        GaussianParams(**{k: jnp.asarray(v) for k, v in tp.items()}),
        jnp.int32(N_POINTS), 128)
    for k, v in params._asdict().items():
        tol = 1e-4 if k == "scale" else 1e-6
        np.testing.assert_allclose(tp[k], np.asarray(v), rtol=1e-6,
                                   atol=tol, err_msg=k)
    for k in ("view", "proj", "planes", "center", "images"):
        np.testing.assert_allclose(getattr(got.batch, k).numpy(),
                                   np.asarray(getattr(batch, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got.batch.images.numpy(), gt)
    np.testing.assert_allclose(got.origin.numpy(), np.asarray(origin),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.extend.numpy(), np.asarray(extend),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode, env, metric", [
    ("train", {}, "train_iters_per_sec"),
    ("render", {"BENCH_MODE": "render"}, "render_mpix_per_sec"),
    ("batched", {"BENCH_B": "2", "BENCH_BACKEND": "cuda"},
     "train_views_per_sec"),
], ids=["train", "render", "batched"])
def test_bench_prints_one_line_with_the_root_keys(monkeypatch, capsys,
                                                  one_thread, mode, env,
                                                  metric):
    knobs = {"BENCH_POINTS": "500", "BENCH_H": "32", "BENCH_W": "48",
             "BENCH_ITERS": "2",
             "BENCH_FRAMES": str(N_FRAMES), "BENCH_BACKEND": "torch",
             **env}
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    returned = bench.main(device="cpu")
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1, out
    got = json.loads(lines[0])
    assert got == returned
    assert list(got) == root_bench_keys()[metric]
    assert got["metric"] == metric
    assert math.isfinite(got["value"]) and got["value"] > 0
    assert f"raster={knobs['BENCH_BACKEND']}" in err
    assert "tile=32x24" in err and "iters=2" in err
