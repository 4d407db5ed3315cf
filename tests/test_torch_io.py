"""litegs_torch's IO, data loading and CLI against litegs_tpu's, on CPU.

* COLMAP text and binary scenes (the writers of tests/test_io.py): cameras,
  frames, xyz and rgb identical to JAX's loader's; the points3D.ply cache
  byte-identical whichever package wrote it, and read by the other.
* ``split_train_test`` (every-8th and ``train_test_split.json``): the same
  names; ``camera_dataset_norm`` within 1e-6; ``load_image`` identical at
  every downsample and on a width over 1600 px; ``build_camera_batch``
  within 1e-6 (intrinsics scaled from the camera's size), and a video's
  frames through it identical.
* PLY: identical bytes at SH 0-3 with and without ``active_count``
  truncation; each package loads the other's file exactly; the point-cloud
  pair likewise.
* Checkpoints: the train state, stats and pose state round-trip exactly;
  a template of another structure or shape raises.
* The CLI (``litegs_torch.example_train`` -> ``example_metrics`` -> resume)
  on a COLMAP scene on disk with the ``torch`` backend; JAX's ``load_ply``
  reads the port's export as the port's own arrays, and the resume
  restores the checkpoint's arrays exactly.
"""
import dataclasses
import importlib
import json
import os

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from litegs_tpu import io as jio
from litegs_tpu.data import camera as jcamera
from litegs_tpu.scene.gaussians import GaussianParams

from litegs_torch import example_metrics, example_train
from litegs_torch import io as tio
from litegs_torch.data import camera as tcamera
from litegs_torch.data import synthetic as tsynthetic
from litegs_torch.data import synthetic_train as tsynthetic_train
from litegs_torch.ops import pose as tpose
from litegs_torch.scene import gaussians as tgauss
from litegs_torch.training import optimizer as topt
from litegs_torch.training import statistics as tstat
from litegs_torch.training.trainer import TrainState
from test_io import write_colmap_binary, write_colmap_text

# the modules (each package's training/__init__ exports the function start)
jstart = importlib.import_module("litegs_tpu.training.start")
tstart = importlib.import_module("litegs_torch.training.start")
CPU = "cpu"


def random_numpy_params(n=200, sh_degree=2, seed=0):
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2 - 1
    shapes = {"xyz": (3, n), "scale": (3, n), "rot": (4, n),
              "sh_0": (1, 3, n), "sh_rest": (k * 3, n), "opacity": (1, n)}
    return {f: rng.normal(size=s).astype(np.float32)
            for f, s in shapes.items()}


def assert_frames_equal(got, want):
    assert [f.name for f in got] == [f.name for f in want]
    for a, b in zip(got, want):
        assert (a.id, a.camera_id) == (b.id, b.camera_id)
        np.testing.assert_array_equal(a.qvec, b.qvec)
        np.testing.assert_array_equal(a.tvec, b.tvec)


@pytest.mark.parametrize("writer", [write_colmap_text, write_colmap_binary])
def test_colmap_load_and_cache_match_jax(tmp_path, writer):
    cam, frames = tsynthetic.make_cameras(4, 48, 64, seed=0)
    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(30, 3))
    rgb = rng.random((30, 3))
    firsts = {}
    for first in ("jax", "torch"):
        root = str(tmp_path / first)
        writer(os.path.join(root, "sparse", "0"), cam, frames, xyz, rgb)
        order = ((jio, tio, jio) if first == "jax" else (tio, jio, tio))
        # the first load parses the scene and writes the cache; the other
        # package reads that cache as the writer reads it back
        loads = [pkg.load_colmap_result(root) for pkg in order]
        firsts[first] = loads[0]
        np.testing.assert_array_equal(loads[1][2], loads[2][2])
        np.testing.assert_array_equal(loads[1][3], loads[2][3])
        np.testing.assert_allclose(loads[1][2], loads[0][2], atol=1e-6)
        cams_j, cams_t = (loads[0][0], loads[1][0]) if first == "jax" \
            else (loads[1][0], loads[0][0])
        assert {k: dataclasses.asdict(v) for k, v in cams_t.items()} == \
            {k: dataclasses.asdict(v) for k, v in cams_j.items()}
        assert_frames_equal(loads[1][1], loads[0][1])
    for i in (2, 3):   # parsed from the scene by each package
        np.testing.assert_array_equal(firsts["torch"][i], firsts["jax"][i])
    caches = [(tmp_path / p / "sparse" / "0" / "points3D.ply").read_bytes()
              for p in ("jax", "torch")]
    assert caches[0] == caches[1]


def test_split_train_test_matches_jax(tmp_path):
    _, frames = tsynthetic.make_cameras(19, 8, 8, seed=0)
    for eval_mode in (False, True):
        got = tstart.split_train_test(frames, eval_mode, str(tmp_path))
        want = jstart.split_train_test(frames, eval_mode, str(tmp_path))
        assert [[f.name for f in s] for s in got] == \
            [[f.name for f in s] for s in want]
    for i, f in enumerate(frames):
        f.name = f"{f.name}.png" if i % 2 else f.name
    with open(tmp_path / "train_test_split.json", "w") as fh:
        json.dump({"train": [f.name for f in frames[:11]],
                   "test": ["synth_0012", "synth_0015.png", "synth_0017"]},
                  fh)
    got = tstart.split_train_test(frames, True, str(tmp_path))
    want = jstart.split_train_test(frames, False, str(tmp_path))
    assert [[f.name for f in s] for s in got] == \
        [[f.name for f in s] for s in want]
    assert len(got[0]) == 11 and len(got[1]) == 3


def test_camera_dataset_norm_matches_jax():
    _, frames = tsynthetic.make_cameras(7, 8, 8, seed=4)
    t_avg, t_rad = tcamera.camera_dataset_norm(frames)
    j_avg, j_rad = jcamera.camera_dataset_norm(frames)
    np.testing.assert_allclose(t_avg, j_avg, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t_rad, j_rad, rtol=1e-6)


@pytest.mark.parametrize("mode,size", [("RGB", (150, 100)),
                                       ("L", (150, 100)),
                                       ("RGBA", (1700, 30))])
def test_load_image_matches_jax(tmp_path, mode, size):
    rng = np.random.default_rng(7)
    ch = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
    arr = (rng.random((size[1], size[0], ch)) * 255).astype(np.uint8)
    path = str(tmp_path / "img.png")
    PIL.Image.fromarray(arr[..., 0] if ch == 1 else arr, mode).save(path)
    for ds in (-1, 1, 2, 4, 8):
        got = tcamera.load_image(path, ds)
        want = jcamera.load_image(path, ds)
        assert got.dtype == np.uint8 and got.shape[0] == 3
        np.testing.assert_array_equal(got, want)
    if size[0] > 1600:     # the auto-rescale to 1600 px wide
        assert tcamera.load_image(path).shape[2] == 1600


def write_images(img_dir, frames, h, w, seed):
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for fr in frames:
        arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        PIL.Image.fromarray(arr).save(os.path.join(img_dir, fr.name))


def test_build_camera_batch_matches_jax(tmp_path):
    cam, frames = tsynthetic.make_cameras(3, 48, 64, seed=1)
    for fr in frames:
        fr.name = fr.name + ".png"
    # images at half the camera's size: per-frame intrinsics are scaled
    cams = {0: dataclasses.replace(cam, width=128, height=96)}
    write_images(str(tmp_path), frames, 48, 64, seed=0)
    got, gh, gw = tstart.build_camera_batch(cams, frames, str(tmp_path), -1,
                                            device=CPU)
    want, wh, ww = jstart.build_camera_batch(cams, frames, str(tmp_path), -1)
    assert (gh, gw) == (wh, ww) == (48, 64)
    for field in want._fields:
        a, b = getattr(got, field), np.asarray(getattr(want, field))
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6,
                                   err_msg=field)
    write_images(str(tmp_path), frames[1:2], 40, 64, seed=1)
    with pytest.raises(ValueError, match="mixed-resolution"):
        tstart.build_camera_batch(cams, frames, str(tmp_path), -1,
                                  device=CPU)


def test_video_frames_through_loader_match_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from litegs_tpu.data import video as jvideo
    from litegs_torch.data import video as tvideo
    h, w, n = 48, 64, 3
    path = str(tmp_path / "clip.avi")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 5, (w, h))
    rng = np.random.default_rng(0)
    raw = []
    for _ in range(n):
        frame = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        raw.append(frame)
        wr.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    wr.release()
    cam, frames = tsynthetic.make_cameras(n, h, w, seed=0)
    poses = [(f.qvec, f.tvec) for f in frames]
    got, bh, bw = tstart.build_camera_batch(
        {0: cam}, tvideo.video_frames(path, poses), "", -1, device=CPU)
    want, _, _ = jstart.build_camera_batch(
        {0: cam}, jvideo.video_frames(path, poses), "", -1)
    assert (bh, bw) == (h, w) and tuple(got.images.shape) == (n, 3, h, w)
    np.testing.assert_array_equal(got.images.numpy(),
                                  np.asarray(want.images))
    # MJPG is lossy: gross agreement with the written frames
    assert abs(float(got.images[0].mean()) * 255 - raw[0].mean()) < 30


@pytest.mark.parametrize("active", [None, 100])
@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_ply_bytes_and_cross_load_match_jax(tmp_path, sh_degree, active):
    p = random_numpy_params(n=256, sh_degree=sh_degree, seed=sh_degree)
    t_path, j_path = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    n = 256 if active is None else active
    tio.save_ply(t_path, tgauss.params_from_numpy(p, device=CPU),
                 active_count=active)
    jparams = GaussianParams(**{k: jnp.asarray(v) for k, v in p.items()})
    if sh_degree == 0:
        # JAX's save_ply reshapes the empty sh_rest with -1 and raises at
        # degree 0 (a JAX-side fault); the file it would write is built
        # here from its property names and column order
        with pytest.raises(ValueError, match="reshape"):
            jio.save_ply(j_path, jparams, active_count=active)
        cols = [p["xyz"].T, np.zeros((256, 3), np.float32), p["sh_0"][0].T,
                p["opacity"].T, p["scale"].T, p["rot"].T]
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}"]
        header += [f"property float {q}" for q in jio.ply._property_names(0)]
        with open(j_path, "wb") as f:
            f.write(("\n".join(header + ["end_header"]) + "\n").encode())
            f.write(np.concatenate(cols, 1)[:n].astype("<f4").tobytes())
    else:
        jio.save_ply(j_path, jparams, active_count=active)
    with open(t_path, "rb") as a, open(j_path, "rb") as b:
        assert a.read() == b.read()
    from_j = tgauss.params_to_numpy(tio.load_ply(j_path, device=CPU))
    from_t = jio.load_ply(t_path)
    for k, v in p.items():
        np.testing.assert_array_equal(from_j[k], v[..., :n])
        np.testing.assert_array_equal(np.asarray(getattr(from_t, k)),
                                      v[..., :n])


def test_pointcloud_ply_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    for rgb in (rng.random((50, 3)).astype(np.float32),
                rng.integers(0, 256, (50, 3)).astype(np.uint8)):
        t_path, j_path = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
        tio.ply.save_pointcloud_ply(t_path, xyz, rgb)
        jio.ply.save_pointcloud_ply(j_path, xyz, rgb)
        with open(t_path, "rb") as a, open(j_path, "rb") as b:
            assert a.read() == b.read()
        for got, want in zip(tio.ply.load_pointcloud_ply(j_path),
                             jio.ply.load_pointcloud_ply(t_path)):
            np.testing.assert_array_equal(got, want)


def ckpt_tree(seed: int, with_pose: bool):
    params = tgauss.params_from_numpy(random_numpy_params(128, 1, seed),
                                      device=CPU)
    adam = topt.init_adam(params)
    rng = np.random.default_rng(seed)
    for d in adam:
        for v in d.values():
            v.copy_(torch.from_numpy(rng.random(tuple(v.shape)).astype(
                np.float32)))
    stats = tstat.init_stats(128, CPU)._replace(
        grad_norm_sum=torch.from_numpy(rng.random(128).astype(np.float32)),
        visible_count=torch.full((128,), 3 + seed, dtype=torch.int32))
    tree = {"state": TrainState(params, adam, 100 + seed, 7 + seed),
            "stats": stats}
    if with_pose:
        pose = tpose.init_pose_state(rng.random((5, 7)), CPU)
        tree["pose"] = pose._replace(
            m=torch.ones_like(pose.m) * seed,
            step=torch.tensor(4 + seed, dtype=torch.int32))
    return tree


def flat(tree):
    return dict(tio.checkpoint._leaves(tree))


def test_checkpoint_roundtrip_and_template_checks(tmp_path):
    saved = ckpt_tree(0, with_pose=True)
    path = tio.save_checkpoint(str(tmp_path), 5, saved)
    assert path.endswith("chkpnt5.npz")
    epoch, restored = tio.load_checkpoint(path, ckpt_tree(1, True))
    assert epoch == 5
    assert isinstance(restored["state"], TrainState)
    assert isinstance(restored["state"].params, tgauss.GaussianModel)
    assert isinstance(restored["pose"], tpose.PoseState)
    want, got = flat(saved), flat(restored)
    assert set(want) == set(got) and "pose.extr" in got
    assert "state.adam.exp_avg_sq.sh_rest" in got
    for k, v in want.items():
        if torch.is_tensor(v):
            assert got[k].dtype == v.dtype, k
            assert torch.equal(got[k], v), k
        else:
            assert type(got[k]) is int and got[k] == v, k
    # another structure (no pose state) or another capacity raises
    with pytest.raises(ValueError, match="keys differ"):
        tio.load_checkpoint(path, ckpt_tree(1, False))
    small = ckpt_tree(1, True)
    small["stats"] = tstat.init_stats(64, CPU)
    with pytest.raises(ValueError, match="stats.visible_count"):
        tio.load_checkpoint(path, small)


def make_disk_dataset(root, n_frames=6, n_points=400, img_h=48, img_w=64):
    """tests/test_io.py's COLMAP-layout dataset with PNGs, built by the
    port's synthetic task."""
    data, init_xyz, init_rgb = tsynthetic_train.make_task(
        n_points=n_points, n_frames=n_frames, img_h=img_h, img_w=img_w,
        sh_degree=1, seed=5, device=CPU)
    cam, frames = tsynthetic.make_cameras(n_frames, img_h, img_w, seed=5)
    for fr in frames:
        fr.name = fr.name + ".png"
    write_colmap_text(os.path.join(root, "sparse", "0"), cam, frames,
                      init_xyz.astype(np.float64), init_rgb)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    for i, fr in enumerate(frames):
        arr = (np.clip(data.images[i].numpy(), 0, 1) * 255).astype(
            np.uint8).transpose(1, 2, 0)
        PIL.Image.fromarray(arr).save(os.path.join(img_dir, fr.name))
    return root


def test_cli_train_metrics_resume(tmp_path, monkeypatch):
    """COLMAP dataset -> train CLI -> ply -> metrics -> resume, on CPU."""
    scene = make_disk_dataset(str(tmp_path / "scene"))
    model = str(tmp_path / "model")
    common = ["-s", scene, "--eval", "--iterations", "36", "--sh_degree",
              "1", "--target_primitives", "1024", "--densify_from", "1",
              "--densify_until", "3", "--raster_backend", "torch"]
    trainer, state, hist = example_train.main(
        common + ["-m", model, "--test_epochs", "4",
                  "--checkpoint_epochs", "2", "--save_epochs", "3"],
        device=CPU)
    assert trainer.total_epochs == 7 and len(hist) == 7
    assert hist[-1]["psnr"] > hist[0]["psnr"] + 5.0
    assert np.isfinite(hist[4]["test_psnr"])
    final_ply = os.path.join(model, "point_cloud", "finish",
                             "point_cloud.ply")
    assert os.path.exists(os.path.join(model, "point_cloud",
                                       "iteration_20", "point_cloud.ply"))
    ckpt = os.path.join(model, "checkpoints", "chkpnt2.npz")
    assert os.path.exists(ckpt) and os.path.exists(ckpt + ".json")
    # JAX's loader reads the port's export as the port's own arrays
    loaded = jio.load_ply(final_ply)
    n = state.active_count
    assert loaded.capacity == n
    for k, v in tgauss.params_to_numpy(state.params).items():
        np.testing.assert_array_equal(np.asarray(getattr(loaded, k)),
                                      v[..., :n])

    res = example_metrics.main(["-s", scene, "-m", model, "--skip_train",
                                "--raster_backend", "torch"], device=CPU)
    assert list(res) == ["test"] and res["test"]["n_views"] == 1
    assert res["test"]["lpips"] is None
    assert 15.0 < res["test"]["psnr"] < 60.0

    # resume: start restores exactly the arrays the checkpoint holds
    real = tio.load_checkpoint
    seen = []

    def spy(path, template):
        epoch, tree = real(path, template)
        # copies: training goes on to update the restored tensors in place
        seen.append((epoch, {k: v.detach().clone() if torch.is_tensor(v)
                             else v for k, v in flat(tree).items()}))
        return epoch, tree

    monkeypatch.setattr(tio, "load_checkpoint", spy)
    model2 = str(tmp_path / "model_resumed")
    _, _, hist2 = example_train.main(
        common + ["-m", model2, "--start_checkpoint", ckpt], device=CPU)
    assert [h["epoch"] for h in hist2] == [3, 4, 5, 6]
    assert os.path.exists(os.path.join(model2, "point_cloud", "finish",
                                       "point_cloud.ply"))
    (epoch, restored), = seen
    assert epoch == 2
    with np.load(ckpt) as saved:
        assert set(restored) == set(saved.files)
        for k, v in restored.items():
            np.testing.assert_array_equal(
                v.numpy() if torch.is_tensor(v) else np.asarray(v),
                saved[k], err_msg=k)
