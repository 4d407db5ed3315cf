"""litegs_torch's elementwise layer against litegs_tpu on the same inputs.

Config, camera math, SH (degrees 0-4), projection, chunk culling and
compaction order, Morton order, gaussian creation with the exact kNN,
activation and the numpy model round trip.  Float values are held at
1e-5 (float32 arithmetic in another order); integer and boolean outputs
must be identical.
"""
import argparse
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litegs_tpu import config as jcfg
from litegs_tpu.data import synthetic as jsynth
from litegs_tpu.ops import losses as jlosses
from litegs_tpu.ops import projection as jproj
from litegs_tpu.scene import cluster as jcluster
from litegs_tpu.scene import gaussians as jgauss
from litegs_tpu.scene import morton as jmorton
from litegs_tpu.utils import math as jum
from litegs_tpu.utils import sh as jsh

from litegs_torch import config as tcfg
from litegs_torch.data import synthetic as tsynth
from litegs_torch.ops import losses as tlosses
from litegs_torch.ops import projection as tproj
from litegs_torch.scene import cluster as tcluster
from litegs_torch.scene import gaussians as tgauss
from litegs_torch.scene import morton as tmorton
from litegs_torch.utils import math as tum
from litegs_torch.utils import sh as tsh

ATOL = 1e-5
CPU = "cpu"


def T(x):
    return torch.tensor(np.asarray(x))


def N(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def close(a, b, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(N(a), N(b), atol=atol, rtol=rtol)


def test_config_groups_match():
    argv = ["--sh_degree", "2", "--tile_size", "16", "32", "--enable_depth",
            "--lambda_dssim", "0.3", "-s", "/data/scene"]
    groups = []
    for mod in (jcfg, tcfg):
        parser = argparse.ArgumentParser()
        mod.add_cmdline_args(parser)
        groups.append(mod.extract_groups(parser.parse_args(argv)))
    for gj, gt in zip(*groups):
        dj, dt = dataclasses.asdict(gj), dataclasses.asdict(gt)
        # the one field whose values differ by package
        assert dj.pop("raster_backend", "pallas") == "pallas"
        dt.pop("raster_backend", None)
        assert dj == dt
    assert groups[1][2].raster_backend == "cuda"
    assert groups[1][2].tile_size == (16, 32)
    assert tcfg.round_up(130, 128) == jcfg.round_up(130, 128) == 256


def test_cameras_and_frustum_planes():
    cam_j, frames_j = jsynth.make_cameras(3, 48, 64, seed=3)
    cam_t, frames_t = tsynth.make_cameras(3, 48, 64, seed=3)
    np.testing.assert_array_equal(cam_j.proj_matrix(), cam_t.proj_matrix())
    for fj, ft in zip(frames_j, frames_t):
        np.testing.assert_array_equal(fj.view_matrix(), ft.view_matrix())
        np.testing.assert_array_equal(fj.camera_center(), ft.camera_center())
        np.testing.assert_array_equal(fj.frustumplane(cam_j.proj_matrix()),
                                      ft.frustumplane(cam_t.proj_matrix()))
    xyz_j, rgb_j = jsynth.make_gaussian_cloud(500, seed=2, freq=2.0)
    xyz_t, rgb_t = tsynth.make_gaussian_cloud(500, seed=2, freq=2.0)
    np.testing.assert_array_equal(xyz_j, xyz_t)
    np.testing.assert_array_equal(rgb_j, rgb_t)


def test_frustum_culling_and_tiles():
    rng = np.random.default_rng(0)
    cam, frames = tsynth.make_cameras(2, 48, 64, seed=1)
    planes = np.stack([f.frustumplane(cam.proj_matrix()) for f in frames])
    origin = rng.uniform(-6, 6, (3, 400)).astype(np.float32)
    ext = rng.uniform(0, 0.5, (3, 400)).astype(np.float32)
    for pl in (planes[0], planes):
        vj = jum.frustum_culling_aabb(jnp.asarray(pl), jnp.asarray(origin),
                                      jnp.asarray(ext))
        vt = tum.frustum_culling_aabb(T(pl), T(origin), T(ext))
        np.testing.assert_array_equal(N(vj), N(vt))
        assert 0 < N(vt).sum() < 400
    img = rng.random((3, 37, 45)).astype(np.float32)
    tj = jum.img_to_tiles(jnp.asarray(img), 8, 16)
    tt = tum.img_to_tiles(T(img), 8, 16)
    np.testing.assert_array_equal(N(tj), N(tt))
    np.testing.assert_array_equal(
        N(jum.tiles_to_img(tj, 37, 45, 8, 16)),
        N(tum.tiles_to_img(tt, 37, 45, 8, 16)))


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_degrees(deg):
    rng = np.random.default_rng(deg)
    n = 64
    k = (deg + 1) ** 2
    sh0 = rng.normal(size=(1, 3, n)).astype(np.float32)
    rest = rng.normal(size=(max(k - 1, 1) * 3, n)).astype(np.float32)
    dirs = rng.normal(size=(3, n))
    dirs = (dirs / np.linalg.norm(dirs, axis=0)).astype(np.float32)
    want = jsh.sh_to_rgb_split(deg, jnp.asarray(sh0), jnp.asarray(rest),
                               jnp.asarray(dirs))
    got = tsh.sh_to_rgb_split(deg, T(sh0), T(rest), T(dirs))
    close(got, want)
    full = np.concatenate([sh0, rest.reshape(-1, 3, n)], axis=0)
    close(tsh.sh_to_rgb(deg, T(full), T(dirs)),
          jsh.sh_to_rgb(deg, jnp.asarray(full), jnp.asarray(dirs)))
    rgb = rng.random((3, n)).astype(np.float32)
    close(tsh.rgb_to_sh0(T(rgb)), jsh.rgb_to_sh0(jnp.asarray(rgb)))


def _scene_points(n, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.5, 1.5, (3, n)).astype(np.float32)
    scale = np.exp(rng.uniform(-4, -1.5, (3, n))).astype(np.float32)
    rot = rng.normal(size=(4, n)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=0)
    return xyz, scale, rot


def test_projection_chain():
    img_h, img_w = 48, 64
    cam, frames = tsynth.make_cameras(1, img_h, img_w, seed=5)
    view = frames[0].view_matrix()
    proj = cam.proj_matrix()
    xyz, scale, rot = _scene_points(300, seed=6)
    jxh = jproj.homogeneous(jnp.asarray(xyz))
    txh = tproj.homogeneous(T(xyz))
    close(txh, jxh)
    vp_j, ndc_j = jproj.mvp_transform(jxh, jnp.asarray(view),
                                      jnp.asarray(proj))
    vp_t, ndc_t = tproj.mvp_transform(txh, T(view), T(proj))
    close(vp_t, vp_j)
    close(ndc_t, ndc_j)
    jac_j = jproj.rayspace_jacobian(vp_j, jnp.asarray(proj), img_h, img_w)
    jac_t = tproj.rayspace_jacobian(vp_t, T(proj), img_h, img_w)
    close(jac_t, jac_j, atol=0.0, rtol=1e-5)
    close(tproj.create_transform_matrix(T(scale), T(rot)),
          jproj.create_transform_matrix(jnp.asarray(scale),
                                        jnp.asarray(rot)))
    cov_j = jproj.cov2d_fused(jnp.asarray(scale), jnp.asarray(rot), jac_j,
                              jnp.asarray(view))
    cov_t = tproj.cov2d_fused(T(scale), T(rot), jac_t, T(view))
    close(cov_t, cov_j, atol=0.0, rtol=1e-5)
    close(tproj.inverse_2x2_sym(cov_t), jproj.inverse_2x2_sym(cov_j),
          atol=0.0, rtol=1e-5)
    close(tproj.ndc_to_pixel(ndc_t, img_h, img_w),
          jproj.ndc_to_pixel(ndc_j, img_h, img_w), atol=1e-4)
    # degenerate covariance -> zero inverse in both
    deg = np.zeros((3, 2), np.float32)
    np.testing.assert_array_equal(N(tproj.inverse_2x2_sym(T(deg))),
                                  N(jproj.inverse_2x2_sym(jnp.asarray(deg))))


def test_cluster_aabb_visible_order_and_gather():
    xyz, scale, rot = _scene_points(128 * 12, seed=7)
    oj, ej = jcluster.chunk_aabb(jnp.asarray(xyz), jnp.asarray(scale),
                                 jnp.asarray(rot), 128)
    ot, et = tcluster.chunk_aabb(T(xyz), T(scale), T(rot), 128)
    close(ot, oj)
    close(et, ej)
    vis = np.random.default_rng(8).random(12) < 0.5
    ids_j, num_j, _ = jcluster.visible_chunk_ids(jnp.asarray(vis), 12)
    ids_t, num_t = tcluster.visible_chunk_ids(T(vis))
    assert int(num_j) == num_t
    np.testing.assert_array_equal(N(ids_j)[:num_t], N(ids_t))
    np.testing.assert_array_equal(
        N(jcluster.gather_chunks(jnp.asarray(xyz), ids_j[:num_t], 128)),
        N(tcluster.gather_chunks(T(xyz), ids_t, 128)))


def test_morton_order():
    xyz, _, _ = _scene_points(1000, seed=9)
    xyz[:, 10] = xyz[:, 11]           # a tie: stable order decides
    np.testing.assert_array_equal(
        N(jmorton.morton_codes(jnp.asarray(xyz))),
        N(tmorton.morton_codes(T(xyz))))
    # 900 live points and a tail parked as pad_params parks it: the port
    # boxes the live points (LiteGS's box), the JAX package every slot, so
    # JAX is given the live prefix alone, whose box is the live box
    xyz[:, 900:] = 1e8
    mask = np.arange(1000) < 900
    live = jnp.asarray(xyz[:, :900])
    np.testing.assert_array_equal(
        N(jmorton.morton_codes(live)),
        N(tmorton.morton_codes(T(xyz), T(mask)))[:900])
    got = N(tmorton.spatial_sort_indices(T(xyz), T(mask)))
    np.testing.assert_array_equal(N(jmorton.spatial_sort_indices(live)),
                                  got[:900])
    np.testing.assert_array_equal(got[900:], np.arange(900, 1000))
    assert (got[:900] != np.arange(900)).any()


def test_create_gaussians_knn_activate_and_roundtrip():
    xyz, rgb = jsynth.make_gaussian_cloud(700, seed=11)
    pj = jgauss.create_gaussians(xyz, rgb, 3)
    pt = tgauss.create_gaussians(xyz, rgb, 3, device=CPU)
    assert pt.sh_degree == pj.sh_degree == 3
    got = tgauss.params_to_numpy(pt)
    for name in tgauss.FIELDS:
        close(got[name], getattr(pj, name))
    for a, b in zip(jgauss.activate(pj), tgauss.activate(pt)):
        close(b, a)
    # the numpy round trip carries the JAX model across exactly
    model = tgauss.params_from_numpy(
        {k: np.asarray(v) for k, v in pj._asdict().items()}, device=CPU)
    back = tgauss.params_to_numpy(model)
    for name in tgauss.FIELDS:
        np.testing.assert_array_equal(back[name], np.asarray(
            getattr(pj, name)))
    padded_j = jgauss.pad_to_chunk(jgauss.pad_params(pj, 900), 128)
    padded_t = tgauss.pad_to_chunk(tgauss.pad_params(model, 900), 128)
    assert padded_t.capacity == padded_j.capacity == 1024
    back = tgauss.params_to_numpy(padded_t)
    for name in tgauss.FIELDS:
        np.testing.assert_array_equal(back[name], np.asarray(
            getattr(padded_j, name)))


def test_knn_chunked_blocks_agree():
    rng = np.random.default_rng(12)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    want = jgauss.knn_mean_sq_dist(jnp.asarray(pts), block=128)
    got = tgauss.knn_mean_sq_dist(T(pts), block=128)
    close(got, want, atol=0.0, rtol=1e-5)
    close(tgauss.knn_mean_sq_dist(T(pts), block=256), got, atol=0.0,
          rtol=1e-6)


def test_losses_match_jax():
    rng = np.random.default_rng(13)
    img = rng.random((3, 30, 41)).astype(np.float32)
    gt = np.clip(img + rng.normal(0, 0.1, img.shape), 0, 1).astype(np.float32)
    ji, jg, ti, tg = jnp.asarray(img), jnp.asarray(gt), T(img), T(gt)
    for name in ("l1", "ssim", "psnr"):
        close(getattr(tlosses, name)(ti, tg), getattr(jlosses, name)(ji, jg),
              atol=1e-4 if name == "psnr" else ATOL)
    close(tlosses.fused_l1_ssim_loss(ti, tg, 0.3),
          jlosses.fused_l1_ssim_loss(ji, jg, 0.3))
