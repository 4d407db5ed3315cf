"""litegs_torch's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither JAX nor litegs_tpu, so it runs on a machine that has only
PyTorch; run it there with the repository's JAX conftest left out:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Forward tolerance 1e-4 (max |diff|): the kernel multiplies transmittance
sequentially where the plain version exponentiates a sum of logs, and an
entry whose alpha sits right at the 1/256 cut or whose transmittance sits
right at the 1/8192 stop may fall on either side.  Backward: per-point
gradients 3e-4 (max |diff| / max |plain|, the scaled bar of
tests/test_raster_pallas.py), weight_sum 2e-3, frag_count 0.5 and
err_square_sum 1e-3 scaled; the kernel adds per-entry sums with atomics
in no fixed order and carries its prefix in float32.
"""
import numpy as np
import pytest
import torch

from litegs_torch import config, evaluation
from litegs_torch.data import synthetic
from litegs_torch.data import synthetic_train
from litegs_torch.ops import binning, raster_cuda, raster_plain
from litegs_torch.scene import create_gaussians, pad_params
from litegs_torch.training import optimizer, statistics
from litegs_torch.training.trainer import (TrainState,
                                           camera_batch_from_frames,
                                           make_train_step,
                                           masked_chunk_aabb)

TOL = 1e-4
TILES = [(8, 16), (16, 16), (16, 32), (32, 24), (32, 32)]


@pytest.fixture
def cuda_device():
    # decided inside the test run, never at import or collection time
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def screen_scene(n, seed, img_h, img_w, scale_px, dev):
    """Random screen-space gaussians: (mean, inv_cov, color, opacity,
    view_z, ndc) as float32 tensors on ``dev``."""
    rng = np.random.default_rng(seed)
    mx = rng.uniform(-8, img_w + 8, n)
    my = rng.uniform(-8, img_h + 8, n)
    theta = rng.uniform(0, 2 * np.pi, n)
    s1, s2 = rng.uniform(*scale_px, n), rng.uniform(*scale_px, n)
    ct, st = np.cos(theta), np.sin(theta)
    a = ct * ct * s1 * s1 + st * st * s2 * s2
    b = ct * st * (s1 * s1 - s2 * s2)
    c = st * st * s1 * s1 + ct * ct * s2 * s2
    det = a * c - b * b
    ndc = np.stack([(mx + 0.5) / img_w * 2 - 1, (my + 0.5) / img_h * 2 - 1,
                    np.full(n, 0.5), np.ones(n)])
    arrays = (np.stack([mx, my]), np.stack([c / det, -b / det, a / det]),
              rng.random((3, n)), rng.uniform(0.02, 0.99, n),
              rng.uniform(0.5, 10.0, n), ndc)
    return [torch.tensor(x, dtype=torch.float32, device=dev)
            for x in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("tile", TILES)
def test_kernel_matches_plain(cuda_device, tile):
    tile_h, tile_w = tile
    img_h, img_w = 72, 100
    tiles_x = -(-img_w // tile_w)
    for n, seed, spx, depth in ((60, 1, (1.0, 8.0), False),
                                (3 * tile_h * tile_w, 2, (6.0, 16.0), True),
                                (3, 3, (0.5, 1.0), True)):
        mean, inv, color, op, z, ndc = screen_scene(n, seed, img_h, img_w,
                                                    spx, cuda_device)
        if depth:
            color = torch.cat([color, z[None]])
        table = binning.build_tile_table(
            ndc, z, inv, op, torch.ones(n, dtype=torch.bool,
                                        device=cuda_device),
            img_h, img_w, tile_h, tile_w)
        args = (mean, inv, color, op, table.sorted_point, table.tile_start,
                table.tile_count, tiles_x, tile_h, tile_w)
        before = raster_cuda.LAUNCHES
        col, trans = raster_cuda.raster_forward(*args)
        torch.cuda.synchronize()
        assert raster_cuda.LAUNCHES == before + 1
        col_p, trans_p = raster_cuda.raster_forward_plain(*args)
        assert (col - col_p).abs().max().item() <= TOL
        assert (trans - trans_p).abs().max().item() <= TOL
        empty = table.tile_count == 0
        assert bool((col[empty] == 0).all() and (trans[empty] == 1).all())


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    mean, inv, color, op, z, ndc = screen_scene(20, 4, 40, 64, (1.0, 4.0),
                                                cuda_device)
    table = binning.build_tile_table(
        ndc, z, inv, op, torch.ones(20, dtype=torch.bool,
                                    device=cuda_device), 40, 64, 8, 16)
    tab = (table.sorted_point, table.tile_start, table.tile_count)
    with pytest.raises(TypeError):
        raster_cuda.raster_forward(mean.double(), inv, color, op, *tab,
                                   4, 8, 16)
    with pytest.raises(ValueError):
        raster_cuda.raster_forward(mean, inv, color[:2], op, *tab, 4, 8, 16)
    with pytest.raises(ValueError):
        raster_cuda.raster_forward(mean, inv, color, op, *tab, 4, 32, 64)
    with pytest.raises(ValueError, match="outside"):
        raster_cuda.raster_forward(mean, inv, color, op, tab[0],
                                   tab[1] + 1, tab[2], 4, 8, 16)
    with pytest.raises(ValueError, match="point ids"):
        raster_cuda.raster_forward(mean, inv, color, op, tab[0] + 20,
                                   tab[1], tab[2], 4, 8, 16)


@pytest.mark.cuda
def test_render_and_score_kernel_vs_plain(cuda_device):
    """The serving path on the card: kernel and 'torch' backend agree."""
    img_h, img_w, sh = 64, 96, 2
    cam, frames = synthetic.make_cameras(2, img_h, img_w, seed=0)
    xyz, rgb = synthetic.make_gaussian_cloud(3000, seed=0)
    model = create_gaussians(xyz, rgb, sh, device=cuda_device)
    batch = camera_batch_from_frames(
        cam, frames, np.zeros((2, 3, img_h, img_w), np.float32),
        device=cuda_device)
    imgs = {}
    for backend in ("cuda", "torch"):
        pp = config.PipelineParams(raster_backend=backend)
        prepared, active = evaluation.prepare_model(model, pp)
        imgs[backend] = torch.stack([img for _, img in
                                     evaluation.render_views(
                                         prepared, active, batch, pp, sh)])
    assert float(imgs["cuda"].mean()) > 0.01
    assert (imgs["cuda"] - imgs["torch"]).abs().max().item() <= TOL
    scores = evaluation.score_split(prepared, active,
                                    batch._replace(images=imgs["cuda"]),
                                    config.PipelineParams(), sh)
    assert scores["psnr"] >= 60.0 and scores["n_views"] == 2


def assert_grads_close(got: raster_plain.PointGrads,
                       want: raster_plain.PointGrads):
    for field in ("d_mean", "d_inv_cov", "d_color", "d_opacity"):
        a, b = getattr(got, field), getattr(want, field)
        scale = b.abs().max().item() + 1e-12
        assert (a - b).abs().max().item() <= 3e-4 * scale, field
    if want.weight_sum is not None:
        assert (got.weight_sum - want.weight_sum).abs().max() <= 2e-3
        assert (got.frag_count - want.frag_count).abs().max() <= 0.5
        scale = want.err_square_sum.abs().max().item() + 1e-12
        assert ((got.err_square_sum - want.err_square_sum).abs().max()
                <= 1e-3 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", TILES)
def test_backward_kernel_matches_plain(cuda_device, tile):
    tile_h, tile_w = tile
    img_h, img_w = 72, 100
    tiles_x = -(-img_w // tile_w)
    for n, seed, spx, depth in ((60, 1, (1.0, 8.0), False),
                                (3 * tile_h * tile_w, 2, (6.0, 16.0), True),
                                (3, 3, (0.5, 1.0), True)):
        mean, inv, color, op, z, ndc = screen_scene(n, seed, img_h, img_w,
                                                    spx, cuda_device)
        if depth:
            color = torch.cat([color, z[None]])
        table = binning.build_tile_table(
            ndc, z, inv, op, torch.ones(n, dtype=torch.bool,
                                        device=cuda_device),
            img_h, img_w, tile_h, tile_w)
        args = (mean, inv, color, op, table.sorted_point, table.tile_start,
                table.tile_count, tiles_x, tile_h, tile_w)
        col, trans = raster_cuda.raster_forward(*args)
        gen = torch.Generator(device=cuda_device).manual_seed(seed)
        cot = (torch.randn(col.shape, generator=gen, device=cuda_device),
               torch.randn(trans.shape, generator=gen, device=cuda_device))
        for with_stats in (False, True):
            before = raster_cuda.LAUNCHES_BWD
            got = raster_cuda.raster_backward(*args, col, trans, *cot,
                                              with_stats=with_stats)
            torch.cuda.synchronize()
            assert raster_cuda.LAUNCHES_BWD == before + 1
            want = raster_cuda.raster_backward_plain(
                *args, col, trans, *cot, with_stats=with_stats)
            assert_grads_close(got, want)


@pytest.mark.cuda
def test_train_step_kernels_vs_plain(cuda_device):
    """One steady and one statistics step on the card: the 'cuda' backend
    (the kernels) against the 'torch' backend (autograd through the plain
    version) from the same state."""
    data, xyz, rgb = synthetic_train.make_task(
        n_points=500, n_frames=2, img_h=48, img_w=64, sh_degree=1, seed=3,
        device=cuda_device)
    base = pad_params(create_gaussians(xyz, rgb, 1, device=cuda_device),
                      1024)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    with torch.no_grad():
        base.rot[:, :500] = torch.randn((4, 500), generator=gen,
                                        device=cuda_device)
    lp = config.ModelParams(sh_degree=1)
    op = config.OptimizationParams(iterations=96, position_lr_max_steps=96)
    adam0 = optimizer.init_adam(base)
    for d in adam0:
        for v in d.values():
            v.uniform_(1e-8, 1e-6, generator=gen)
    view = [x[1] for x in data]
    for collect in (False, True):
        out = {}
        for backend in ("cuda", "torch"):
            params = base.mapped(torch.clone)
            adam = optimizer.AdamState(*[{k: v.clone() for k, v in d.items()}
                                         for d in adam0])
            step = make_train_step(
                lp, op, config.PipelineParams(raster_backend=backend),
                config.CapacityParams(1024), 48, 64, 4.4, 1, collect)
            with torch.no_grad():
                origin, extend = masked_chunk_aabb(params, 512, 128)
            state, stats, metrics = step(
                TrainState(params, adam, 512, 0),
                statistics.init_stats(1024, cuda_device), origin, extend,
                *view)
            out[backend] = (state, stats, metrics)
        (sk, stk, mk), (sp, stp, mp) = out["cuda"], out["torch"]
        assert abs(mk["loss"].item() - mp["loss"].item()) <= 1e-5
        for k in sk.adam.exp_avg:
            a, b = sk.adam.exp_avg[k], sp.adam.exp_avg[k]
            assert (a - b).abs().max() <= 3e-4 * b.abs().max(), k
        if collect:
            assert (stk.weight_sum - stp.weight_sum).abs().max() <= 2e-3
            assert (stk.frag_count - stp.frag_count).abs().max() <= 0.5
            assert torch.equal(stk.visible_count, stp.visible_count)
