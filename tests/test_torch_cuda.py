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
in no fixed order and carries its prefix in float32.  The four
stream_gather kernels copy words and count ranks: tolerance 0, and the
window kernels' ``ok`` bit for bit.
"""
import numpy as np
import pytest
import torch

from litegs_torch import config, evaluation
from litegs_torch.data import synthetic
from litegs_torch.data import synthetic_train
from litegs_torch.ops import binning, raster_cuda, raster_plain
from litegs_torch.ops import stream_gather
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


def screen_scene(n, seed, img_h, img_w, scale_px, dev,
                 opacity=(0.02, 0.99), graze=False):
    """Random screen-space gaussians: (mean, inv_cov, color, opacity,
    view_z, ndc) as float32 tensors on ``dev``.  ``graze``: each centre is
    moved so that its alpha >= 1/256 region ends within 0.05 pixel of a
    column or row of pixel centres on an 8-pixel boundary, the edges of
    the kernels' warp blocks."""
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
    op = rng.uniform(*opacity, n)
    if graze:
        # extent of {alpha >= 1/256} along x and y: sqrt(t a), sqrt(t c)
        # for the covariance [[a, b], [b, c]], t = 2 ln(256 o)
        t = 2 * np.log(np.maximum(256 * op, 1.0))
        edge = 8 * rng.integers(0, img_w // 8 + 1, n) + rng.choice([-1, 0], n)
        side = rng.choice([-1.0, 1.0], n)
        mx = edge + side * (np.sqrt(t * a) + rng.uniform(-0.05, 0.05, n))
        edge = 8 * rng.integers(0, img_h // 8 + 1, n) + rng.choice([-1, 0], n)
        my_g = edge + side * (np.sqrt(t * c) + rng.uniform(-0.05, 0.05, n))
        my = np.where(rng.random(n) < 0.5, my_g, my)
    ndc = np.stack([(mx + 0.5) / img_w * 2 - 1, (my + 0.5) / img_h * 2 - 1,
                    np.full(n, 0.5), np.ones(n)])
    arrays = (np.stack([mx, my]), np.stack([c / det, -b / det, a / det]),
              rng.random((3, n)), op, rng.uniform(0.5, 10.0, n), ndc)
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


# scenes of the redesigned kernels' own cases: (name, points, pixel
# scales, opacities, grazing centres, depth channel)
REDESIGN_CASES = [
    # faint wide splats: tiles of more than four batches of entries whose
    # pixels stay unsaturated through them (both kernels stage 128 or 256
    # entries per batch)
    ("many batches", 5000, (15.0, 35.0), (0.004, 0.012), False, False),
    # the same depth, saturating part-way
    ("many batches, saturating", 5000, (15.0, 35.0), (0.02, 0.3), False,
     True),
    # alpha >= 1/256 regions ending at the warp blocks' edges
    ("grazing", 600, (0.5, 6.0), (0.003, 0.99), True, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("case", REDESIGN_CASES, ids=lambda c: c[0])
def test_kernels_on_redesign_cases(cuda_device, tile, case):
    """Forward at 1e-4, backward with and without statistics at the bars
    of assert_grads_close (frag_count exactly), walked, evaluated and
    contributing consistent with the table and with frag_count."""
    name, n, spx, op_range, graze, depth = case
    tile_h, tile_w = tile
    img_h, img_w = 64, 96
    tiles_x = -(-img_w // tile_w)
    mean, inv, color, op, z, ndc = screen_scene(
        n, 40 + tile_h + tile_w, img_h, img_w, spx, cuda_device,
        opacity=op_range, graze=graze)
    if depth:
        color = torch.cat([color, z[None]])
    table = binning.build_tile_table(
        ndc, z, inv, op, torch.ones(n, dtype=torch.bool, device=cuda_device),
        img_h, img_w, tile_h, tile_w)
    if name.startswith("many"):
        assert int(table.tile_count.max()) > 4 * 256, name
    args = (mean, inv, color, op, table.sorted_point, table.tile_start,
            table.tile_count, tiles_x, tile_h, tile_w)
    npix = tile_h * tile_w
    walked = torch.zeros((table.tile_count.numel(), npix), dtype=torch.int32,
                         device=cuda_device)
    evaluated = torch.zeros_like(walked)
    contributing = torch.zeros_like(walked)
    col, trans = raster_cuda.raster_forward(*args, walked=walked,
                                            evaluated=evaluated,
                                            contributing=contributing)
    col_p, trans_p = raster_cuda.raster_forward_plain(*args)
    assert (col - col_p).abs().max().item() <= TOL
    assert (trans - trans_p).abs().max().item() <= TOL
    cnt = table.tile_count[:, None]
    assert bool((contributing <= evaluated).all()
                and (evaluated <= walked).all() and (walked <= cnt).all())
    # a pixel that did not saturate walked its whole tile
    assert bool((walked[trans > 1 / 8192] == cnt.expand_as(walked)[
        trans > 1 / 8192]).all())
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    cot = (torch.randn(col.shape, generator=gen, device=cuda_device),
           torch.randn(trans.shape, generator=gen, device=cuda_device))
    for with_stats in (False, True):
        got = raster_cuda.raster_backward(*args, col, trans, *cot,
                                          with_stats=with_stats)
        want = raster_cuda.raster_backward_plain(*args, col, trans, *cot,
                                                 with_stats=with_stats)
        assert_grads_close(got, want)
        if with_stats:
            assert torch.equal(got.frag_count, want.frag_count)
            assert int(got.frag_count.double().sum()) == int(contributing.sum())


def merged_scene(tile, dev, views=3, img_h=72, img_w=100):
    """``views`` seeded screen scenes (C = 3 and 4 alternating) merged into
    one table over views x T tiles: (single-view raster args per view,
    merged raster args, tiles_y, point offsets)."""
    tile_h, tile_w = tile
    tiles_x, tiles_y = -(-img_w // tile_w), -(-img_h // tile_h)
    singles, tables = [], []
    for v in range(views):
        n = (60, 3 * tile_h * tile_w, 5)[v % 3]
        mean, inv, color, op, z, ndc = screen_scene(
            n, 70 + v, img_h, img_w, ((1.0, 8.0), (6.0, 16.0),
                                      (0.5, 1.0))[v % 3], dev)
        color = torch.cat([color, z[None]])
        table = binning.build_tile_table(
            ndc, z, inv, op, torch.ones(n, dtype=torch.bool, device=dev),
            img_h, img_w, tile_h, tile_w)
        tables.append(table)
        singles.append((mean, inv, color, op, table.sorted_point,
                        table.tile_start, table.tile_count, tiles_x, tile_h,
                        tile_w))
    merged = binning.concat_tables(tables, tiles_x * tiles_y)
    attrs = [torch.cat([a[k] for a in singles], dim=-1) for k in range(4)]
    offsets = np.cumsum([0] + [a[3].numel() for a in singles]).tolist()
    return singles, (*attrs, merged.sorted_point, merged.tile_start,
                     merged.tile_count, tiles_x, tile_h, tile_w), tiles_y, \
        offsets


@pytest.mark.cuda
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("nchan", [3, 4])
def test_merged_grid_kernels_match_plain_and_single_views(cuda_device, tile,
                                                          nchan):
    """Three views on one merged grid of partial tiles (72x100): the
    forward within TOL of its plain version and bit-equal to each view's
    own launch, the backward with and without statistics at
    assert_grads_close's bars, frag_count equal to the views' own."""
    singles, margs, tiles_y, off = merged_scene(tile, cuda_device)
    margs = (*margs[:2], margs[2][:nchan], *margs[3:])
    singles = [(*a[:2], a[2][:nchan], *a[3:]) for a in singles]
    before = raster_cuda.LAUNCHES
    col, trans = raster_cuda.raster_forward(*margs, tiles_y=tiles_y)
    torch.cuda.synchronize()
    assert raster_cuda.LAUNCHES == before + 1
    col_p, trans_p = raster_cuda.raster_forward_plain(*margs,
                                                      tiles_y=tiles_y)
    assert (col - col_p).abs().max().item() <= TOL
    assert (trans - trans_p).abs().max().item() <= TOL
    view_tiles = col.shape[0] // len(singles)
    outs = [raster_cuda.raster_forward(*a) for a in singles]
    for v, (c, t) in enumerate(outs):
        rows = slice(v * view_tiles, (v + 1) * view_tiles)
        assert torch.equal(col[rows], c) and torch.equal(trans[rows], t), v
    gen = torch.Generator(device=cuda_device).manual_seed(nchan)
    cot = (torch.randn(col.shape, generator=gen, device=cuda_device),
           torch.randn(trans.shape, generator=gen, device=cuda_device))
    for with_stats in (False, True):
        got = raster_cuda.raster_backward(*margs, col, trans, *cot,
                                          with_stats=with_stats,
                                          tiles_y=tiles_y)
        want = raster_cuda.raster_backward_plain(
            *margs, col, trans, *cot, with_stats=with_stats,
            tiles_y=tiles_y)
        assert_grads_close(got, want)
        if not with_stats:
            continue
        assert torch.equal(got.frag_count, want.frag_count)
        for v, (a, (c, t)) in enumerate(zip(singles, outs)):
            rows = slice(v * view_tiles, (v + 1) * view_tiles)
            own = raster_cuda.raster_backward(
                *a, c, t, cot[0][rows], cot[1][rows], with_stats=True)
            assert torch.equal(got.frag_count[off[v]:off[v + 1]],
                               own.frag_count), v


@pytest.mark.cuda
def test_render_batch_on_partial_tiles_equals_single_views(cuda_device):
    """render_batch with the kernels at 37x53 (8x16 tiles, the last row
    and column cut): images and transmittance bit-equal to each view's
    own render, and the merged grid without the wrap wrong."""
    from litegs_torch import render as rnd
    img_h, img_w = 37, 53
    dev = cuda_device
    cam, frames = synthetic.make_cameras(3, img_h, img_w, seed=0)
    xyz, rgb = synthetic.make_gaussian_cloud(2000, seed=1)
    params = pad_params(create_gaussians(xyz, rgb, 2, device=dev), 2048)
    pp = config.PipelineParams(enable_transmitance=True)
    batch = camera_batch_from_frames(
        cam, frames, np.zeros((3, 3, img_h, img_w), np.float32), device=dev)
    with torch.no_grad():
        o, e = masked_chunk_aabb(params, 2048, 128)
        culled = [rnd.render_preprocess(params, o, e, batch.planes[v],
                                        batch.center[v], 2, pp)
                  for v in range(3)]
        before = raster_cuda.LAUNCHES
        out = rnd.render_batch(culled, batch.view, batch.proj, img_h, img_w,
                               pp)
        assert raster_cuda.LAUNCHES == before + 1
        for v in range(3):
            single = rnd.render(culled[v], batch.view[v], batch.proj[v],
                                img_h, img_w, pp)
            assert torch.equal(out.imgs[v], single.img), v
            assert torch.equal(out.transmitance[v], single.transmitance), v
            assert torch.equal(out.primitive_visible[v],
                               single.primitive_visible), v
        aux = out.aux
        args = (aux.mean_pix, aux.inv_cov, aux.color_chan, aux.opacity,
                aux.table.sorted_point, aux.table.tile_start,
                aux.table.tile_count, 4, 8, 16)
        _, trans0 = raster_cuda.raster_forward(*args)
        assert not torch.equal(trans0, aux.tiles_trans)


@pytest.mark.cuda
def test_launch_check_refuses_a_partial_merged_grid(cuda_device):
    _, margs, tiles_y, _ = merged_scene((8, 16), cuda_device, views=2)
    tiles_x = margs[7]
    assert margs[5].numel() == 2 * tiles_x * tiles_y
    cut = (*margs[:5], margs[5][:-tiles_x], margs[6][:-tiles_x],
           *margs[7:])
    with pytest.raises(ValueError, match="tiles_y"):
        raster_cuda.raster_forward(*cut, tiles_y=tiles_y)
    col, trans = raster_cuda.raster_forward(*margs, tiles_y=tiles_y)
    with pytest.raises(ValueError, match="tiles_y"):
        raster_cuda.raster_backward(*cut, col[:-tiles_x], trans[:-tiles_x],
                                    col[:-tiles_x], trans[:-tiles_x],
                                    tiles_y=tiles_y)
    # a whole number of rows is still a single-view grid without tiles_y
    raster_cuda.raster_forward(*cut)


def expansion_cases():
    """(name, attrs, counts, out_len, window_items, slots_per_step,
    prefix): numpy inputs of the streaming expansions; ``prefix`` says
    whether the counts > 0 form a prefix (expand_attrs's contract)."""
    rng = np.random.default_rng(0)
    counts = rng.integers(1, 5, 300).astype(np.int32)
    counts[200:] = 0
    yield ("prefix", rng.random((16, 300)).astype(np.float32), counts, 1024,
           256, 256, True)
    yield ("spanning", np.arange(151, dtype=np.float32)[None].repeat(8, 0),
           np.r_[np.full(1, 200), np.ones(150)].astype(np.int32), 512, 256,
           128, True)
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 4, 700).astype(np.int32)
    counts[rng.random(700) < 0.4] = 0
    yield ("zeros anywhere", rng.standard_normal((8, 700)).astype(
        np.float32), counts, None, 256, 128, False)
    rng = np.random.default_rng(5)
    counts = rng.integers(1, 5, 2000).astype(np.int32)
    yield ("multi-slot steps, int32 rows", rng.integers(
        -2 ** 31, 2 ** 31 - 1, (16, 2000)).astype(np.int32), counts, None,
        640, 512, True)
    yield ("odd sizes", rng.standard_normal((3, 1001)).astype(np.float32),
           rng.integers(1, 90, 1001).astype(np.int32), 30001, 384, 200, True)
    # lengths of 4k + 1, 4k + 2 and 4k + 3: ragged row ends, and rows of
    # such a length start off 16-byte boundaries
    rng = np.random.default_rng(8)
    counts = rng.integers(0, 5, 3001).astype(np.int32)
    counts[rng.random(3001) < 0.4] = 0
    yield ("one row, 4k+1 slots past the total", rng.standard_normal(
        (1, 3001)).astype(np.float32), counts,
        int(counts.sum()) // 4 * 4 + 41, 768, 512, False)
    counts = rng.integers(1, 4, 2000).astype(np.int32)
    counts[1700:] = 0
    yield ("twelve rows, 4k+2 slots short of the total", rng.integers(
        -2 ** 31, 2 ** 31 - 1, (12, 2000)).astype(np.int32), counts,
        int(counts.sum()) // 4 * 4 - 98, 640, 512, True)
    counts = rng.integers(0, 6, 900).astype(np.int32)
    yield ("4k+3 slots, 200-slot steps", rng.standard_normal(
        (3, 900)).astype(np.float32), counts,
        int(counts.sum()) // 4 * 4 + 7, 384, 200, False)
    yield ("one item", rng.standard_normal((5, 1)).astype(np.float32),
           np.array([77], np.int32), None, 128, 128, True)
    s = 2 ** 20 + 4099
    yield ("over 2^20 items", rng.standard_normal((3, s)).astype(
        np.float32), rng.integers(0, 3, s).astype(np.int32), None, 768, 512,
        False)
    # step 0's owners 0 and 256: exactly window_items apart
    counts = np.zeros(1024, np.int32)
    counts[0], counts[256], counts[700] = 1, 127, 40
    yield ("owners at the window's limit", rng.standard_normal(
        (8, 1024)).astype(np.float32), counts, 256, 256, 128, False)


def layout_cases():
    """expansion_cases' tuples with one more field, the word offset of
    attrs in its buffer, for the layouts the window kernels branch on:
    S not a multiple of 4 with attrs 4 bytes off a 16-byte boundary (word
    copies), A = 1, 3, 12 and 16, out_len not a multiple of the step, and
    more steps than the async kernel's persistent grid has blocks (at most
    16 a multiprocessor, 132 of them)."""
    for case in expansion_cases():
        yield (*case, 0)
    rng = np.random.default_rng(21)
    for a in (1, 3, 12, 16):
        counts = rng.integers(0, 4, 2003).astype(np.int32)
        yield (f"A={a}, S=4k+3, attrs off 16 bytes", rng.standard_normal(
            (a, 2003)).astype(np.float32), counts, None, 640, 512, False, 1)
    counts = rng.integers(0, 4, 4096).astype(np.int32)
    yield ("A=12, S=4k, a 77-slot last step", rng.integers(
        -2 ** 31, 2 ** 31 - 1, (12, 4096)).astype(np.int32), counts,
        int(counts.sum()) // 512 * 512 + 77, 640, 512, False, 0)
    counts = rng.integers(1, 3, 300_000).astype(np.int32)
    yield ("3,500+ steps of 128 slots", rng.standard_normal(
        (3, 300_000)).astype(np.float32), counts, None, 256, 128, True, 0)


def device_rows(attrs, dev, offset: int):
    """attrs as a contiguous [A, S] view that starts ``offset`` words into
    a flat buffer on ``dev``."""
    flat = torch.empty(attrs.size + offset, dtype=torch.from_numpy(
        attrs).dtype, device=dev)
    rows = flat[offset:].view(attrs.shape)
    rows.copy_(torch.from_numpy(attrs))
    return rows


@pytest.mark.cuda
def test_expansion_kernels_match_plain(cuda_device):
    for name, attrs, counts, out_len, window, step, prefix, offset in \
            layout_cases():
        attrs = device_rows(attrs, cuda_device, offset)
        counts = torch.tensor(counts, device=cuda_device)
        want = stream_gather.expand_attrs_windowed_plain(
            attrs, counts, out_len, window, step)
        total = int(want[2])
        live = min(total, want[0].shape[1])
        assert bool(want[3]), name
        runs = [("expand_window_kernel",
                 lambda: stream_gather.expand_attrs_windowed(
                     attrs, counts, out_len, window, step)),
                ("expand_window_async_kernel",
                 lambda: stream_gather.expand_attrs_windowed(
                     attrs, counts, out_len, window, step, dma=True))]
        if prefix:
            runs.append(("expand_prefix_kernel",
                         lambda: stream_gather.expand_attrs(attrs, counts,
                                                            out_len)))
        for kernel, run in runs:
            before = stream_gather.LAUNCHES[kernel]
            plain_before = stream_gather.PLAIN_CALLS
            got = run()
            torch.cuda.synchronize()
            assert stream_gather.LAUNCHES[kernel] == before + 1
            assert stream_gather.PLAIN_CALLS == plain_before
            assert int(got[2]) == total, (name, kernel)
            assert got[0].shape == want[0].shape and got[0].dtype == \
                attrs.dtype
            assert torch.equal(got[0][:, :live], want[0][:, :live]), \
                (name, kernel)
            assert torch.equal(got[1][:live], want[1][:live]), (name, kernel)
            if len(got) == 4:
                assert bool(got[3])


@pytest.mark.cuda
def test_expansion_window_overrun_is_flagged(cuda_device):
    counts = torch.zeros(1024, dtype=torch.int32, device=cuda_device)
    counts[0], counts[600] = 1, 300
    attrs = torch.arange(8 * 1024, dtype=torch.float32,
                         device=cuda_device).reshape(8, 1024)
    for dma in (False, True):
        out = stream_gather.expand_attrs_windowed(
            attrs, counts, 512, window_items=256, slots_per_step=128,
            dma=dma)
        torch.cuda.synchronize()
        assert not bool(out[3]) and int(out[2]) == 301
    # step 0's owners 0 and 257: one item past the window's limit (the case
    # at the limit is one of expansion_cases)
    past = torch.zeros(1024, dtype=torch.int32, device=cuda_device)
    past[0], past[257], past[700] = 1, 127, 40
    for dma in (False, True):
        out = stream_gather.expand_attrs_windowed(
            attrs, past, 256, window_items=256, slots_per_step=128, dma=dma)
        want = stream_gather.expand_attrs_windowed_plain(
            attrs, past, 256, window_items=256, slots_per_step=128)
        torch.cuda.synchronize()
        assert not bool(out[3]) and not bool(want[3]) and int(out[2]) == 168
    # all-zero counts launch nothing and return empty buffers
    before = dict(stream_gather.LAUNCHES)
    out = stream_gather.expand_attrs_windowed(attrs, counts * 0)
    assert out[0].shape == (8, 0) and bool(out[3])
    # and so does an expansion of no items
    for dma in (False, True):
        out = stream_gather.expand_attrs_windowed(attrs[:, :0], counts[:0],
                                                  dma=dma)
        assert out[0].shape == (8, 0) and int(out[2]) == 0 and bool(out[3])
    out = stream_gather.expand_attrs(attrs[:, :0], counts[:0])
    assert out[0].shape == (8, 0) and int(out[2]) == 0
    assert stream_gather.LAUNCHES == before


@pytest.mark.cuda
def test_window_kernel_matches_block_model(cuda_device):
    """expand_window_kernel against window_step_plain, the plain model of
    one of its blocks, on up to 64 steps of every case, and
    expand_window_async_kernel against window_block_plain, the plain model
    of its persistent blocks, on every step: the owner of every slot and
    its rank, slots past the total included."""
    for name, attrs, counts, out_len, window, step, _, offset in \
            layout_cases():
        attrs_d = device_rows(attrs, cuda_device, offset)
        counts_d = torch.tensor(counts, device=cuda_device)
        out, rank, total, ok = stream_gather.expand_attrs_windowed(
            attrs_d, counts_d, out_len, window, step)
        out, rank = out.cpu(), rank.cpu()
        assert bool(ok), name
        cum = torch.cumsum(torch.tensor(counts), 0)
        n_slots = rank.shape[0]
        steps = -(-n_slots // step)
        for b in sorted(set(np.linspace(0, steps - 1, 64).astype(int))):
            lo, ok_b, owner, want_rank = stream_gather.window_step_plain(
                cum, int(b), window, step, n_slots)
            s0 = int(b) * step
            assert ok_b, (name, b)
            assert torch.equal(rank[s0:s0 + step], want_rank), (name, b)
            assert torch.equal(out[:, s0:s0 + step],
                               torch.tensor(attrs)[:, owner]), (name, b)
        out, rank, total, ok = stream_gather.expand_attrs_windowed(
            attrs_d, counts_d, out_len, window, step, dma=True)
        out, rank = out.cpu(), rank.cpu()
        assert bool(ok), name
        plans = stream_gather.window_block_plain(cum, 0, steps, window, step,
                                                 n_slots)
        for b, (lo, hi, ok_b, owner, want_rank) in enumerate(plans):
            s0 = b * step
            assert ok_b, (name, b)
            assert torch.equal(rank[s0:s0 + step], want_rank), (name, b)
            assert torch.equal(out[:, s0:s0 + step],
                               torch.tensor(attrs)[:, owner]), (name, b)


def gather_cases():
    """(what, attrs [A, S] numpy, src_lo numpy, word offset of attrs):
    float32 and int32 rows; A = 1, 3, 12 and 16 with S = 4k + 1 and attrs
    4 bytes off a 16-byte boundary; int64 offsets past 2^31 and far below
    0; and 40,000 runs, more than one sweep of the persistent grid."""
    rng = np.random.default_rng(1)
    for dtype, s in ((np.float32, 700), (np.int32, 129)):
        yield (dtype.__name__, (rng.random((8, s)) * 1000).astype(dtype),
               np.r_[np.sort(rng.integers(0, s - 1, 4)), s - 40, s + 500,
                     -3].astype(np.int32), 0)
    for a in (1, 3, 12, 16):
        s = 4 * 333 + 1
        yield (f"A={a} off 16 bytes", rng.standard_normal((a, s)).astype(
            np.float32), rng.integers(-200, s + 200, 37).astype(np.int32), 1)
    s = 5000
    yield ("int64 offsets", rng.standard_normal((3, s)).astype(np.float32),
           np.r_[rng.integers(0, s, 9), 2 ** 31, 2 ** 40 + 3, -2 ** 31 - 5,
                 -2 ** 40, s - 1].astype(np.int64), 0)
    s = 5_000_000
    yield ("40,000 runs", rng.integers(-2 ** 31, 2 ** 31 - 1, (1, s)).astype(
        np.int32), np.sort(rng.integers(0, s, 40_000)).astype(np.int32), 0)


@pytest.mark.cuda
def test_gather_blocks_kernel_matches_plain(cuda_device):
    """Every case equal to the plain version, one launch per call, and the
    launch is the only CUDA kernel of the call (torch.profiler)."""
    for what, attrs, src_lo, offset in gather_cases():
        attrs = device_rows(attrs, cuda_device, offset)
        src_lo = torch.from_numpy(src_lo).to(cuda_device)
        before = stream_gather.LAUNCHES["gather_blocks_kernel"]
        got = stream_gather.gather_blocks(attrs, src_lo)
        torch.cuda.synchronize()
        assert stream_gather.LAUNCHES["gather_blocks_kernel"] == before + 1
        assert torch.equal(got, stream_gather.gather_blocks_plain(
            attrs, src_lo)), what
        # three calls under the profiler: three kernels, all the gather
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                stream_gather.gather_blocks(attrs, src_lo)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 3 and all(
            "gather_blocks_kernel" in k for k in kernels), (what, kernels)


@pytest.mark.cuda
def test_stream_routes_give_identical_tables(cuda_device):
    """One view's table with the streaming kernels on (every route) and
    off, and the render's default route."""
    img_h, img_w = 120, 200
    mean, inv, color, op, z, ndc = screen_scene(5000, 7, img_h, img_w,
                                                (0.5, 20.0), cuda_device)
    valid = torch.ones(5000, dtype=torch.bool, device=cuda_device)
    valid[::7] = False
    args = (ndc, z, inv, op, valid, img_h, img_w, 8, 16)
    off = binning.build_tile_table(*args, stream=False)
    assert off.num_entries > 10000
    for route in (None, True, "async", "prefix"):
        stream_gather.reset_counts()
        on = binning.build_tile_table(*args, stream=route)
        launched = {k for k, v in stream_gather.LAUNCHES.items() if v}
        assert launched == {
            None: {"expand_window_kernel"}, True: {"expand_window_kernel"},
            "async": {"expand_window_async_kernel"},
            "prefix": {"expand_prefix_kernel", "expand_window_kernel"},
        }[route]
        assert sum(stream_gather.LAUNCHES.values()) == 2
        assert stream_gather.PLAIN_CALLS == 0
        for field in off._fields:
            a, b = getattr(off, field), getattr(on, field)
            assert torch.equal(a, b) if torch.is_tensor(a) else a == b, \
                (route, field)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5000, 0])
def test_view_without_rows_gives_empty_table_on_every_route(cuda_device, n):
    """Points survive culling but none emits a tile row: the default route
    on the card, and every other, returns the empty table."""
    img_h, img_w = 120, 200
    mean, inv, color, op, z, ndc = screen_scene(5000, 7, img_h, img_w,
                                                (0.5, 20.0), cuda_device)
    args = (ndc[:, :n], z[:n], inv[:, :n], op[:n],
            torch.zeros(n, dtype=torch.bool, device=cuda_device),
            img_h, img_w, 8, 16)
    off = binning.build_tile_table(*args, stream=False)
    assert off.num_entries == 0 and off.num_rows == 0
    for route in (None, True, "async", "prefix"):
        stream_gather.reset_counts()
        on = binning.build_tile_table(*args, stream=route)
        assert stream_gather.PLAIN_CALLS == 0
        assert not any(stream_gather.LAUNCHES.values())
        for field in off._fields:
            a, b = getattr(off, field), getattr(on, field)
            assert torch.equal(a, b) if torch.is_tensor(a) else a == b, \
                (route, field)


@pytest.mark.cuda
def test_learnable_pose_step_matches_torch_backend(cuda_device):
    """One learnable-pose step with the kernels against the same step with
    the plain backend: the extr gradient and the parameters within the
    scaled 3e-4 bar."""
    from litegs_torch.ops import pose
    dev = cuda_device
    h, w = 96, 128
    data, _, _ = synthetic_train.make_task(
        n_points=2000, n_frames=2, img_h=h, img_w=w, sh_degree=1, seed=3,
        device=dev)
    gt, _, _ = synthetic_train.make_gt_params(2000, 1, seed=3, device=dev)
    gt = pad_params(gt, config.round_up(2000, 128))
    extr = np.stack([f.extr_params() for f in synthetic.make_cameras(
        2, h, w, seed=3)[1]])
    extr[:, 4:] += np.random.default_rng(0).normal(0, 0.01, (2, 3))
    op = config.OptimizationParams(learnable_viewproj=True)
    out = {}
    for backend in ("cuda", "torch"):
        params = gt.mapped(torch.clone)
        with torch.no_grad():
            origin, extend = masked_chunk_aabb(params, params.capacity, 128)
        step = make_train_step(
            config.ModelParams(sh_degree=1), op,
            config.PipelineParams(raster_backend=backend),
            config.CapacityParams(params.capacity), h, w, 1.0, 1, False,
            learnable_pose=True)
        raster_cuda.LAUNCHES = raster_cuda.LAUNCHES_BWD = 0
        state, _, new_pose, m = step(
            TrainState(params, optimizer.init_adam(params), params.capacity,
                       0), statistics.init_stats(params.capacity, dev),
            origin, extend, None, data.proj[1], None, None, data.images[1],
            pose.init_pose_state(extr, dev), 1)
        assert raster_cuda.LAUNCHES_BWD == (backend == "cuda")
        out[backend] = (m["extr_grad"], state.params.xyz.detach(),
                        new_pose.extr)
    for a, b in zip(out["cuda"], out["torch"]):
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= 3e-4 * scale
    assert not torch.equal(out["cuda"][2][1], torch.tensor(
        extr[1], device=dev))


def _write_colmap_text(root, cam, frames, xyz, rgb, images):
    import os
    import PIL.Image
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write(f"{cam.id} PINHOLE {cam.width} {cam.height} {cam.focal_x} "
                f"{cam.focal_y} {cam.width / 2} {cam.height / 2}\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        for fr in frames:
            q, t = fr.qvec, fr.tvec
            f.write(f"{fr.id} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} "
                    f"{t[2]} {cam.id} {fr.name}\n\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        for i in range(xyz.shape[0]):
            r, g, b = (rgb[i] * 255).astype(int)
            f.write(f"{i} {xyz[i, 0]} {xyz[i, 1]} {xyz[i, 2]} {r} {g} {b} "
                    "0.5 0 0\n")
    os.makedirs(os.path.join(root, "images"))
    for fr, img in zip(frames, images):
        arr = (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        PIL.Image.fromarray(arr.transpose(1, 2, 0)).save(
            os.path.join(root, "images", fr.name))


@pytest.mark.cuda
def test_cli_train_metrics_resume_on_card(cuda_device, tmp_path):
    """The command line on a small COLMAP scene with the kernels: train,
    score the finish ply, resume from a checkpoint."""
    import os
    from litegs_torch import example_metrics, example_train
    dev = cuda_device
    data, xyz, rgb = synthetic_train.make_task(
        n_points=400, n_frames=9, img_h=48, img_w=64, sh_degree=1, seed=5,
        device=dev)
    cam, frames = synthetic.make_cameras(9, 48, 64, seed=5)
    for fr in frames:
        fr.name += ".png"
    scene = str(tmp_path / "scene")
    _write_colmap_text(scene, cam, frames, xyz.astype(np.float64), rgb,
                       data.images)
    model = str(tmp_path / "model")
    common = ["-s", scene, "--eval", "--iterations", "48", "--sh_degree",
              "1", "--target_primitives", "1024", "--densify_from", "1",
              "--densify_until", "4"]
    raster_cuda.LAUNCHES = raster_cuda.LAUNCHES_BWD = 0
    raster_plain.CALLS = raster_plain.BACKWARD_CALLS = 0
    trainer, state, hist = example_train.main(
        common + ["-m", model, "--test_epochs", "5",
                  "--checkpoint_epochs", "2"], device=dev)
    steps = trainer.total_epochs * trainer.n_frames     # 6 epochs of 7
    assert state.params.xyz.is_cuda and len(hist) == 6
    assert raster_cuda.LAUNCHES == steps + 2     # the 2 test views
    assert raster_cuda.LAUNCHES_BWD == steps
    assert raster_plain.CALLS + raster_plain.BACKWARD_CALLS == 0
    assert hist[-1]["psnr"] > hist[0]["psnr"] + 3.0
    res = example_metrics.main(["-s", scene, "-m", model, "--skip_train"],
                               device=dev)
    assert abs(res["test"]["psnr"] - hist[-1]["test_psnr"]) <= 0.01
    _, _, hist2 = example_train.main(
        common + ["-m", model + "_resumed", "--start_checkpoint",
                  os.path.join(model, "checkpoints", "chkpnt2.npz")],
        device=dev)
    assert [h["epoch"] for h in hist2] == [3, 4, 5]


@pytest.mark.cuda
def test_cli_batch_views_on_card(cuda_device, tmp_path):
    """The command line with --batch_views 2: 7 train frames are three
    two-view groups and one single step per epoch, each group one forward
    and one backward launch over its merged grid."""
    from litegs_torch import example_metrics, example_train
    dev = cuda_device
    data, xyz, rgb = synthetic_train.make_task(
        n_points=400, n_frames=9, img_h=48, img_w=64, sh_degree=1, seed=5,
        device=dev)
    cam, frames = synthetic.make_cameras(9, 48, 64, seed=5)
    for fr in frames:
        fr.name += ".png"
    scene = str(tmp_path / "scene")
    _write_colmap_text(scene, cam, frames, xyz.astype(np.float64), rgb,
                       data.images)
    model = str(tmp_path / "model")
    raster_cuda.LAUNCHES = raster_cuda.LAUNCHES_BWD = 0
    raster_plain.CALLS = raster_plain.BACKWARD_CALLS = 0
    trainer, state, hist = example_train.main(
        ["-s", scene, "-m", model, "--eval", "--iterations", "48",
         "--sh_degree", "1", "--target_primitives", "1024",
         "--densify_from", "1", "--densify_until", "4", "--test_epochs", "5",
         "--batch_views", "2"], device=dev)
    assert trainer.batch_views == 2 and len(hist) == 6
    steps = 6 * (3 + 1)
    assert state.step == steps
    assert raster_cuda.LAUNCHES == steps + 2     # the 2 test views
    assert raster_cuda.LAUNCHES_BWD == steps
    assert raster_plain.CALLS + raster_plain.BACKWARD_CALLS == 0
    assert hist[-1]["psnr"] > hist[0]["psnr"] + 3.0
    res = example_metrics.main(["-s", scene, "-m", model, "--skip_train"],
                               device=dev)
    assert abs(res["test"]["psnr"] - hist[-1]["test_psnr"]) <= 0.01


def _random_lpips_weights(seed=7):
    """Random LPIPS-vgg weights in ``ops.lpips.load_weights``' layout."""
    rng = np.random.default_rng(seed)
    widths = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    convs, cin = [], 3
    for cout in widths:
        w = rng.standard_normal((cout, cin, 3, 3)) * (2.0 / (cin * 9)) ** 0.5
        convs.append((w.astype(np.float32),
                      (0.1 * rng.standard_normal(cout)).astype(np.float32)))
        cin = cout
    lins = [np.abs(rng.standard_normal(widths[t])).astype(np.float32)
            for t in (1, 3, 6, 9, 12)]
    return {"convs": convs, "lins": lins}


@pytest.mark.cuda
def test_lpips_on_card_matches_cpu(cuda_device):
    """The network on the card (cuDNN) against the same module on the CPU
    in float64, at rel 1e-4, with TF32 switched on globally: the module
    turns it off around its convolutions."""
    from litegs_torch.ops import lpips
    weights = _random_lpips_weights()
    rng = np.random.default_rng(3)
    img = torch.tensor(rng.random((3, 67, 95)), dtype=torch.float32)
    gt = (img + 0.1 * torch.tensor(rng.standard_normal(img.shape),
                                   dtype=torch.float32)).clamp(0, 1)
    want = float(lpips.LPIPSVGG(weights, device="cpu").double()(img, gt))
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        net = lpips.LPIPSVGG(weights, device=cuda_device)
        got = float(net(img.to(cuda_device), gt.to(cuda_device)))
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert want > 0 and abs(got - want) <= 1e-4 * want, (got, want)


@pytest.mark.cuda
def test_nccl_world1_step_matches_train_step(cuda_device, tmp_path):
    """The data-parallel step on a real NCCL group of one rank: w = 1 and
    wsum = 1, so each of 3 updates equals make_train_step's from the same
    state (the backward kernel's atomics may reorder sums: parameters at
    1e-5 of each field's largest value), through real collectives."""
    import torch.distributed as dist
    from litegs_torch import parallel
    assert parallel.initialize_distributed(
        f"file://{tmp_path}/store", 1, 0, device=cuda_device) == 1
    try:
        assert dist.get_backend() == "nccl"
        data, xyz, rgb = synthetic_train.make_task(
            n_points=500, n_frames=3, img_h=48, img_w=64, sh_degree=1,
            seed=3, device=cuda_device)
        params = pad_params(create_gaussians(xyz, rgb, 1,
                                             device=cuda_device), 1024)
        adam = optimizer.init_adam(params)
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        for d, (lo, hi) in zip(adam, ((-1e-4, 1e-4), (1e-8, 1e-6))):
            for v in d.values():     # non-zero moments: see test_torch_train
                v.uniform_(lo, hi, generator=gen)
        state = TrainState(params, adam, 512, 0)
        lp = config.ModelParams(sh_degree=1)
        op = config.OptimizationParams(iterations=96,
                                       position_lr_max_steps=96)
        pp = config.PipelineParams(grad_allreduce_dtype="f32")
        single = make_train_step(lp, op, pp, config.CapacityParams(1024),
                                 48, 64, 4.4, 1, True)
        par = parallel.make_parallel_train_step(
            lp, op, pp, config.CapacityParams(1024), 48, 64, 4.4, 1, True)
        stats = statistics.init_stats(1024, cuda_device)
        parallel.COLLECTIVE_CALLS.clear()
        for i in range(3):
            copy = TrainState(state.params.mapped(torch.clone),
                              optimizer.AdamState(*[
                                  {k: v.clone() for k, v in d.items()}
                                  for d in state.adam]),
                              state.active_count, state.step)
            with torch.no_grad():
                origin, extend = masked_chunk_aabb(state.params, 512, 128)
            view = [x[i] for x in data]
            want, _, wm = single(copy, stats, origin, extend, *view)
            state, stats, m = par(state, stats, origin, extend, *view, 1.0)
            assert m["sizes"].shape == (1, 3)
            assert abs(m["loss"].item() - wm["loss"].item()) <= 1e-6
            for k, v in state.params.fields().items():
                ref = getattr(want.params, k)
                assert (v - ref).abs().max() <= 1e-5 * ref.abs().max(), k
        assert parallel.COLLECTIVE_CALLS["all_reduce"] == 3 * 4
        assert parallel.COLLECTIVE_CALLS["all_gather"] == 3
    finally:
        dist.destroy_process_group()
