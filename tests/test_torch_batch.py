"""litegs_torch's batched views against litegs_tpu's, on CPU.

B = 2 views of a 32x48 image at 8x16 tiles (12 tiles per view) go through
JAX's ``render_batch`` (with its VJP) and one batched statistics step of
``make_batch_train_step`` (``raster_backend="pallas"``, interpret mode, as
tests/test_render_batch.py runs them), once, in a module fixture; the
port takes the same numpy inputs through its ``'cuda'`` backend, whose
kernels take their plain versions on CPU tensors.

* The port's ``render_batch`` equals its B single ``render`` calls
  exactly: images, transmittance, ``primitive_visible`` and ``sizes``.
* Each view's segment of the port's merged table equals JAX's
  ``concat_tables`` segment with the pads stripped: tile ids, point ids
  as offsets from the view's first point, order.
* Images within 1e-4 of JAX's, the ``sh_0`` gradient of the mean-of-views
  loss within 3e-4 scaled (the bars of tests/test_raster_pallas.py).
* One batched statistics step from an equal state: parameters and the
  second moment at tests/test_torch_train.py's bars (1e-5), the first
  moment, which carries the gradient, at the raster-gradient bar (3e-4
  scaled: JAX runs its Pallas backward here, not the jnp one), statistics
  at the raster bars, and the chunks of no view (the union mask leaves
  them out) bit-equal to where they started.
* The Trainer at ``batch_views=2`` on 3 frames: one group and one leftover
  single step per epoch (tests/test_render_batch.py's epoch case).
* The tile-row wrap on a 37x53 image (not whole tiles), and a merged grid
  rasterized without the wrap, which must come out wrong.

The state is the non-degenerate one of tests/test_torch_train.py (random
rotations, anisotropic scales, non-zero moments); its docstring says why.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litegs_tpu import config as jcfg
from litegs_tpu import render as jrender
from litegs_tpu.ops import binning as jbin
from litegs_tpu.ops import losses as jlosses
from litegs_tpu.ops import projection as jproj
from litegs_tpu.scene import gaussians as jgauss
from litegs_tpu.training import optimizer as jopt
from litegs_tpu.training import statistics as jstat
from litegs_tpu.training import trainer as jtr

from litegs_torch import config as tcfg
from litegs_torch import render as trender
from litegs_torch.data import synthetic
from litegs_torch.data import synthetic_train as tst
from litegs_torch.ops import losses as tlosses
from litegs_torch.ops import raster_cuda
from litegs_torch.scene import create_gaussians, pad_params
from litegs_torch.scene import gaussians as tgauss
from litegs_torch.training import optimizer as topt
from litegs_torch.training import statistics as tstat
from litegs_torch.training import trainer as ttr

CPU = "cpu"
H, W, B = 32, 48, 2
CAP, ACTIVE, STEP0 = 1024, 512, 3
TILES = 12                      # 3 x 4 tiles of 8x16 per view


def T(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def scaled_close(got, want, atol, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, atol=atol,
                               err_msg=name)


def jax_state(p0, m0, v0):
    return jtr.TrainState(
        jgauss.GaussianParams(**{k: jnp.asarray(v) for k, v in p0.items()}),
        jopt.AdamState(*[jgauss.GaussianParams(
            **{k: jnp.asarray(v) for k, v in d.items()}) for d in (m0, v0)]),
        jnp.int32(ACTIVE), jnp.int32(STEP0))


def port_state(p0, m0, v0):
    return ttr.TrainState(
        tgauss.params_from_numpy(p0, device=CPU),
        topt.AdamState(*[{k: T(v) for k, v in d.items()} for d in (m0, v0)]),
        ACTIVE, STEP0)


@pytest.fixture(scope="module")
def run():
    """The task of tests/test_torch_train.py at 32x48 and JAX's batched
    render (with the gradient of its mean-of-views loss) and batched
    statistics step on it."""
    kw = dict(n_points=500, n_frames=3, img_h=H, img_w=W, sh_degree=1,
              seed=3)
    tdata, xyz, rgb = tst.make_task(**kw, device=CPU)
    params = jgauss.pad_params(jgauss.pad_to_chunk(
        jgauss.create_gaussians(xyz, rgb, 1), 128), CAP)
    rng = np.random.default_rng(0)
    p0 = {k: np.asarray(v).copy() for k, v in params._asdict().items()}
    live = slice(0, ACTIVE)
    p0["rot"][:, live] = rng.normal(size=(4, ACTIVE))
    p0["scale"][:, live] += rng.uniform(-0.5, 0.8, (3, ACTIVE))
    p0["sh_rest"][:, live] = rng.normal(0.0, 0.05, (9, ACTIVE))
    p0["opacity"][:, live] = rng.uniform(-1.0, 2.0, (1, ACTIVE))
    m0 = {k: rng.normal(0.0, 1e-4, v.shape).astype(np.float32)
          for k, v in p0.items()}
    v0 = {k: rng.uniform(1e-8, 1e-6, v.shape).astype(np.float32)
          for k, v in p0.items()}
    cams = {f: getattr(tdata, f)[:B].numpy() for f in
            ("view", "proj", "planes", "center", "images")}

    caps = jcfg.CapacityParams(CAP, CAP, 4096, 8192)
    pp = jcfg.PipelineParams(raster_backend="pallas",
                             enable_transmitance=True)
    jparams = jax_state(p0, m0, v0).params
    jo, je = jtr.masked_chunk_aabb(jparams, ACTIVE, 128)

    def culled(p):
        return [jrender.render_preprocess(
            p, jo, je, jnp.asarray(cams["planes"][v]),
            jnp.asarray(cams["center"][v]), 1, pp, caps) for v in range(B)]

    views = [jnp.asarray(cams["view"][v]) for v in range(B)]
    projs = [jnp.asarray(cams["proj"][v]) for v in range(B)]

    def loss_fn(sh0):
        out = jrender.render_batch(culled(jparams._replace(sh_0=sh0)), views,
                                   projs, H, W, pp, caps, interpret=True)
        loss = sum(jlosses.fused_l1_ssim_loss(out.imgs[v],
                                              jnp.asarray(cams["images"][v]),
                                              0.2) for v in range(B)) / B
        return loss, out

    (loss, out), g_sh0 = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jparams.sh_0)
    assert not bool(out.overflow)

    # the per-view tables of render_batch, merged as it merges them
    tables = []
    for c, view, proj in zip(culled(jparams), views, projs):
        view_pos, ndc = jproj.mvp_transform(jproj.homogeneous(c.xyz), view,
                                            proj)
        jac = jproj.rayspace_jacobian(view_pos, proj, H, W)
        inv = jproj.inverse_2x2_sym(jproj.cov2d_fused(c.scale, c.rot, jac,
                                                      view))
        tables.append(jbin.build_tile_table(
            ndc, view_pos[2], inv, c.opacity, c.valid, H, W, 8, 16,
            caps.row_capacity, caps.entry_capacity))
    merged = jbin.concat_tables(tables, TILES, caps.visible_capacity)

    jstep = jtr.make_batch_train_step(
        jcfg.ModelParams(sh_degree=1),
        jcfg.OptimizationParams(iterations=96, position_lr_max_steps=96),
        jcfg.PipelineParams(raster_backend="pallas"), caps, H, W, 4.4, 1,
        batch_views=B, collect_stats=True, interpret=True)
    js, jstats, jm = jstep(jax_state(p0, m0, v0), jstat.init_stats(CAP), jo,
                           je, *[jnp.asarray(cams[f]) for f in
                                 ("view", "proj", "planes", "center",
                                  "images")])
    host = jax.device_get
    return dict(
        p0=p0, m0=m0, v0=v0, cams=cams, loss=float(loss),
        imgs=np.asarray(out.imgs), trans=np.asarray(out.transmitance),
        sizes=np.asarray(out.sizes), visible=np.asarray(
            out.primitive_visible), g_sh0=np.asarray(g_sh0),
        table=host(merged), e_len=caps.entry_capacity,
        mv=caps.visible_capacity, step=host((js, jstats, jm)))


def port_views(p0, cams, pp):
    params = tgauss.params_from_numpy(p0, device=CPU)
    with torch.no_grad():
        o, e = ttr.masked_chunk_aabb(params, ACTIVE, 128)
    culled = [trender.render_preprocess(params, o, e, T(cams["planes"][v]),
                                        T(cams["center"][v]), 1, pp)
              for v in range(B)]
    return params, culled, T(cams["view"]), T(cams["proj"])


def test_render_batch_equals_single_renders(run):
    pp = tcfg.PipelineParams(enable_transmitance=True)
    _, culled, views, projs = port_views(run["p0"], run["cams"], pp)
    with torch.no_grad():
        out = trender.render_batch(culled, views, projs, H, W, pp)
        singles = [trender.render(culled[v], views[v], projs[v], H, W, pp)
                   for v in range(B)]
    assert out.imgs.shape == (B, 3, H, W) and out.overflow is False
    for v, s in enumerate(singles):
        assert torch.equal(out.imgs[v], s.img), v
        assert torch.equal(out.transmitance[v], s.transmitance), v
        assert torch.equal(out.primitive_visible[v], s.primitive_visible)
        assert torch.equal(out.sizes[v], s.sizes), v
    assert out.point_offsets == (0, culled[0].xyz.shape[1],
                                 culled[0].xyz.shape[1]
                                 + culled[1].xyz.shape[1])


def test_merged_table_matches_jax_concat_tables(run):
    pp = tcfg.PipelineParams()
    _, culled, views, projs = port_views(run["p0"], run["cams"], pp)
    with torch.no_grad():
        out = trender.render_batch(culled, views, projs, H, W, pp)
    tab, jt = out.aux.table, run["table"]
    off, e_off = out.point_offsets, 0
    assert tab.tile_start.shape[0] == B * TILES
    for v in range(B):
        seg = slice(v * run["e_len"], (v + 1) * run["e_len"])
        valid = np.asarray(jt.entry_valid)[seg]
        jp = np.asarray(jt.sorted_point)[seg][valid] - v * run["mv"]
        jtile = np.asarray(jt.sorted_tile)[seg][valid]
        n = int(out.sizes[v, 2])
        assert n == jp.shape[0] > 0
        np.testing.assert_array_equal(
            tab.sorted_point[e_off:e_off + n].numpy() - off[v], jp)
        np.testing.assert_array_equal(
            tab.sorted_tile[e_off:e_off + n].numpy(), jtile)
        tiles = slice(v * TILES, (v + 1) * TILES)
        np.testing.assert_array_equal(tab.tile_count[tiles].numpy(),
                                      np.asarray(jt.tile_count)[tiles])
        cnt = tab.tile_count[tiles].numpy()
        np.testing.assert_array_equal(tab.tile_start[tiles].numpy() - e_off,
                                      np.cumsum(cnt) - cnt)
        e_off += n
    assert tab.num_entries == e_off and bool(tab.entry_valid.all())


def test_render_batch_and_gradient_match_jax(run):
    pp = tcfg.PipelineParams(enable_transmitance=True)
    params, culled, views, projs = port_views(run["p0"], run["cams"], pp)
    out = trender.render_batch(culled, views, projs, H, W, pp)
    np.testing.assert_allclose(out.imgs.detach().numpy(), run["imgs"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.transmitance.detach().numpy(),
                               run["trans"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out.sizes.numpy(), run["sizes"])
    for v in range(B):
        n = out.primitive_visible[v].shape[0]
        np.testing.assert_array_equal(out.primitive_visible[v].numpy(),
                                      run["visible"][v][:n])
        assert not run["visible"][v][n:].any()
    loss = sum(tlosses.fused_l1_ssim_loss(out.imgs[v],
                                          T(run["cams"]["images"][v]), 0.2)
               for v in range(B)) / B
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), run["loss"], rtol=1e-5)
    assert np.abs(run["g_sh0"]).max() > 0
    scaled_close(params.sh_0.grad.numpy(), run["g_sh0"], 3e-4, "sh_0")


def test_batch_statistics_step_matches_jax(run):
    p0, m0, v0, cams = run["p0"], run["m0"], run["v0"], run["cams"]
    js, jstats, jm = run["step"]
    step = ttr.make_batch_train_step(
        tcfg.ModelParams(sh_degree=1),
        tcfg.OptimizationParams(iterations=96, position_lr_max_steps=96),
        tcfg.PipelineParams(), tcfg.CapacityParams(CAP), H, W, 4.4, 1, B,
        True)
    state = port_state(p0, m0, v0)
    with torch.no_grad():
        o, e = ttr.masked_chunk_aabb(state.params, ACTIVE, 128)
        # the chunks that no view sees: the union mask leaves them out
        seen = torch.zeros(CAP // 128, dtype=torch.bool)
        for v in range(B):
            culled = trender.render_preprocess(
                state.params, o, e, T(cams["planes"][v]),
                T(cams["center"][v]), 1, tcfg.PipelineParams())
            seen[culled.chunk_ids] = True
    unseen = torch.nonzero(~seen).flatten().tolist()
    assert unseen
    ts, tstats, tm = step(state, tstat.init_stats(CAP, CPU), o, e,
                          *[T(cams[f]) for f in ("view", "proj", "planes",
                                                 "center", "images")])
    assert ts.step == int(js.step) == STEP0 + 1
    assert "tile_count" not in tm
    # the images agree within 1e-4 (JAX's Pallas blend against the plain
    # one), so the losses within 1e-5
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["psnr"]), float(jm["psnr"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(tm["sizes"].numpy(),
                                  np.asarray(jm["sizes"]))
    got = tgauss.params_to_numpy(ts.params)
    for k in p0:
        a = np.asarray(getattr(js.params, k))
        assert not np.array_equal(a, p0[k]), k
        np.testing.assert_allclose(got[k], a, rtol=0.0,
                                   atol=1e-5 * np.abs(a).max(), err_msg=k)
        # the first moment carries the gradient: JAX's Pallas backward and
        # the plain one differ by 1-2e-5 of the largest, inside their 3e-4
        scaled_close(ts.adam.exp_avg[k].numpy(),
                     getattr(js.adam.exp_avg, k), 3e-4, f"exp_avg {k}")
        scaled_close(ts.adam.exp_avg_sq[k].numpy(),
                     getattr(js.adam.exp_avg_sq, k), 1e-5, f"exp_avg_sq {k}")
        for c in unseen:
            cols = slice(128 * c, 128 * (c + 1))
            for x, x0 in ((got[k], p0[k]),
                          (ts.adam.exp_avg[k].numpy(), m0[k]),
                          (ts.adam.exp_avg_sq[k].numpy(), v0[k])):
                np.testing.assert_array_equal(x[..., cols], x0[..., cols])
    s_t = {f: getattr(tstats, f).numpy() for f in tstat.StatsState._fields}
    s_j = {f: np.asarray(getattr(jstats, f)) for f in
           jstat.StatsState._fields}
    np.testing.assert_array_equal(s_t["visible_count"], s_j["visible_count"])
    assert s_t["visible_count"].max() == B
    np.testing.assert_allclose(s_t["weight_sum"], s_j["weight_sum"],
                               atol=2e-3)
    np.testing.assert_allclose(s_t["frag_count"], s_j["frag_count"],
                               atol=0.5)
    scaled_close(s_t["weight_sq_sum"], s_j["weight_sq_sum"], 1e-3)
    scaled_close(s_t["err_sum"], s_j["err_sum"], 2e-4)
    scaled_close(s_t["err_sq_sum"], s_j["err_sq_sum"], 1e-3)
    scaled_close(s_t["grad_norm_sum"], s_j["grad_norm_sum"], 2e-3)
    assert s_t["frag_count"].sum() > 0


def test_trainer_batched_epoch():
    """tests/test_render_batch.py's epoch case on the port: 3 frames at
    B = 2 are one group and one leftover single step per epoch."""
    data, xyz, rgb = tst.make_task(n_points=400, n_frames=3, img_h=48,
                                   img_w=64, sh_degree=1, seed=3,
                                   device=CPU)
    trainer = ttr.Trainer(
        lp=tcfg.ModelParams(sh_degree=1),
        op=tcfg.OptimizationParams(iterations=9, position_lr_max_steps=9),
        pp=tcfg.PipelineParams(batch_views=2),
        dp=tcfg.DensifyParams(densification_interval=2, densify_from=1,
                              densify_until=2, opacity_reset_interval=100,
                              target_primitives=768),
        caps=tcfg.CapacityParams(primitive_capacity=1024), data=data,
        spatial_lr_scale=4.4)
    assert trainer.batch_views == 2
    calls = {"batch": 0, "single": 0}
    real_batch, real_single = trainer._get_batch_step, trainer._get_step

    def counted(kind, get):
        def wrapped(*a):
            fn = get(*a)

            def run_step(*args):
                calls[kind] += 1
                return fn(*args)
            return run_step
        return wrapped

    trainer._get_batch_step = counted("batch", real_batch)
    trainer._get_step = counted("single", real_single)
    state, _, hist = trainer.train(xyz, rgb, verbose=False)
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert calls == {"batch": 3, "single": 3}
    assert state.step == 6
    assert any(len(k) == 3 and k[2] == 2 for k in trainer._step_cache)
    # the batched loop keeps no blend-depth telemetry, as JAX's
    assert trainer.tile_blend_max is None


def test_trainer_batch_falls_back_to_one_view(capsys):
    data, _, _ = tst.make_task(n_points=200, n_frames=2, img_h=16, img_w=16,
                               sh_degree=0, seed=1, device=CPU)
    trainer = ttr.Trainer(
        lp=tcfg.ModelParams(sh_degree=0), op=tcfg.OptimizationParams(),
        pp=tcfg.PipelineParams(batch_views=2, raster_backend="torch"),
        dp=tcfg.DensifyParams(), caps=tcfg.CapacityParams(256), data=data,
        spatial_lr_scale=1.0)
    assert trainer.batch_views == 1
    assert "using B=1" in capsys.readouterr().out


def test_tile_row_wraps_on_a_merged_grid_of_partial_tiles():
    """37x53 at 8x16: 5 x 4 tiles per view, the last row and column cut.
    The merged grid wraps each view's tile rows; without the wrap view 1
    lands below its image and comes out as background."""
    img_h, img_w = 37, 53
    cam, frames = synthetic.make_cameras(2, img_h, img_w, seed=0)
    xyz, rgb = synthetic.make_gaussian_cloud(600, seed=1)
    params = pad_params(create_gaussians(xyz, rgb, 2, device=CPU), 640)
    pp = tcfg.PipelineParams(enable_transmitance=True)
    batch = ttr.camera_batch_from_frames(
        cam, frames, np.zeros((2, 3, img_h, img_w), np.float32), device=CPU)
    with torch.no_grad():
        o, e = ttr.masked_chunk_aabb(params, 640, 128)
        culled = [trender.render_preprocess(params, o, e, batch.planes[v],
                                            batch.center[v], 2, pp)
                  for v in range(2)]
        out = trender.render_batch(culled, batch.view, batch.proj, img_h,
                                   img_w, pp)
        for v in range(2):
            single = trender.render(culled[v], batch.view[v], batch.proj[v],
                                    img_h, img_w, pp)
            assert torch.equal(out.imgs[v], single.img), v
            assert torch.equal(out.transmitance[v], single.transmitance)
            assert float(single.img.mean()) > 0.05
        aux = out.aux
        args = (aux.mean_pix, aux.inv_cov, aux.color_chan, aux.opacity,
                aux.table.sorted_point, aux.table.tile_start,
                aux.table.tile_count, 4, 8, 16)
        col, trans = raster_cuda.raster_forward(*args, tiles_y=5)
        assert torch.equal(col, aux.tiles_color)
        assert torch.equal(trans, aux.tiles_trans)
        col0, trans0 = raster_cuda.raster_forward(*args)
        assert torch.equal(col0[:20], col[:20])
        assert float((trans0[20:] < 1).float().mean()) < float(
            (trans[20:] < 1).float().mean())
        # the gradients of view 1 through the merged backward equal its own
        cot = (torch.randn(col.shape, generator=torch.Generator()
                           .manual_seed(0)),
               torch.randn(trans.shape, generator=torch.Generator()
                           .manual_seed(1)))
        merged = raster_cuda.raster_backward(*args, col, trans, *cot,
                                             with_stats=True, tiles_y=5)
        off = out.point_offsets
        tab = aux.table
        lo, hi = int(tab.tile_start[20]), tab.num_entries
        single = raster_cuda.raster_backward(
            aux.mean_pix[:, off[1]:], aux.inv_cov[:, off[1]:],
            aux.color_chan[:, off[1]:], aux.opacity[off[1]:],
            tab.sorted_point[lo:hi] - off[1], tab.tile_start[20:] - lo,
            tab.tile_count[20:], 4, 8, 16, col[20:], trans[20:],
            cot[0][20:], cot[1][20:], with_stats=True)
        for field in single._fields:
            assert torch.equal(getattr(merged, field)[..., off[1]:],
                               getattr(single, field)), field
