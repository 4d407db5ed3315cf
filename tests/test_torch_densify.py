"""litegs_torch's statistics and densification against litegs_tpu's, and
the port's Trainer end to end, on CPU.

Given equal statistics and the random draws JAX makes
(``jax.random.uniform(key, (n,), minval=1e-10, maxval=1.0)`` for the
taming selection, ``jax.random.normal(fold_in(key, 1), (3, n))`` for the
split offsets), selection and ``active_count`` must be identical and
parameters within 1e-6 (float32 arithmetic in another order).  The one
deliberate difference: after an append, JAX's ``prune`` partitions the
appended primitives with the inactive tail, so pruned primitives stay
live and the last appended ones drop out of the live range; the port
keeps the appended primitives live and removes the pruned ones, as the
reference does (ROADMAP Queue 3).  The Trainer is held to the bars of
tests/test_training.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litegs_tpu import config as jcfg
from litegs_tpu.ops.raster import RasterStats as JRasterStats
from litegs_tpu.scene import gaussians as jgauss
from litegs_tpu.training import densify as jdens
from litegs_tpu.training import optimizer as jopt
from litegs_tpu.training import statistics as jstat

from litegs_torch import config as tcfg
from litegs_torch.data import synthetic_train as tst
from litegs_torch.ops.raster import RasterStats as TRasterStats
from litegs_torch.scene import gaussians as tgauss
from litegs_torch.training import densify as tdens
from litegs_torch.training import optimizer as topt
from litegs_torch.training import statistics as tstat
from litegs_torch.training.trainer import Trainer

CPU = "cpu"
CAP, ACTIVE, CHUNK = 1024, 512, 128


def T(x):
    return torch.tensor(np.asarray(x))


def scene(seed=0):
    """A padded model with random moments and statistics, as numpy."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(ACTIVE, 3)).astype(np.float32)
    params = jgauss.pad_params(jgauss.create_gaussians(
        xyz, rng.random((ACTIVE, 3)).astype(np.float32), 1), CAP)
    p = {k: np.asarray(v).copy() for k, v in params._asdict().items()}
    p["opacity"][:, :ACTIVE] = rng.uniform(-3, 3, (1, ACTIVE))
    p["scale"][:, :ACTIVE] += rng.uniform(-0.5, 0.8, (3, ACTIVE))
    p["rot"][:, :ACTIVE] = rng.normal(size=(4, ACTIVE))
    m = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    v = {k: rng.random(v.shape).astype(np.float32) for k, v in p.items()}
    live = np.arange(CAP) < ACTIVE
    weight = rng.random(CAP) * (rng.random(CAP) > 0.35) * live
    stats = {
        "visible_count": (rng.integers(1, 4, CAP) * (rng.random(CAP) > 0.35)
                          * live).astype(np.int32),
        "weight_sum": weight, "weight_sq_sum": weight ** 2,
        "err_sum": rng.normal(size=CAP) * live,
        "err_sq_sum": rng.random(CAP) * 3 * live,
        "frag_count": rng.integers(0, 20, CAP) * live,
        "grad_norm_sum": rng.random(CAP) * 1e-3 * live}
    stats = {k: s.astype(np.int32 if k == "visible_count" else np.float32)
             for k, s in stats.items()}
    return p, m, v, stats


def to_jax(p, m, v, stats):
    gp = lambda d: jgauss.GaussianParams(**{k: jnp.asarray(x)
                                            for k, x in d.items()})
    return (gp(p), jopt.AdamState(gp(m), gp(v)),
            jstat.StatsState(**{k: jnp.asarray(x) for k, x in stats.items()}))


def to_port(p, m, v, stats):
    return (tgauss.params_from_numpy(p, device=CPU),
            topt.AdamState({k: T(x) for k, x in m.items()},
                           {k: T(x) for k, x in v.items()}),
            tstat.StatsState(**{k: T(x) for k, x in stats.items()}))


def assert_same(jparams, jadam, tparams, tadam, atol=1e-6):
    got = tgauss.params_to_numpy(tparams)
    for k in got:
        for a, b in ((getattr(jparams, k), got[k]),
                     (getattr(jadam.exp_avg, k), tadam.exp_avg[k]),
                     (getattr(jadam.exp_avg_sq, k), tadam.exp_avg_sq[k])):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       rtol=0.0, atol=atol, err_msg=k)


def jax_draws(key, n):
    return (np.asarray(jax.random.uniform(key, (n,), minval=1e-10,
                                          maxval=1.0)),
            np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                         (3, n))))


def test_update_stats_matches_jax():
    rng = np.random.default_rng(3)
    n = 8 * CHUNK
    ids = np.array([5, 0, 2, 7], np.int32)       # slot 3 (id 7) is tail junk
    mv = len(ids) * CHUNK
    valid = (np.arange(mv) // CHUNK) < 3
    pv = rng.random(mv) > 0.5
    vals = {f: rng.standard_normal(mv).astype(np.float32)
            for f in JRasterStats._fields}
    base = [(np.arange(n) % 7).astype(np.int32 if f == "visible_count"
                                      else np.float32)
            for f in jstat.StatsState._fields]
    want = jstat.update_stats(
        jstat.StatsState(*[jnp.asarray(b) for b in base]), jnp.asarray(ids),
        jnp.asarray(valid), jnp.asarray(pv),
        JRasterStats(**{k: jnp.asarray(x) for k, x in vals.items()}), CHUNK)
    got = tstat.update_stats(
        tstat.StatsState(*[T(b) for b in base]), T(ids), T(valid), T(pv),
        TRasterStats(**{k: T(x) for k, x in vals.items()}), CHUNK)
    for f in tstat.StatsState._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_allclose(b, a, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(tstat.err_variance(got).numpy(),
                               np.asarray(jstat.err_variance(want)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tstat.mean_grad_norm(got).numpy(),
                               np.asarray(jstat.mean_grad_norm(want)),
                               rtol=1e-6)
    perm = rng.permutation(n)
    for a, b in zip(jstat.permute(want, jnp.asarray(perm)),
                    tstat.permute(got, T(perm))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


@pytest.mark.parametrize("mode", ["taming", "official"])
def test_split_and_clone_matches_jax(mode):
    p, m, v, stats = scene(1)
    dp = jcfg.DensifyParams(densify_mode=mode, target_primitives=900,
                            densify_from=0, densify_until=4,
                            densification_interval=1,
                            densify_grad_threshold=2e-4)
    key = jax.random.PRNGKey(7)
    uniform, normal = jax_draws(key, CAP)
    jp, ja, _ = to_jax(p, m, v, stats)
    jstats = to_jax(p, m, v, stats)[2]
    jp2, ja2, jact = jdens.split_and_clone(
        jp, ja, jstats, jnp.int32(ACTIVE), 2, key, dp, 4, ACTIVE, 40.0, CHUNK)
    tp, ta, tstats = to_port(p, m, v, stats)
    tdp = tcfg.DensifyParams(**dp.__dict__)
    tp2, ta2, tact = tdens.split_and_clone(
        tp, ta, tstats, ACTIVE, 2, tdp, 4, ACTIVE, 40.0, CHUNK,
        uniform=T(uniform), normal=T(normal))
    assert tact == int(jact) > ACTIVE
    assert (tact - ACTIVE) % CHUNK == 0
    assert_same(jp2, ja2, tp2, ta2)
    # both kinds of append happened: shifted splits and exact clones
    new_xyz = tp2.xyz.detach().numpy()[:, ACTIVE:tact]
    src_match = (new_xyz[:, :, None] == p["xyz"][:, None, :ACTIVE]).all(0)
    n_clone = int(src_match.any(1).sum())
    assert 0 < n_clone < tact - ACTIVE


def test_prune_reset_and_refine_match_jax():
    p, m, v, stats = scene(2)
    for mode in ("weight", "threshold"):
        dp = jcfg.DensifyParams(prune_mode=mode)
        jp, ja, js = to_jax(p, m, v, stats)
        tp, ta, ts = to_port(p, m, v, stats)
        jp2, ja2, jact = jdens.prune(jp, ja, js, jnp.int32(ACTIVE), dp,
                                     CHUNK)
        tp2, ta2, tact = tdens.prune(tp, ta, ts, ACTIVE,
                                     tcfg.DensifyParams(**dp.__dict__),
                                     CHUNK)
        assert tact == int(jact) < ACTIVE
        assert_same(jp2, ja2, tp2, ta2, atol=0.0)
    for mode in ("decay", "reset"):
        dp = jcfg.DensifyParams(opacity_reset_mode=mode)
        jp, ja, _ = to_jax(p, m, v, stats)
        tp, ta, _ = to_port(p, m, v, stats)
        jp2, ja2 = jdens.reset_opacity(jp, ja, dp)
        tp2, ta2 = tdens.reset_opacity(tp, ta,
                                       tcfg.DensifyParams(**dp.__dict__))
        assert_same(jp2, ja2, tp2, ta2)
    # the resort boxes the live primitives in the port (LiteGS's box) and
    # every slot, parked ones included, in the JAX package: JAX is given
    # the live prefix alone, whose box is the live box, and the parked
    # tail keeps its order at the end
    def head(d):
        return {k: x[..., :ACTIVE] for k, x in d.items()}

    jp, ja, _ = to_jax(head(p), head(m), head(v), stats)
    tp, ta, _ = to_port(p, m, v, stats)
    jp2, ja2 = jdens.spatial_refine(jp, ja, jnp.int32(ACTIVE))
    tp2, ta2 = tdens.spatial_refine(tp, ta, ACTIVE)
    assert_same(jp2, ja2, tp2.mapped(lambda x: x[..., :ACTIVE]),
                topt.AdamState(*[head(d) for d in ta2]), atol=0.0)
    got = tgauss.params_to_numpy(tp2)
    for k in got:
        for a, b in ((p[k], got[k]), (m[k], ta2.exp_avg[k]),
                     (v[k], ta2.exp_avg_sq[k])):
            np.testing.assert_array_equal(np.asarray(b)[..., ACTIVE:],
                                          a[..., ACTIVE:], err_msg=k)
    assert not np.array_equal(got["xyz"][:, :ACTIVE], p["xyz"][:, :ACTIVE])


def test_resort_boxes_the_live_primitives_as_the_benchmark_reference():
    """A shuffled live set and a tail parked at 1e8: the port's
    ``spatial_refine`` gives the order of the benchmark's plain reference
    (``gsbench/reference/densify.py::resort``, LiteGS's box over the live
    points), every parameter and moment moved with it, and is not the
    identity."""
    from gsbench.reference import densify as ref
    p, m, v, stats = scene(6)
    shuffle = np.random.default_rng(6).permutation(ACTIVE)
    for d in (p, m, v):
        for k in d:
            d[k][..., :ACTIVE] = d[k][..., shuffle]
    assert (p["xyz"][:, ACTIVE:] == 1e8).all()
    tp, ta, _ = to_port(p, m, v, stats)
    tp2, ta2 = tdens.spatial_refine(tp, ta, ACTIVE)
    leaves = {k: T(x) for k, x in p.items()}
    for name, d in zip(ref.MOMENTS, (m, v)):
        leaves.update({f"{name}.{k}": T(x) for k, x in d.items()})
    want = ref.resort(leaves, ACTIVE, box="live")
    got = tgauss.params_to_numpy(tp2)
    for name, d in zip(ref.MOMENTS, ta2):
        got.update({f"{name}.{k}": x.numpy() for k, x in d.items()})
    assert set(got) == set(want)
    for k, x in got.items():
        np.testing.assert_array_equal(x, want[k].numpy(), err_msg=k)
    assert not np.array_equal(got["xyz"], p["xyz"])


def test_event_and_resort_match_the_benchmark_reference():
    """A densify event and its resort, from the same statistics and
    generator: the port's order and every value equal the benchmark's
    plain reference (``gsbench/reference/densify.py::event``) bit for bit,
    but the split copies' scale (log(s) - log(1.6) against
    log(s / 1.6)).  A last-bit difference in a split copy's position
    would move it in the resort."""
    from gsbench.reference import densify as ref
    p, m, v, stats = scene(7)
    dp = tcfg.DensifyParams(densify_from=0, densify_until=8,
                            densification_interval=2,
                            opacity_reset_interval=100,
                            target_primitives=900)
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    tp, ta, ts = to_port(p, m, v, stats)
    tp, ta, act, did = tdens.densify_step(tp, ta, ts, ACTIVE, 2, dp, 8, 256,
                                          40.0, CHUNK, generator=gen)
    tp, ta = tdens.spatial_refine(tp, ta, act)
    leaves = {k: T(x) for k, x in p.items()}
    for name, d in zip(ref.MOMENTS, (m, v)):
        leaves.update({f"{name}.{k}": T(x) for k, x in d.items()})
    want = ref.event(leaves, {k: T(x).float() for k, x in stats.items()},
                     ACTIVE, 2, {k: getattr(dp, k)
                                 for k in dp.__dataclass_fields__},
                     8, 256, 40.0, CHUNK, state)
    assert did and act == want["active"] and want["appended"] > 0
    assert want["pruned"] > 0
    got = tgauss.params_to_numpy(tp)
    for name, d in zip(ref.MOMENTS, ta):
        got.update({f"{name}.{k}": x.numpy() for k, x in d.items()})
    for k, x in got.items():
        w = want["leaves"][k].numpy()
        if k == "scale":
            np.testing.assert_allclose(x, w, rtol=0.0, atol=1e-6)
        else:
            np.testing.assert_array_equal(x, w, err_msg=k)


def test_densify_step_keeps_appended_and_removes_pruned():
    p, m, v, stats = scene(4)
    dp = jcfg.DensifyParams(target_primitives=900, densify_from=0,
                            densify_until=4, densification_interval=1,
                            opacity_reset_interval=100)
    key = jax.random.PRNGKey(3)
    uniform, normal = jax_draws(key, CAP)
    jp, ja, js = to_jax(p, m, v, stats)
    jp1, ja1, jact1 = jdens.split_and_clone(
        jp, ja, js, jnp.int32(ACTIVE), 2, key, dp, 4, ACTIVE, 4.0, CHUNK)
    jp2, _, jact2 = jdens.prune(jp1, ja1, js, jact1, dp, CHUNK,
                                stats_valid_count=jnp.int32(ACTIVE))
    tp, ta, ts = to_port(p, m, v, stats)
    g = torch.Generator()
    tp2, ta2, tact, did = tdens.densify_step(
        tp, ta, ts, ACTIVE, 2, tcfg.DensifyParams(**dp.__dict__), 4, ACTIVE,
        4.0, CHUNK, generator=g)
    assert did and tact == int(jact2) and tact % CHUNK == 0
    # the same step with the JAX draws: the live set is JAX's split output
    # without the primitives JAX's prune mask removes
    tp1, ta1, tact1 = tdens.split_and_clone(
        *to_port(p, m, v, stats), ACTIVE, 2,
        tcfg.DensifyParams(**dp.__dict__), 4, ACTIVE, 4.0, CHUNK,
        uniform=T(uniform), normal=T(normal))
    assert tact1 == int(jact1)
    tp3, _, tact3 = tdens.prune(tp1, ta1, ts, tact1,
                                tcfg.DensifyParams(**dp.__dict__), CHUNK,
                                stats_valid_count=ACTIVE)
    assert tact3 == int(jact2)
    pruned = np.asarray(stats["weight_sum"] == 0.0)[:ACTIVE]
    n_del = (int(pruned.sum()) // CHUNK) * CHUNK
    assert n_del > 0
    removed = np.flatnonzero(pruned)[:n_del]
    live = np.setdiff1d(np.arange(int(jact1)), removed)
    assert len(live) == tact3
    np.testing.assert_allclose(tp3.xyz.detach().numpy()[:, :tact3],
                               np.asarray(jp1.xyz)[:, live], atol=1e-6)


def test_prune_abort_and_unported_options():
    p, m, v, stats = scene(5)
    stats["weight_sum"][:] = 0.0
    tp, ta, ts = to_port(p, m, v, stats)
    with pytest.raises(RuntimeError, match=">80%"):
        tdens.prune(tp, ta, ts, ACTIVE, tcfg.DensifyParams(), CHUNK)
    data = tst.make_task(n_points=64, n_frames=1, img_h=16, img_w=16,
                         sh_degree=0, device=CPU)[0]
    kw = dict(lp=tcfg.ModelParams(), dp=tcfg.DensifyParams(),
              caps=tcfg.CapacityParams(256), data=data, spatial_lr_scale=1.0)
    # pose refinement is ported: it needs the frames' extrinsics
    pose_op = tcfg.OptimizationParams(learnable_viewproj=True)
    with pytest.raises(ValueError, match="requires extr_init"):
        Trainer(op=pose_op, pp=tcfg.PipelineParams(), **kw)
    trainer = Trainer(op=pose_op, pp=tcfg.PipelineParams(),
                      extr_init=np.zeros((1, 7), np.float32), **kw)
    assert tuple(trainer.pose_state.extr.shape) == (1, 7)
    # batched views are ported: two views per step on the 'cuda' backend;
    # with pose refinement the trainer takes one, as JAX's does
    assert Trainer(op=tcfg.OptimizationParams(),
                   pp=tcfg.PipelineParams(batch_views=2),
                   **kw).batch_views == 2
    assert Trainer(op=pose_op, pp=tcfg.PipelineParams(batch_views=2),
                   extr_init=np.zeros((1, 7), np.float32),
                   **kw).batch_views == 1


def test_trainer_improves_psnr_and_grows_by_chunks():
    """The small task of tests/test_training.py through the port's
    Trainer: the bars of test_training_improves_psnr and
    test_densify_grows_at_chunk_granularity."""
    data, init_xyz, init_color = tst.make_task(
        n_points=500, n_frames=8, img_h=48, img_w=64, sh_degree=1, seed=3,
        device=CPU)
    trainer = Trainer(
        lp=tcfg.ModelParams(sh_degree=1),
        op=tcfg.OptimizationParams(iterations=96, position_lr_max_steps=96),
        pp=tcfg.PipelineParams(),
        dp=tcfg.DensifyParams(densification_interval=2, densify_from=1,
                              densify_until=6, opacity_reset_interval=100,
                              target_primitives=1024),
        caps=tcfg.CapacityParams(primitive_capacity=2048), data=data,
        spatial_lr_scale=4.4)
    state = trainer.init_state(init_xyz, init_color)
    _, _, m0 = trainer.run_epoch(state, trainer.init_stats(), epoch=0,
                                 frame_ids=[0])
    state, stats, hist = trainer.train(init_xyz, init_color, verbose=False)
    final = hist[-1]["psnr"]
    assert final > m0["psnr"] + 2.0, (m0["psnr"], final)
    assert final > 22.0, final
    actives = [h["active"] for h in hist]
    assert all(a % 128 == 0 for a in actives), actives
    assert actives[-1] > actives[0], actives
    assert actives[-1] <= trainer.caps.primitive_capacity
    order = trainer.complexity_sorted_tiles()
    assert trainer.tile_blend_max[order[0]] == trainer.tile_blend_max.max()
    assert trainer.evaluate(state, data, epoch=11) > 22.0
