"""litegs_torch's pose refinement against litegs_tpu's, on CPU.

* ``camera_from_extr`` (view, planes, centre) within 1e-6 of JAX's, and
  its gradient -- autograd of a weighted sum of all three outputs against
  ``jax.grad`` of the same sum -- within 1e-5 (max |diff| / max |jax|).
* ``sparse_pose_adam`` over three steps touching two rows: extr and both
  moments within 1e-6, untouched rows equal.
* One learnable-pose ``make_train_step`` (the port's ``torch`` backend
  against JAX's ``jnp`` backend, same numpy inputs): parameters and the new
  extr within 1e-5, the extr gradient (``metrics["extr_grad"]``, and the
  first moment 0.1 g) within 1e-5 scaled.
* tests/test_pose.py's refinement case through the port's Trainer at its
  bars: noisy extrinsics move toward the truth (err < 0.93 x noisy err)
  and the train PSNR rises by more than 1 dB.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from litegs_tpu import config as jcfg
from litegs_tpu.ops import pose as jpose
from litegs_tpu.scene import gaussians as jgauss
from litegs_tpu.training import optimizer as jopt
from litegs_tpu.training import statistics as jstat
from litegs_tpu.training import trainer as jtr

from litegs_torch import config as tcfg
from litegs_torch.data import synthetic, synthetic_train
from litegs_torch.ops import pose as tpose
from litegs_torch.scene import gaussians as tgauss
from litegs_torch.scene import pad_params, pad_to_chunk
from litegs_torch.training import optimizer as topt
from litegs_torch.training import statistics as tstat
from litegs_torch.training import trainer as ttr
from test_torch_train import scaled_close, task  # noqa: F401 (fixture)

CPU = "cpu"


def noisy_extr(frames, seed=0):
    """tests/test_pose.py's noise on the frames' true extrinsics."""
    true_extr = np.stack([fr.extr_params() for fr in frames])
    rng = np.random.default_rng(seed)
    noise = np.zeros_like(true_extr)
    noise[:, 4:] = rng.normal(scale=0.01, size=(len(frames), 3))
    noise[:, :4] = rng.normal(scale=0.004, size=(len(frames), 4))
    return true_extr, (true_extr + noise).astype(np.float32)


def test_camera_from_extr_and_grad_match_jax():
    cam, frames = synthetic.make_cameras(3, 48, 64, seed=1)
    proj = cam.proj_matrix()
    _, extrs = noisy_extr(frames, seed=2)
    rng = np.random.default_rng(3)
    w = [rng.standard_normal(s).astype(np.float32)
         for s in ((4, 4), (6, 4), (3,))]

    def jscalar(e):
        outs = jpose.camera_from_extr(e, jnp.asarray(proj))
        return sum(jnp.sum(o * jnp.asarray(wi)) for o, wi in zip(outs, w))

    for extr in extrs:
        outs_j = jpose.camera_from_extr(jnp.asarray(extr), jnp.asarray(proj))
        e = torch.tensor(extr, requires_grad=True)
        outs_t = tpose.camera_from_extr(e, torch.tensor(proj))
        for a, b in zip(outs_t, outs_j):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-6, atol=1e-6)
        sum((o * torch.tensor(wi)).sum() for o, wi in zip(outs_t, w)
            ).backward()
        g_j = np.asarray(jax.grad(jscalar)(jnp.asarray(extr)))
        assert np.abs(g_j).max() > 0
        scaled_close(e.grad.numpy(), g_j, 1e-5)
    # the true extrinsics give the host-side camera
    fr = frames[0]
    view, planes, center = tpose.camera_from_extr(
        torch.tensor(fr.extr_params()), torch.tensor(proj))
    np.testing.assert_allclose(view.numpy(), fr.view_matrix(), atol=1e-6)
    np.testing.assert_allclose(center.numpy(), fr.camera_center(),
                               atol=1e-5)
    np.testing.assert_allclose(planes.numpy(), fr.frustumplane(proj),
                               rtol=1e-4, atol=1e-5)


def test_sparse_pose_adam_matches_jax():
    rng = np.random.default_rng(0)
    extr0 = rng.standard_normal((4, 7)).astype(np.float32)
    jp = jpose.init_pose_state(extr0)
    tp = tpose.init_pose_state(extr0, CPU)
    for row in (1, 3, 1):
        g = rng.standard_normal(7).astype(np.float32)
        jp = jpose.sparse_pose_adam(jp, row, jnp.asarray(g), lr=1e-2)
        tp = tpose.sparse_pose_adam(tp, row, torch.tensor(g), lr=1e-2)
    assert int(tp.step) == int(jp.step) == 3
    for field in ("extr", "m", "v"):
        a, b = getattr(tp, field).numpy(), np.asarray(getattr(jp, field))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                   err_msg=field)
    np.testing.assert_array_equal(tp.extr[[0, 2]].numpy(), extr0[[0, 2]])
    np.testing.assert_array_equal(tp.m[[0, 2]].numpy(), 0.0)


def test_learnable_pose_train_step_matches_jax(task):  # noqa: F811
    jdata, p0, m0, v0 = task
    frames = synthetic.make_cameras(2, 48, 64, seed=3)[1]
    _, extr = noisy_extr(frames, seed=4)
    lp = jcfg.ModelParams(sh_degree=1)
    op = jcfg.OptimizationParams(iterations=96, position_lr_max_steps=96,
                                 learnable_viewproj=True)
    cap, active, step0, frame = 1024, 512, 3, 1
    args = [np.asarray(getattr(jdata, f)[frame]) for f in
            ("view", "proj", "planes", "center", "images")]

    jparams = jgauss.GaussianParams(**{k: jnp.asarray(v)
                                       for k, v in p0.items()})
    jstep = jtr.make_train_step(
        lp, op, jcfg.PipelineParams(raster_backend="jnp"),
        jcfg.CapacityParams(cap, cap, 8192, 32768), 48, 64, 4.4, 1, False,
        learnable_pose=True)
    jo, je = jtr.masked_chunk_aabb(jparams, active, 128)
    js, _, jpose_new, jm = jstep(
        jtr.TrainState(jparams, jopt.AdamState(*[
            jgauss.GaussianParams(**{k: jnp.asarray(v) for k, v in d.items()})
            for d in (m0, v0)]), jnp.int32(active), jnp.int32(step0)),
        jstat.init_stats(cap), jo, je, *[jnp.asarray(a) for a in args],
        jpose.init_pose_state(extr), jnp.int32(frame))

    tparams = tgauss.params_from_numpy(p0, device=CPU)
    tstep = ttr.make_train_step(
        lp, op, tcfg.PipelineParams(raster_backend="torch"),
        tcfg.CapacityParams(cap), 48, 64, 4.4, 1, False,
        learnable_pose=True)
    with torch.no_grad():
        to, te = ttr.masked_chunk_aabb(tparams, active, 128)
    # the view, planes and centre passed are not read: zeros
    ts, _, tpose_new, tm = tstep(
        ttr.TrainState(tparams, topt.AdamState(*[
            {k: torch.tensor(v) for k, v in d.items()} for d in (m0, v0)]),
            active, step0),
        tstat.init_stats(cap, CPU), to, te, torch.zeros(4, 4),
        torch.tensor(args[1]), torch.zeros(6, 4), torch.zeros(3),
        torch.tensor(args[4]), tpose.init_pose_state(extr, CPU), frame)

    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    got = tgauss.params_to_numpy(ts.params)
    for k in p0:
        a = np.asarray(getattr(js.params, k))
        assert not np.array_equal(a, p0[k]), k
        np.testing.assert_allclose(got[k], a, rtol=0.0,
                                   atol=1e-5 * np.abs(a).max(), err_msg=k)
    g_j = np.asarray(jpose_new.m)[frame] / 0.1      # m = 0.1 g from zero
    assert np.abs(g_j).max() > 0
    scaled_close(tm["extr_grad"].numpy(), g_j, 1e-5)
    scaled_close(tpose_new.m.numpy(), np.asarray(jpose_new.m), 1e-5)
    np.testing.assert_allclose(tpose_new.extr.numpy(),
                               np.asarray(jpose_new.extr), rtol=0.0,
                               atol=1e-5)
    assert not np.array_equal(tpose_new.extr.numpy()[frame], extr[frame])
    np.testing.assert_array_equal(tpose_new.extr.numpy()[0], extr[0])
    assert int(tpose_new.step) == 1


def test_pose_refinement_reduces_extr_error():
    """tests/test_pose.py's case through the port's Trainer."""
    n_points, n_frames, img_h, img_w = 500, 6, 48, 64
    # ground-truth scene + images from TRUE cameras
    cam, frames = synthetic.make_cameras(n_frames, img_h, img_w, seed=3)
    data, _, _ = synthetic_train.make_task(
        n_points=n_points, n_frames=n_frames, img_h=img_h, img_w=img_w,
        sh_degree=1, seed=3, device=CPU)
    gt_params, _, _ = synthetic_train.make_gt_params(n_points, 1, seed=3,
                                                     device=CPU)
    true_extr, noisy = noisy_extr(frames, seed=0)

    # gaussians fixed at ground truth (zero lrs) => only pose trains
    tiny = 1e-12  # effectively frozen (xyz lr schedule needs log(lr))
    op = tcfg.OptimizationParams(iterations=20 * n_frames,
                                 position_lr_init=tiny,
                                 position_lr_final=tiny, feature_lr=0.0,
                                 opacity_lr=0.0, scaling_lr=0.0,
                                 rotation_lr=0.0, learnable_viewproj=True)
    cap = tcfg.round_up(n_points, 128)
    trainer = ttr.Trainer(
        lp=tcfg.ModelParams(sh_degree=1), op=op,
        pp=tcfg.PipelineParams(raster_backend="torch"),
        dp=tcfg.DensifyParams(densify_from=10**9),
        caps=tcfg.CapacityParams(primitive_capacity=cap), data=data,
        spatial_lr_scale=1.0, extr_init=noisy)
    trainer.init_points_num = cap
    params = pad_params(pad_to_chunk(gt_params, 128), cap)
    state = ttr.TrainState(params=params, adam=topt.init_adam(params),
                           active_count=cap, step=0)
    stats = trainer.init_stats()

    psnr0 = None
    for epoch in range(20):
        state, stats, m = trainer.run_epoch(state, stats, epoch)
        if psnr0 is None:
            psnr0 = m["psnr"]
    learned = trainer.pose_state.extr.numpy()

    def norm_q(e):
        out = e.copy()
        out[:, :4] /= np.linalg.norm(out[:, :4], axis=1, keepdims=True)
        return out

    err1 = np.linalg.norm(norm_q(learned) - norm_q(true_extr))
    err0 = np.linalg.norm(norm_q(noisy) - norm_q(true_extr))
    assert err1 < 0.93 * err0, (err0, err1)
    assert m["psnr"] > psnr0 + 1.0, (psnr0, m["psnr"])
