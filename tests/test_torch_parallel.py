"""litegs_torch's data parallelism against litegs_tpu's, on CPU.

The port runs one rank per process: each module fixture below spawns the
ranks once (2 gloo processes, and 3 for the top-k), joined through
``init_method=file://<tmp>/store`` so that test workers never race for a
port.  The children import only torch and litegs_torch; they read their
inputs from an npz the parent writes and write their results to npz
files.  The parent runs JAX's ``make_parallel_train_step``,
``sharded_topk_mask`` and sharded densification on 2- and 3-device meshes
of the conftest's virtual CPU devices, with ``raster_backend="jnp"``.

Bars:

* train step, float32 wire: loss and PSNR at rtol 1e-6, parameters within
  1e-5 of each field's largest value, both moments within 1e-5 scaled
  (tests/test_torch_train.py's bars for one step), the same chunks
  updated;
* train step, bf16 wire: the reduced gradient rounds to bf16 in both
  packages, so where the two float32 sums straddle a rounding boundary
  they differ by one bf16 ulp (2^-7 relative at most).  The moments are
  held within 0.1 * 2^-7 * max|g| (first) and 0.001 * 2^-6 * max g^2
  (second) of JAX's, on top of the float32 bar, with max|g| read off
  JAX's float32 step;
* a padding slot (w = 0) adds nothing: the 2-rank step over frame 2 and a
  padded duplicate equals the port's single-view step on frame 2 exactly;
* sharded statistics, gathered, equal the replicated ones exactly, and
  those equal JAX's at tests/test_torch_train.py's statistics bars;
* the replicas' parameters are bit-equal after every step;
* the sharded top-k is bit-equal to the stable ``argsort(-keys)[:budget]``
  and to JAX's at D = 2 and 3;
* the sharded densify step (taming and official) equals the port's
  replicated ``densify_step`` bit for bit with the same generator, and
  selects exactly what JAX's sharded selection selects with JAX's draws;
* ``ParallelTrainer`` at D = 2 at tests/test_parallel_trainer.py's bars.
"""
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from litegs_tpu import config as jcfg
from litegs_tpu import parallel as jpar
from litegs_tpu.data import synthetic_train as jst
from litegs_tpu.parallel import densify as jpdens
from litegs_tpu.scene import gaussians as jgauss
from litegs_tpu.training import optimizer as jopt
from litegs_tpu.training import statistics as jstat
from litegs_tpu.training import trainer as jtr

from litegs_torch import config as tcfg
from litegs_torch import parallel as tpar
from litegs_torch.data import synthetic_train as tst
from litegs_torch.scene import gaussians as tgauss
from litegs_torch.training import densify as tdens
from litegs_torch.training import optimizer as topt
from litegs_torch.training import statistics as tstat
from litegs_torch.training import trainer as ttr
from test_torch_io import make_disk_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
CAP, ACTIVE, STEP0 = 1024, 512, 3
TOPK_N = (960, 1001)            # 960 divides by 2 and 3; 1001 does not
BUDGETS = (0, 7, 128, 500, 900, 2000)
DENS_CAP, DENS_ACTIVE = 1024, 640
DENS_MODES = {
    "taming": dict(target_primitives=896),
    "official": dict(densify_mode="official", prune_mode="threshold",
                     densify_grad_threshold=0.0012),
}
DENS_COMMON = dict(densify_from=0, densify_until=10, densification_interval=1,
                   opacity_reset_interval=100)
# name -> (frames of ranks 0 and 1, their weights, wire dtype, statistics)
STEP_CASES = {
    "f32": ((0, 1), (1.0, 1.0), "f32", "replicated"),
    "f32_sharded": ((0, 1), (1.0, 1.0), "f32", "sharded"),
    "bf16": ((0, 1), (1.0, 1.0), "bf16", None),
    "pad": ((2, 0), (1.0, 0.0), "f32", "replicated"),
}

_CHILD = r'''
import os, sys
rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
torch.set_num_threads(2)
from litegs_torch import config as cfg, example_train, parallel
from litegs_torch.data import synthetic_train
from litegs_torch.parallel import densify as pdens
from litegs_torch.parallel.trainer import ParallelTrainer
from litegs_torch.scene import gaussians
from litegs_torch.training import optimizer, statistics, trainer as ttr

assert parallel.initialize_distributed(f"file://{work}/store", world, rank,
                                       device="cpu", timeout=600) == world
inp = dict(np.load(os.path.join(work, "inputs.npz")))
out = {}
FIELDS = gaussians.FIELDS


def T(x):
    return torch.tensor(np.asarray(x))


def save_model(prefix, params, adam=None):
    for k, v in params.fields().items():
        out[f"{prefix}.p.{k}"] = v.detach().numpy().copy()
    if adam is not None:
        for k in FIELDS:
            out[f"{prefix}.m.{k}"] = adam.exp_avg[k].numpy().copy()
            out[f"{prefix}.v.{k}"] = adam.exp_avg_sq[k].numpy().copy()


def topk(n):
    keys = T(inp[f"topk_keys{n}"])
    s = parallel.shard_len(n, world)
    lo, hi = min(rank * s, n), min(rank * s + s, n)
    for b in [int(x) for x in inp["budgets"]]:
        out[f"topk{n}.{b}"] = pdens.sharded_topk_mask(
            keys[lo:hi], b).numpy()


if world == 3:
    for n in [int(x) for x in inp["topk_ns"]]:
        topk(n)
    np.savez(os.path.join(work, f"out3_r{rank}.npz"), **out)
    sys.exit(0)

# -- train steps --------------------------------------------------------
lp = cfg.ModelParams(sh_degree=1)
op = cfg.OptimizationParams(iterations=96, position_lr_max_steps=96)
cap, active, step0 = [int(x) for x in inp["step_ints"]]
cams = [T(inp["cam." + k]) for k in ("view", "proj", "planes", "center",
                                     "images")]
cases = inp["case_names"].tolist()
for name, frames, weights, wire, mode in zip(
        cases, inp["case_frames"], inp["case_weights"], inp["case_wire"],
        inp["case_stats"]):
    params = gaussians.params_from_numpy(
        {k: inp["p0." + k] for k in FIELDS}, device="cpu")
    adam = optimizer.AdamState(*[{k: T(inp[f"{m}0.{k}"]) for k in FIELDS}
                                 for m in ("m", "v")])
    pp = cfg.PipelineParams(grad_allreduce_dtype=str(wire))
    collect = str(mode) != "none"
    sharded = str(mode) == "sharded"
    step = parallel.make_parallel_train_step(
        lp, op, pp, cfg.CapacityParams(cap), 48, 64, 4.4, 1, collect,
        sharded_stats=sharded)
    stats = (pdens.init_sharded_stats(cap, "cpu") if sharded
             else statistics.init_stats(cap, "cpu"))
    with torch.no_grad():
        o, e = ttr.masked_chunk_aabb(params, active, 128)
    f = int(frames[rank])
    state, stats, m = step(
        ttr.TrainState(params, adam, active, step0), stats, o, e,
        *[c[f] for c in cams], float(weights[rank]))
    assert state.step == step0 + 1
    save_model(name, state.params, state.adam)
    out[f"{name}.loss"] = m["loss"].numpy()
    out[f"{name}.psnr"] = m["psnr"].numpy()
    out[f"{name}.sizes"] = m["sizes"].numpy()
    if collect:
        if sharded:
            out[f"{name}.shard_len"] = np.int64(stats.weight_sum.shape[0])
            stats = pdens.gather_stats(stats, cap)
        for k, v in stats._asdict().items():
            out[f"{name}.s.{k}"] = v.numpy()

# -- top-k and sharded densification ------------------------------------
for n in [int(x) for x in inp["topk_ns"]]:
    topk(n)
for mode in inp["dens_modes"].tolist():
    dp = cfg.DensifyParams(**{k: (v.item() if hasattr(v, "item") else v)
                              for k, v in np.load(os.path.join(
                                  work, f"dp_{mode}.npz")).items()})
    full = statistics.StatsState(
        *[T(inp[f"d.{mode}.s.{k}"]) for k in statistics.StatsState._fields])
    shard = pdens.local_shard(full)
    dactive = int(inp["dens_active"])

    def model():
        p = gaussians.params_from_numpy(
            {k: inp[f"d.{mode}.p.{k}"] for k in FIELDS}, device="cpu")
        return p, optimizer.init_adam(p)

    sel, prune = pdens.sharded_select(
        model()[0], shard, dactive, 2, dp, 10, 256, 128,
        uniform=T(inp["d.uniform"]))
    out[f"dens.{mode}.selected"] = sel.numpy()
    out[f"dens.{mode}.prune"] = prune.numpy()
    p, a, cnt, did = pdens.sharded_densify_step(
        *model(), shard, dactive, 2, dp, 10, 256, 1.7, 128,
        generator=torch.Generator().manual_seed(7))
    out[f"dens.{mode}.count"] = np.int64(cnt)
    save_model(f"dens.{mode}", p, a)
    p, a, cnt, _ = pdens.sharded_densify_step(
        *model(), shard, dactive, 2, dp, 10, 256, 1.7, 128,
        uniform=T(inp["d.uniform"]), normal=T(inp["d.normal"]))
    out[f"dens.{mode}.jax_draws_count"] = np.int64(cnt)

# -- ParallelTrainer ----------------------------------------------------
def par_trainer(n_points, n_frames, seed, op, dp, cap):
    data, xyz, rgb = synthetic_train.make_task(
        n_points=n_points, n_frames=n_frames, img_h=48, img_w=64,
        sh_degree=1, seed=seed, device="cpu")
    tr = ParallelTrainer(
        lp=cfg.ModelParams(sh_degree=1), op=op, pp=cfg.PipelineParams(),
        dp=dp, caps=cfg.CapacityParams(cap),
        data=parallel.shard_camera_batch(data), spatial_lr_scale=4.4,
        device="cpu")
    return tr, xyz, rgb


tr, xyz, rgb = par_trainer(
    400, 8, 3, cfg.OptimizationParams(iterations=64, position_lr_max_steps=64),
    cfg.DensifyParams(densification_interval=2, densify_from=1,
                      densify_until=6, opacity_reset_interval=10 ** 9,
                      target_primitives=768), 1024)
state, _, hist = tr.train(xyz, rgb, verbose=False)
out["improve.psnr"] = np.array([h["psnr"] for h in hist])
out["improve.active"] = np.array([h["active"] for h in hist])
save_model("improve", state.params)

tr, xyz, rgb = par_trainer(
    300, 5, 4, cfg.OptimizationParams(iterations=30, position_lr_max_steps=30),
    cfg.DensifyParams(densify_from=1000), 512)
out["odd.steps"] = np.int64(tr.steps_per_epoch)
ids, w = tr.epoch_frames()
out["odd.global_ids"] = np.array(ids) * world + rank
out["odd.weights"] = np.array(w)
state, _, hist = tr.train(xyz, rgb, verbose=False)
out["odd.psnr"] = np.array([h["psnr"] for h in hist])

tr, xyz, rgb = par_trainer(
    300, 4, 5, cfg.OptimizationParams(iterations=24, position_lr_max_steps=12),
    cfg.DensifyParams(densify_from=1000), 512)
state = tr.init_state(xyz, rgb)
stats = tr.init_stats()
for ep in range(6):         # 6 epochs x 2 steps = 12 updates of 2 views
    state, stats, m = tr.run_epoch(state, stats, ep)
    state, stats = tr.epoch_boundary(state, stats, ep)
out["equal.psnr"] = np.float64(m["psnr"])
out["equal.steps"] = np.int64(state.step)

# -- the command line ---------------------------------------------------
scene = str(inp["scene"])
model = os.path.join(work, f"model_r{rank}")
trainer, state, hist = example_train.main(
    ["-s", scene, "-m", model, "--eval", "--iterations", "30",
     "--sh_degree", "1", "--target_primitives", "1024", "--densify_from",
     "1", "--densify_until", "3", "--test_epochs", "5",
     "--checkpoint_epochs", "2", "--parallel", "on"], device="cpu")
out["cli.type"] = np.array(type(trainer).__name__)
out["cli.psnr"] = np.array([h["psnr"] for h in hist])
out["cli.test_psnr"] = np.float64(hist[5]["test_psnr"])
out["cli.n_local"] = np.int64(trainer.data.images.shape[0])
save_model("cli", state.params)
# resume both ranks from rank 0's checkpoint: the statistics are gathered
# into the file and sharded again on load
ckpt = os.path.join(work, "model_r0", "checkpoints", "chkpnt2.npz")
_, state, hist = example_train.main(
    ["-s", scene, "-m", model + "_resumed", "--eval", "--iterations", "30",
     "--sh_degree", "1", "--target_primitives", "1024", "--densify_from",
     "1", "--densify_until", "3", "--parallel", "on", "--start_checkpoint",
     ckpt], device="cpu")
out["cli.resumed_epochs"] = np.array([h["epoch"] for h in hist])
save_model("cli_resumed", state.params)
out["collectives"] = np.array(sorted(parallel.COLLECTIVE_CALLS.items()))
np.savez(os.path.join(work, f"out2_r{rank}.npz"), **out)
'''


def _spawn(work, world: int):
    """Run the child as ranks 0..world-1; return their outputs."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(r), str(world), str(work)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, "OMP_NUM_THREADS": "2"})
        for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(os.path.join(work, f"out{world}_r{r}.npz")))
            for r in range(world)]


def _nontrivial_state():
    """tests/test_torch_train.py's non-degenerate starting model, 3
    frames, as numpy."""
    kw = dict(n_points=500, n_frames=3, img_h=48, img_w=64, sh_degree=1,
              seed=3)
    jdata, xyz, rgb = jst.make_task(**kw)
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
    cams = {k: np.asarray(getattr(jdata, k)) for k in
            ("view", "proj", "planes", "center", "images")}
    return p0, m0, v0, cams


def _densify_state(mode):
    """tests/test_parallel_densify.py's state (seed 0 taming, 5 official
    with its gradient norms), as numpy."""
    seed = 0 if mode == "taming" else 5
    rng = np.random.default_rng(seed)
    n = DENS_CAP
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    p = dict(xyz=mk(3, n), scale=mk(3, n) - 2, rot=mk(4, n),
             sh_0=mk(1, 3, n), sh_rest=mk(9, n), opacity=mk(1, n))
    s = {k: np.zeros(n, np.int32 if k == "visible_count" else np.float32)
         for k in jstat.StatsState._fields}
    s["weight_sum"] = ((rng.random(n) > 0.2) * rng.random(n)).astype(
        np.float32)
    s["err_sum"] = mk(n)
    s["err_sq_sum"] = np.abs(mk(n)) + np.float32(0.01)
    s["frag_count"] = rng.integers(0, 50, n).astype(np.float32)
    s["visible_count"] = rng.integers(0, 8, n).astype(np.int32)
    if mode == "official":
        rng = np.random.default_rng(9)
        s["grad_norm_sum"] = (np.abs(rng.standard_normal(n))
                              * 0.01).astype(np.float32)
        s["visible_count"] = rng.integers(1, 9, n).astype(np.int32)
    return p, s


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs written once; the 2-rank and 3-rank children run once."""
    work = tmp_path_factory.mktemp("dist")
    p0, m0, v0, cams = _nontrivial_state()
    inp = {f"{k}0.{f}": v for k, d in (("p", p0), ("m", m0), ("v", v0))
           for f, v in d.items()}
    inp.update({f"cam.{k}": v for k, v in cams.items()})
    inp["step_ints"] = np.array([CAP, ACTIVE, STEP0])
    inp["case_names"] = np.array(list(STEP_CASES))
    inp["case_frames"] = np.array([c[0] for c in STEP_CASES.values()])
    inp["case_weights"] = np.array([c[1] for c in STEP_CASES.values()])
    inp["case_wire"] = np.array([c[2] for c in STEP_CASES.values()])
    inp["case_stats"] = np.array([c[3] or "none"
                                  for c in STEP_CASES.values()])
    rng = np.random.default_rng(1)
    for n in TOPK_N:
        keys = rng.standard_normal(n).astype(np.float32)
        keys[rng.random(n) < 0.3] = -np.inf
        keys[100:110] = keys[50]             # exact ties
        keys[400:420] = keys[300]            # ties across the D = 2 cut
        inp[f"topk_keys{n}"] = keys
    inp["topk_ns"] = np.array(TOPK_N)
    inp["budgets"] = np.array(BUDGETS)
    key = jax.random.PRNGKey(7)
    inp["d.uniform"] = np.asarray(jax.random.uniform(
        key, (DENS_CAP,), minval=1e-10, maxval=1.0))
    inp["d.normal"] = np.asarray(jax.random.normal(
        jax.random.fold_in(key, 1), (3, DENS_CAP)))
    inp["dens_modes"] = np.array(list(DENS_MODES))
    inp["dens_active"] = np.int64(DENS_ACTIVE)
    for mode, extra in DENS_MODES.items():
        p, s = _densify_state(mode)
        inp.update({f"d.{mode}.p.{k}": v for k, v in p.items()})
        inp.update({f"d.{mode}.s.{k}": v for k, v in s.items()})
        np.savez(work / f"dp_{mode}.npz", **DENS_COMMON, **extra)
    inp["scene"] = np.array(make_disk_dataset(str(work / "scene")))
    np.savez(work / "inputs.npz", **inp)
    return {"inputs": inp, "r2": _spawn(work, 2), "r3": _spawn(work, 3)}


def scaled_close(got, want, atol, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, atol=atol,
                               err_msg=name)


@pytest.fixture(scope="module")
def jax_steps(runs):
    """JAX's 2-device step from the same state over frames 0 and 1: the
    float32 wire with replicated statistics, and the bf16 wire."""
    inp = runs["inputs"]
    mesh = jpar.make_mesh(2)
    lp = jcfg.ModelParams(sh_degree=1)
    op = jcfg.OptimizationParams(iterations=96, position_lr_max_steps=96)
    caps = jcfg.CapacityParams(CAP, CAP, 8192, 32768)
    gp = lambda pre: jgauss.GaussianParams(**{  # noqa: E731
        k: jnp.asarray(inp[f"{pre}0.{k}"]) for k in tgauss.FIELDS})
    out = {}
    for wire, collect in (("f32", True), ("bf16", False)):
        pp = jcfg.PipelineParams(raster_backend="jnp",
                                 grad_allreduce_dtype=wire)
        params = gp("p")
        state = jpar.replicate(mesh, jtr.TrainState(
            params, jopt.AdamState(gp("m"), gp("v")), jnp.int32(ACTIVE),
            jnp.int32(STEP0)))
        origin, extend = jpar.replicate(
            mesh, jtr.masked_chunk_aabb(params, ACTIVE, 128))
        cams = jpar.shard_camera_batch(mesh, *[
            jnp.asarray(inp[f"cam.{k}"][:2]) for k in
            ("view", "proj", "planes", "center", "images")])
        step = jpar.make_parallel_train_step(
            lp, op, pp, caps, 48, 64, 4.4, 1, collect, mesh)
        out[wire] = jax.device_get(step(
            state, jpar.replicate(mesh, jstat.init_stats(CAP)), origin,
            extend, *cams, jpar.unit_weights(mesh)))
    return out


def _model(res, prefix):
    return {part: {k: res[f"{prefix}.{part}.{k}"] for k in tgauss.FIELDS}
            for part in ("p", "m", "v") if f"{prefix}.{part}.xyz" in res}


def test_replicas_stay_bit_equal(runs):
    r0, r1 = runs["r2"]
    keys = [k for k in r0 if k.split(".")[0] in STEP_CASES or
            k.startswith(("dens.", "improve.p", "cli.p", "cli_resumed.p"))]
    assert len(keys) > 100
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    calls = dict((k, int(v)) for k, v in r0["collectives"])
    assert calls["all_reduce"] > 0 and calls["reduce_scatter"] > 0
    assert calls["all_gather"] > 0


def _moved_chunks(m, m0):
    """[N / 128] bool: the chunks whose first moment changed."""
    return (np.asarray(m) != m0).reshape(-1, CAP // 128, 128).any(
        axis=(0, 2))


def test_f32_step_matches_jax(runs, jax_steps):
    res = runs["r2"][0]
    js, jstats, jm = jax_steps["f32"]
    got = _model(res, "f32")
    np.testing.assert_allclose(res["f32.loss"], float(jm["loss"]), rtol=1e-6)
    np.testing.assert_allclose(res["f32.psnr"], float(jm["psnr"]), rtol=1e-6)
    np.testing.assert_array_equal(res["f32.sizes"], np.asarray(jm["sizes"]))
    inp = runs["inputs"]
    for k in tgauss.FIELDS:
        a = np.asarray(getattr(js.params, k))
        assert not np.array_equal(a, inp[f"p0.{k}"]), k
        np.testing.assert_allclose(got["p"][k], a, rtol=0.0,
                                   atol=1e-5 * np.abs(a).max(), err_msg=k)
        scaled_close(got["m"][k], getattr(js.adam.exp_avg, k), 1e-5, k)
        scaled_close(got["v"][k], getattr(js.adam.exp_avg_sq, k), 1e-5, k)
        # the union chunk mask: the same chunks moved
        np.testing.assert_array_equal(
            _moved_chunks(got["m"][k], inp[f"m0.{k}"]),
            _moved_chunks(getattr(js.adam.exp_avg, k), inp[f"m0.{k}"]),
            err_msg=k)
    assert _moved_chunks(got["m"]["xyz"], inp["m0.xyz"]).sum() == (
        ACTIVE // 128)


def test_bf16_step_within_a_bf16_ulp_of_jax(runs, jax_steps):
    res = runs["r2"][0]
    inp = runs["inputs"]
    js32 = jax_steps["f32"][0]
    js, _, jm = jax_steps["bf16"]
    got = _model(res, "bf16")
    np.testing.assert_allclose(res["bf16.loss"], float(jm["loss"]),
                               rtol=1e-6)
    ulp = 2.0 ** -7
    for k in tgauss.FIELDS:
        g = (np.asarray(getattr(js32.adam.exp_avg, k), np.float64)
             - 0.9 * inp[f"m0.{k}"]) / 0.1
        gmax = np.abs(g).max()
        for part, want, tol in (
                ("m", getattr(js.adam.exp_avg, k), 0.1 * ulp * gmax),
                ("v", getattr(js.adam.exp_avg_sq, k),
                 0.001 * 2 * ulp * gmax ** 2)):
            want = np.asarray(want, np.float64)
            np.testing.assert_allclose(
                got[part][k], want, rtol=0.0,
                atol=tol + 1e-5 * np.abs(want).max(), err_msg=f"{part} {k}")
    # the wire matters: the bf16 step is not the float32 one
    assert any(not np.array_equal(got["m"][k], res[f"f32.m.{k}"])
               for k in tgauss.FIELDS)


def test_padding_slot_equals_one_view_step(runs):
    res = runs["r2"][0]
    inp = runs["inputs"]
    params = tgauss.params_from_numpy({k: inp[f"p0.{k}"]
                                       for k in tgauss.FIELDS}, device=CPU)
    adam = topt.AdamState(*[{k: torch.tensor(inp[f"{m}0.{k}"])
                             for k in tgauss.FIELDS} for m in ("m", "v")])
    step = ttr.make_train_step(
        tcfg.ModelParams(sh_degree=1),
        tcfg.OptimizationParams(iterations=96, position_lr_max_steps=96),
        tcfg.PipelineParams(grad_allreduce_dtype="f32"),
        tcfg.CapacityParams(CAP), 48, 64, 4.4, 1, True)
    with torch.no_grad():
        o, e = ttr.masked_chunk_aabb(params, ACTIVE, 128)
    state, stats, m = step(
        ttr.TrainState(params, adam, ACTIVE, STEP0),
        tstat.init_stats(CAP, CPU), o, e,
        *[torch.tensor(inp[f"cam.{k}"][2]) for k in
          ("view", "proj", "planes", "center", "images")])
    got = _model(res, "pad")
    want = tgauss.params_to_numpy(state.params)
    for k in tgauss.FIELDS:
        np.testing.assert_array_equal(got["p"][k], want[k], err_msg=k)
        np.testing.assert_array_equal(got["m"][k],
                                      state.adam.exp_avg[k].numpy())
        np.testing.assert_array_equal(got["v"][k],
                                      state.adam.exp_avg_sq[k].numpy())
    assert float(res["pad.loss"]) == float(m["loss"])
    assert float(res["pad.psnr"]) == float(m["psnr"])
    for k, v in stats._asdict().items():
        np.testing.assert_array_equal(res[f"pad.s.{k}"], v.numpy(), k)
    # both ranks' sizes are reported, the padded slot's too
    np.testing.assert_array_equal(res["pad.sizes"][0], m["sizes"].numpy())


def test_sharded_statistics_equal_replicated_and_jax(runs, jax_steps):
    res = runs["r2"][0]
    assert int(res["f32_sharded.shard_len"]) == CAP // 2
    for k in tstat.StatsState._fields:
        np.testing.assert_array_equal(res[f"f32_sharded.s.{k}"],
                                      res[f"f32.s.{k}"], err_msg=k)
    for k in tgauss.FIELDS:
        np.testing.assert_array_equal(res[f"f32_sharded.p.{k}"],
                                      res[f"f32.p.{k}"], err_msg=k)
    jstats = jax_steps["f32"][1]
    s_t = {f: res[f"f32.s.{f}"] for f in tstat.StatsState._fields}
    s_j = {f: np.asarray(getattr(jstats, f)) for f in
           jstat.StatsState._fields}
    np.testing.assert_array_equal(s_t["visible_count"], s_j["visible_count"])
    np.testing.assert_allclose(s_t["weight_sum"], s_j["weight_sum"],
                               atol=2e-3)
    np.testing.assert_allclose(s_t["frag_count"], s_j["frag_count"],
                               atol=0.5)
    scaled_close(s_t["weight_sq_sum"], s_j["weight_sq_sum"], 1e-3)
    scaled_close(s_t["err_sum"], s_j["err_sum"], 2e-4)
    scaled_close(s_t["err_sq_sum"], s_j["err_sq_sum"], 1e-3)
    scaled_close(s_t["grad_norm_sum"], s_j["grad_norm_sum"], 2e-3)
    assert s_t["frag_count"].sum() > 0


def _jax_topk(keys, budget, d):
    mesh = jpar.make_mesh(d)
    f = jax.jit(jax.shard_map(
        lambda local: jpdens.sharded_topk_mask(local, jnp.int32(budget)),
        mesh=mesh, in_specs=P(jpar.DATA_AXIS), out_specs=P(jpar.DATA_AXIS),
        check_vma=False))
    return np.asarray(f(jnp.asarray(keys)))


@pytest.mark.parametrize("d", [2, 3])
def test_sharded_topk_equals_stable_argsort_and_jax(runs, d):
    inp = runs["inputs"]
    outs = runs[f"r{d}"]
    for n in TOPK_N:
        keys = inp[f"topk_keys{n}"]
        order = np.argsort(-keys, kind="stable")
        for b in BUDGETS:
            got = np.concatenate([o[f"topk{n}.{b}"] for o in outs])
            want = np.zeros(n, bool)
            want[order[:b]] = True
            want &= keys > -np.inf
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"n={n} budget={b}")
            assert got.sum() == min(b, int(np.isfinite(keys).sum()))
            if n % d == 0:
                np.testing.assert_array_equal(got, _jax_topk(keys, b, d))


@pytest.mark.parametrize("mode", list(DENS_MODES))
def test_sharded_densify_equals_replicated_and_jax(runs, mode):
    res = runs["r2"][0]
    inp = runs["inputs"]
    dp_kw = {**DENS_COMMON, **DENS_MODES[mode]}
    p = {k: inp[f"d.{mode}.p.{k}"] for k in tgauss.FIELDS}
    s = {k: inp[f"d.{mode}.s.{k}"] for k in tstat.StatsState._fields}
    params = tgauss.params_from_numpy(p, device=CPU)
    want = tdens.densify_step(
        params, topt.init_adam(params),
        tstat.StatsState(**{k: torch.tensor(v) for k, v in s.items()}),
        DENS_ACTIVE, 2, tcfg.DensifyParams(**dp_kw), 10, 256, 1.7, 128,
        generator=torch.Generator().manual_seed(7))
    assert want[3] and int(res[f"dens.{mode}.count"]) == want[2]
    assert res[f"dens.{mode}.selected"].sum() >= 128      # something grew
    got = _model(res, f"dens.{mode}")
    for k in tgauss.FIELDS:
        np.testing.assert_array_equal(got["p"][k],
                                      getattr(want[0], k).detach().numpy())
        np.testing.assert_array_equal(got["m"][k],
                                      want[1].exp_avg[k].numpy())
        np.testing.assert_array_equal(got["v"][k],
                                      want[1].exp_avg_sq[k].numpy())

    # JAX's sharded selection from the same statistics and key
    mesh = jpar.make_mesh(2)
    jdp = jcfg.DensifyParams(**dp_kw)
    jparams = jgauss.GaussianParams(**{k: jnp.asarray(v)
                                       for k, v in p.items()})
    jstats = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P(jpar.DATA_AXIS))),
        jstat.StatsState(**{k: jnp.asarray(v) for k, v in s.items()}))
    key = jax.random.PRNGKey(7)
    sel, prune = jpdens._make_select_fn(mesh, jdp, 10, 256, 128, DENS_CAP)(
        jparams, jstats, jnp.int32(DENS_ACTIVE), jnp.int32(2), key)
    np.testing.assert_array_equal(res[f"dens.{mode}.selected"],
                                  np.asarray(sel))
    np.testing.assert_array_equal(res[f"dens.{mode}.prune"],
                                  np.asarray(prune))
    _, _, jcount, _ = jpdens.sharded_densify_step(
        mesh, jparams, jopt.init_adam(jparams), jstats,
        jnp.int32(DENS_ACTIVE), 2, key, jdp, 10, 256, 1.7, 128)
    assert int(res[f"dens.{mode}.jax_draws_count"]) == int(jcount)


def test_parallel_trainer_improves_psnr(runs):
    res = runs["r2"][0]
    psnr, active = res["improve.psnr"], res["improve.active"]
    assert psnr[-1] > psnr[0] + 1.0, psnr
    assert (active % 128 == 0).all() and active[-1] >= active[0], active
    assert active[-1] > active[0], active


def test_parallel_trainer_frames_not_multiple_of_d(runs):
    r0, r1 = runs["r2"]
    assert int(r0["odd.steps"]) == int(r1["odd.steps"]) == 3
    assert r0["odd.weights"].sum() == 3 and r1["odd.weights"].sum() == 2
    assert len(r1["odd.global_ids"]) == 3      # padded with a duplicate
    live = np.concatenate([r["odd.global_ids"][r["odd.weights"] > 0]
                           for r in (r0, r1)])
    assert sorted(live.tolist()) == list(range(5))
    assert r0["odd.psnr"][-1] > r0["odd.psnr"][0], r0["odd.psnr"]


def test_parallel_equals_sequential_at_equal_updates(runs):
    """tests/test_parallel_trainer.py's convergence bar at D = 2: 12
    updates of the 2-view mean against 12 sequential updates."""
    res = runs["r2"][0]
    assert int(res["equal.steps"]) == 12
    data, xyz, rgb = tst.make_task(n_points=300, n_frames=4, img_h=48,
                                   img_w=64, sh_degree=1, seed=5, device=CPU)
    seq = ttr.Trainer(
        lp=tcfg.ModelParams(sh_degree=1),
        op=tcfg.OptimizationParams(iterations=12, position_lr_max_steps=12),
        pp=tcfg.PipelineParams(), dp=tcfg.DensifyParams(densify_from=1000),
        caps=tcfg.CapacityParams(512), data=data, spatial_lr_scale=4.4)
    state = seq.init_state(xyz, rgb)
    stats = seq.init_stats()
    for ep in range(3):
        state, stats, m_seq = seq.run_epoch(state, stats, ep)
        state, stats = seq.epoch_boundary(state, stats, ep)
    assert float(res["equal.psnr"]) > m_seq["psnr"] - 1.5, (
        float(res["equal.psnr"]), m_seq["psnr"])


def test_cli_parallel_on_trains_through_start(runs, tmp_path):
    """``--parallel on`` at D = 2: each rank trains its round-robin share
    of the 5 training frames, only rank 0 writes, the model trains, and a
    resume from the epoch-2 checkpoint finishes."""
    r0, r1 = runs["r2"]
    assert str(r0["cli.type"]) == "ParallelTrainer"
    assert int(r0["cli.n_local"]) == 3 and int(r1["cli.n_local"]) == 2
    assert r0["cli.psnr"][-1] > r0["cli.psnr"][0] + 3.0, r0["cli.psnr"]
    assert np.isfinite(float(r0["cli.test_psnr"]))
    work = os.path.dirname(str(runs["inputs"]["scene"]))
    model0 = os.path.join(work, "model_r0")
    assert os.path.exists(os.path.join(model0, "point_cloud", "finish",
                                       "point_cloud.ply"))
    assert os.path.exists(os.path.join(model0, "checkpoints",
                                       "chkpnt2.npz"))
    assert not os.path.exists(os.path.join(work, "model_r1"))
    # the resumed run restored the sharded statistics and finished
    assert r0["cli.resumed_epochs"].tolist() == [3, 4, 5]
    assert os.path.exists(os.path.join(work, "model_r0_resumed",
                                       "point_cloud", "finish",
                                       "point_cloud.ply"))
    assert not os.path.exists(os.path.join(work, "model_r1_resumed"))


def test_profiling_helpers(tmp_path):
    from litegs_torch.utils import profiling
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("outer"):
            torch.ones(8).sum()
    assert os.path.exists(tmp_path / "trace.json")
    assert any(e.key == "outer" for e in prof.key_averages())
    calls = []
    secs, out = profiling.timed(lambda x: calls.append(x) or x + 1, 2, n=3)
    assert out == 3 and len(calls) == 4 and secs >= 0.0


def test_shard_frames_for_process_matches_jax():
    jstart = importlib.import_module("litegs_tpu.training.start")
    tstart = importlib.import_module("litegs_torch.training.start")
    frames = list(range(11))
    for d in (1, 2, 3, 4):
        for r in range(d):
            assert (tstart.shard_frames_for_process(frames, r, d)
                    == jstart.shard_frames_for_process(frames, r, d))
    assert tstart.shard_frames_for_process(frames) == frames


@pytest.mark.parametrize("want,pose,world,expect", [
    ("auto", False, 1, "Trainer"), ("auto", False, 2, "ParallelTrainer"),
    ("on", False, 1, "ParallelTrainer"), ("off", False, 2, "Trainer"),
    ("auto", True, 2, "Trainer"), ("on", True, 1, ValueError),
    ("bogus", False, 1, ValueError)])
def test_pick_trainer_table(monkeypatch, want, pose, world, expect):
    tstart = importlib.import_module("litegs_torch.training.start")
    monkeypatch.setattr(tpar, "world", lambda: (world, 0))
    op = tcfg.OptimizationParams(learnable_viewproj=pose)
    pp = tcfg.PipelineParams(parallel=want)
    if expect is ValueError:
        with pytest.raises(ValueError):
            tstart._use_parallel(pp, op)
        return
    assert tstart._use_parallel(pp, op) == (expect == "ParallelTrainer")
    if world > 1:
        return    # a ParallelTrainer over 2 ranks needs a process group
    data = tst.make_task(n_points=64, n_frames=2, img_h=16, img_w=16,
                         sh_degree=0, device=CPU)[0]
    trainer = tstart._pick_trainer(
        tcfg.ModelParams(), op, pp, tcfg.DensifyParams(),
        tcfg.CapacityParams(256), data, 1.0,
        np.zeros((2, 7), np.float32), device=CPU)
    assert type(trainer).__name__ == expect


def test_initialize_distributed_single_and_unreachable(tmp_path):
    assert tpar.initialize_distributed(device=CPU) == 1
    assert not torch.distributed.is_initialized()
    store = tmp_path / "never_joined"
    with pytest.raises(Exception):
        tpar.initialize_distributed(f"file://{store}", world_size=2, rank=0,
                                    device=CPU, timeout=3)
    assert not torch.distributed.is_initialized()
