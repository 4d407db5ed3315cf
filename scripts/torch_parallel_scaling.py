"""Data-parallel training over the cards of one host, beside one card.

    torchrun --nproc_per_node N scripts/torch_parallel_scaling.py

One rank per card, joined through torchrun's environment (NCCL).  The
scene is chip_smoke.py's training model at full width: 1,000,000
gaussians, SH 3, sh_0 perturbed, padded to 1,600,128, non-zero Adam
moments; views 0..N-1 of its 840x1296 serving views (8x16 tiles), each
rank training its own.  Rank 0 prints:

* the replicas bit-equal at the start;
* one step of ``make_parallel_train_step`` (float32 wire) against the
  mean of the N views' gradients taken on rank 0 alone through the same
  sparse Adam (parameters and moments within PAR_TOL of each field's
  largest value);
* STEPS steps at each wire dtype (with statistics, sharded), ms per step
  (host clock around synchronised steps, median after one) and views per
  second, beside ``make_train_step`` on one view per rank; the replicas
  bit-equal after them;
* the all-reduce of the 59 x 1,600,128 gradient words alone at each wire
  dtype (median of 5), its algorithm and bus bandwidth, and the NCCL
  kernels' time per step under ``torch.profiler``;
* the sharded densify of the run's statistics bit-equal to the
  replicated ``densify_step`` on every rank, and its 32 bisection rounds.

It stops with a nonzero exit when a check fails.  ``--device cpu``
with ``--points`` and ``--hw`` rehearses it on gloo processes.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

STEPS = 8
PAR_TOL = 1e-5


def synced_ms(fn, dev, repeats: int = 1):
    """Host milliseconds per call of ``fn()``, synchronised around."""
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / repeats, out


def replicas_equal(tensors) -> bool:
    """Every rank holds the same bits: elementwise MAX equals MIN."""
    import torch
    import torch.distributed as dist
    from litegs_torch import parallel
    same = True
    for t in tensors:
        bits = t.detach().contiguous().view(torch.int32)
        hi = parallel.collective("all_reduce", bits.clone(),
                                 op=dist.ReduceOp.MAX)
        lo = parallel.collective("all_reduce", bits.clone(),
                                 op=dist.ReduceOp.MIN)
        same = same and torch.equal(hi, lo)
    return same


def model_tensors(state):
    return [*state.params.fields().values(), *state.adam.exp_avg.values(),
            *state.adam.exp_avg_sq.values()]


def mean_view_update(state, views, lp, op, pp, caps, img_h, img_w,
                     sh_degree, origin, extend):
    """The update one card takes from the mean gradient of ``views`` and
    the union of their chunk masks (the reference of the data-parallel
    step), on a copy of ``state``."""
    import torch
    from litegs_torch.render import render, render_preprocess
    from litegs_torch.scene import cluster
    from litegs_torch.training.optimizer import (LearningRates,
                                                 sparse_adam_step)
    from litegs_torch.training.trainer import view_loss
    ref = chip_smoke.clone_state(state)
    params = ref.params
    chunk = pp.cluster_size
    grads, mask = None, None
    for view in views:
        params.zero_grad(set_to_none=True)
        culled = render_preprocess(params, origin, extend, view[2], view[3],
                                   sh_degree, pp)
        out = render(culled, view[0], view[1], img_h, img_w, pp)
        view_loss(op, pp, out.img, view[4], culled.scale,
                  out.transmitance).backward()
        g = [torch.zeros_like(v) if v.grad is None else v.grad.clone()
             for v in params.fields().values()]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        vis = cluster.scatter_chunk_mask(culled.chunk_ids,
                                         culled.num_visible_chunks,
                                         caps.primitive_capacity // chunk)
        mask = vis if mask is None else mask | vis
    params.zero_grad(set_to_none=True)
    sparse_adam_step(params, dict(zip(params.fields(),
                                      [g / len(views) for g in grads])),
                     ref.adam, LearningRates.from_config(op, 1.0, ref.step),
                     mask, chunk)
    return ref


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--points", type=int, default=chip_smoke.N_POINTS)
    ap.add_argument("--hw", type=int, nargs=2,
                    default=(chip_smoke.IMG_H, chip_smoke.IMG_W))
    args = ap.parse_args()
    import torch
    import torch.distributed as dist
    from litegs_torch import config, evaluation, parallel
    from litegs_torch.data import synthetic
    from litegs_torch.parallel import densify as pdensify
    from litegs_torch.training import densify, optimizer
    from litegs_torch.training import statistics as tstats
    from litegs_torch.training.trainer import (TrainState,
                                               camera_batch_from_frames,
                                               make_train_step,
                                               masked_chunk_aabb)
    from litegs_torch.utils import resolve_device

    dev = resolve_device(args.device)
    world = parallel.initialize_distributed(device=dev)
    _, rank = parallel.world()
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    def check(ok: bool, what: str):
        # every rank reaches every check, so all stop together
        flag = parallel.collective("all_reduce", torch.tensor(
            [0 if ok else 1], device=dev), op=dist.ReduceOp.MAX)
        if int(flag) != 0:
            say(f"torch_parallel_scaling FAILED: {what}")
            dist.destroy_process_group()
            raise SystemExit(1)

    say(f"torch {torch.__version__}, {world} ranks, backend "
        f"{dist.get_backend()}")
    if dev.type == "cuda":
        say(f"card: {chip_smoke.card_line()} x {torch.cuda.device_count()}")
    img_h, img_w = args.hw
    sh_degree = chip_smoke.SH_DEGREE
    t0 = time.perf_counter()
    model = chip_smoke.make_scene(dev, args.points, sh_degree)
    prepared, active = evaluation.prepare_model(model, config.PipelineParams())
    n_views = max(chip_smoke.N_VIEWS, world)
    cam, frames = synthetic.make_cameras(n_views, img_h, img_w, seed=0)
    blank = camera_batch_from_frames(
        cam, frames, np.zeros((n_views, 3, img_h, img_w), np.float32),
        device=dev)
    gt = torch.stack([img for _, img in evaluation.render_views(
        prepared, active, blank, config.PipelineParams(), sh_degree)])
    batch = blank._replace(images=gt)
    params = chip_smoke.perturbed_model(dev, prepared, active)
    del model, prepared
    cap = params.capacity
    adam = optimizer.init_adam(params)
    gen = torch.Generator(device=dev).manual_seed(11)
    for v in adam.exp_avg.values():
        v.normal_(0.0, 1e-4, generator=gen)
    for v in adam.exp_avg_sq.values():
        v.uniform_(1e-8, 1e-6, generator=gen)
    start = TrainState(params, adam, active, 0)
    say(f"scene: {cap} slots ({active} live), {n_views} views "
        f"{img_h}x{img_w}, set-up {time.perf_counter() - t0:.1f} s on rank "
        "0")
    same = replicas_equal(model_tensors(start))
    say(f"replicas bit-equal at the start: {same}")
    check(same, "the ranks' starting models differ")

    lp = config.ModelParams(sh_degree=sh_degree)
    op = config.OptimizationParams()
    caps = config.CapacityParams(primitive_capacity=cap)
    chunk = config.PipelineParams().cluster_size
    mine = [x[rank] for x in batch]

    def steps_of(wire, collect=True):
        pp = config.PipelineParams(grad_allreduce_dtype=wire)
        return pp, parallel.make_parallel_train_step(
            lp, op, pp, caps, img_h, img_w, 1.0, sh_degree, collect,
            sharded_stats=True)

    # ---- one step against one card's mean-gradient update ----
    pp, step = steps_of("f32")
    with torch.no_grad():
        origin, extend = masked_chunk_aabb(start.params, active, chunk)
    state = chip_smoke.clone_state(start)
    state, _, _ = step(state, pdensify.init_sharded_stats(cap, dev), origin,
                       extend, *mine, 1.0)
    diff = 0.0
    if rank == 0:
        ref = mean_view_update(
            start, [[x[v] for x in batch] for v in range(world)], lp, op, pp,
            caps, img_h, img_w, sh_degree, origin, extend)
        diff = chip_smoke.field_diff(state, ref)
        del ref
    say(f"one step over {world} views against the mean of their gradients "
        f"on one card: largest scaled difference {diff:.3e} (bar "
        f"{PAR_TOL:g})")
    check(diff <= PAR_TOL, f"the data-parallel update differs by {diff}")
    del state

    # ---- steps at each wire dtype, beside make_train_step ----
    results = {}
    for wire in ("f32", "bf16"):
        _, step = steps_of(wire)
        state = chip_smoke.clone_state(start)
        stats = pdensify.init_sharded_stats(cap, dev)
        ms, losses = [], []
        for i in range(STEPS):
            with torch.no_grad():
                origin, extend = masked_chunk_aabb(state.params, active,
                                                   chunk)
            t, (state, stats, m) = synced_ms(lambda: step(
                state, stats, origin, extend, *mine, 1.0), dev)
            ms.append(t)
            losses.append(float(m["loss"]))
        same = replicas_equal(model_tensors(state))
        med = statistics.median(ms[1:])
        results[wire] = (state, stats, med)
        say(f"{wire} wire: {STEPS} steps of {world} views, "
            f"{statistics.median(ms[1:]):.3f} ms per step (median after 1; "
            f"host clock, synchronised), {1e3 * world / med:.2f} views/s; "
            f"mean losses {np.round(losses, 6).tolist()}; replicas "
            f"bit-equal after them: {same}")
        check(same, f"the replicas differ after the {wire} steps")
    single = make_train_step(lp, op, config.PipelineParams(), caps, img_h,
                             img_w, 1.0, sh_degree, True)
    state = chip_smoke.clone_state(start)
    stats = tstats.init_stats(cap, dev)
    ms = []
    for i in range(STEPS):
        with torch.no_grad():
            origin, extend = masked_chunk_aabb(state.params, active, chunk)
        t, (state, stats, _) = synced_ms(lambda: single(
            state, stats, origin, extend, *mine), dev)
        ms.append(t)
    med1 = statistics.median(ms[1:])
    say(f"make_train_step, one view on each card alone: {med1:.3f} ms per "
        f"step, {1e3 / med1:.2f} views/s per card; data-parallel speed-up "
        f"in views/s: f32 {world * med1 / results['f32'][2]:.2f}x, bf16 "
        f"{world * med1 / results['bf16'][2]:.2f}x over {world} ranks")
    del state, stats

    # ---- the gradient all-reduce alone, and under the profiler ----
    words = 59 * cap
    for wire, dtype, size in (("f32", torch.float32, 4),
                              ("bf16", torch.bfloat16, 2)):
        buf = torch.ones(words, dtype=dtype, device=dev)
        parallel.collective("all_reduce", buf)
        t, _ = synced_ms(lambda: parallel.collective("all_reduce", buf),
                         dev, repeats=5)
        algbw = words * size / (t * 1e-3) / 1e9
        say(f"all-reduce of {words} {wire} words ({words * size / 1e6:.1f} "
            f"MB) alone: {t:.3f} ms (mean of 5, host clock, synchronised), "
            f"algorithm bandwidth {algbw:.1f} GB/s, bus bandwidth "
            f"{algbw * 2 * (world - 1) / world:.1f} GB/s")
        del buf
    if dev.type == "cuda":
        for wire in ("f32", "bf16"):
            _, step = steps_of(wire, collect=False)
            box = [chip_smoke.clone_state(start)]
            with torch.no_grad():
                origin, extend = masked_chunk_aabb(box[0].params, active,
                                                   chunk)

            def run():
                for _ in range(2):
                    box[0], _, _ = step(box[0], None, origin, extend,
                                        *mine, 1.0)

            run()
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                run()
                torch.cuda.synchronize()
            events = prof.key_averages()
            nccl = sum(e.self_device_time_total for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and "nccl" in e.key.lower()) / 2 / 1e3
            busy = sum(e.self_device_time_total for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       ) / 2 / 1e3
            spans, host, _ = chip_smoke.span_ms(
                prof, "collective:all_reduce", 2)
            say(f"profiled 2 steps, {wire} wire, rank 0: device busy "
                f"{busy:.3f} ms per step, NCCL kernels {nccl:.3f} ms; "
                f"{spans:g} all-reduce spans, {host:.3f} ms of host time")
            del box

    # ---- the sharded densify of the float32 run's statistics ----
    state, stats, _ = results["f32"]
    dp = config.DensifyParams(target_primitives=chip_smoke.TARGET_PRIMITIVES,
                              densify_from=0, densify_until=2,
                              densification_interval=1,
                              opacity_reset_interval=100)
    full = pdensify.gather_stats(stats, cap)
    t, got = synced_ms(lambda: pdensify.sharded_densify_step(
        state.params, state.adam, stats, active, 1, dp, 2, active, 1.0,
        chunk, generator=torch.Generator().manual_seed(0)), dev)
    want = densify.densify_step(
        state.params, state.adam, full, active, 1, dp, 2, active, 1.0,
        chunk, generator=torch.Generator().manual_seed(0))
    same = got[2] == want[2] and all(torch.equal(a, b) for a, b in zip(
        [*got[0].fields().values(), *got[1].exp_avg.values(),
         *got[1].exp_avg_sq.values()],
        [*want[0].fields().values(), *want[1].exp_avg.values(),
         *want[1].exp_avg_sq.values()]))
    keys = densify.taming_sample_keys(densify.get_score(
        state.params, full, torch.arange(cap, device=dev) < active),
        densify.draw_uniform(cap, torch.Generator().manual_seed(0), dev))
    s = parallel.shard_len(cap, world)
    lo, hi = min(rank * s, cap), min(rank * s + s, cap)
    budget = int(got[2] - active) + chunk
    t_topk, _ = synced_ms(lambda: pdensify.sharded_topk_mask(
        keys[lo:hi], budget), dev, repeats=5)
    say(f"sharded densify over {world} ranks: active {active} -> {got[2]} "
        f"in {t:.1f} ms, bit-equal to densify_step on every rank: {same}; "
        f"32 bisection rounds over {hi - lo} keys a rank: {t_topk:.3f} ms "
        "(mean of 5)")
    check(same, "the sharded densify differs from densify_step")
    say("torch_parallel_scaling: ok")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
