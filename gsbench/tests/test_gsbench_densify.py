"""The densify mix at the tiny sizes on the CPU: its window's slices and
periods, the reference's statistics and epoch boundary against the
port's, one cell end to end, and faults planted in the port."""
import json
import math
import types

import pytest
import torch

from gsbench import check, run as gsrun, scene
from gsbench.loops import densify as loop
from gsbench.loops import train
from gsbench.reference import densify as R

CELL = "garden1m-densify"


def test_slices_begin_the_next_epoch_after_an_epoch_end():
    gen = torch.Generator().manual_seed(3)
    run = types.SimpleNamespace(
        config={"train_views": 8}, traffic={"slice_share": 0.25},
        trainer=types.SimpleNamespace(generator=gen), epoch=4, pos=3,
        perm=list(range(8)))
    first = list(zip(range(3), train._slices(run)))
    assert [s[1] for _, s in first] == [[3, 4], [5, 6], [7]]
    assert first[-1][1][2] is True and run.epoch == 4
    # a second call, as the traced stretch makes after the window
    epoch, frames, end = next(train._slices(run))
    assert epoch == 5 and len(frames) == 2 and not end
    assert sorted(run.perm) == list(range(8))


def test_handover_is_the_ramp_after_the_last_event():
    conf = json.loads((gsrun.ROOT / "gsbench/configs/garden-1m.json")
                      .read_text())
    mix = json.loads((gsrun.ROOT / "gsbench/traffic/densify.json")
                     .read_text())
    # (1,000,000 - 150,016) / 38 x 11 + 150,016 = 396,065, whole chunks
    assert loop.handover(conf, mix) == 396032


def _model(active, capacity, seed):
    g = torch.Generator().manual_seed(seed)
    m = json.loads((gsrun.ROOT / "gsbench/configs/garden-1m.json")
                   .read_text())["model"]
    raw = scene.model(active, capacity, 3, seed, 1.5, torch.device("cpu"), m)
    moments = {f"{mm}.{k}": torch.rand(v.shape, generator=g) * 1e-3
               for mm in R.MOMENTS for k, v in raw.items()}
    n = capacity
    weight = torch.rand(n, generator=g)
    weight[torch.rand(n, generator=g) < 0.1] = 0.0
    frag = torch.floor(torch.rand(n, generator=g) * 50)
    err = torch.randn(n, generator=g) * 1e-3
    stats = {"visible_count": torch.floor(torch.rand(n, generator=g) * 8),
             "weight_sum": weight, "weight_sq_sum": weight ** 2,
             "err_sum": err * frag, "err_sq_sum": err * err * frag * 2,
             "frag_count": frag, "grad_norm_sum": torch.rand(n, generator=g)}
    return dict(raw, **moments), stats


def _port(leaves, stats, active):
    from litegs_torch.scene.gaussians import GaussianModel
    from litegs_torch.training import statistics
    from litegs_torch.training.optimizer import AdamState
    params = GaussianModel(**{k: leaves[k] for k in R.FIELDS})
    adam = AdamState(*[{k: leaves[f"{m}.{k}"] for k in R.FIELDS}
                       for m in R.MOMENTS])
    st = statistics.StatsState(**{k: v.to(torch.int32)
                                  if k == "visible_count" else v
                                  for k, v in stats.items()})
    return params, adam, st


def _leaves(params, adam):
    out = dict(params.fields())
    for m, d in zip(R.MOMENTS, adam):
        out.update({f"{m}.{k}": v for k, v in d.items()})
    return out


@pytest.mark.parametrize("epoch", [16, 20])
def test_densify_step_matches_the_port(epoch):
    """Split, clone, the 'weight' prune and, at epoch 20, the decay: the
    port's ``densify_step`` and the reference from the same statistics and
    draws agree on every live value."""
    from litegs_torch.config import DensifyParams
    from litegs_torch.training import densify as port
    active, cap, chunk, init, extent = 2048, 4096, 128, 1024, 0.5
    leaves, stats = _model(active, cap, 11)
    dp = DensifyParams(densification_interval=2, target_primitives=3000)
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    params, adam, act, did = port.densify_step(
        *_port(leaves, stats, active), active, epoch, dp, 41, init, extent,
        chunk, generator=gen)
    assert did
    d = {k: getattr(dp, k) for k in dp.__dataclass_fields__}
    uniform, normal = R.draws(state, cap, "cpu")
    ref, ref_act, appended = R.split_clone(
        dict(leaves), stats, active, epoch, d, 41, init, extent, chunk,
        uniform, normal)
    ref, ref_act, pruned = R.weight_prune(ref, stats, ref_act, active, chunk)
    if epoch % dp.opacity_reset_interval == 0:
        ref = R.decay(ref)
    assert appended > 0 and pruned > 0 and act == ref_act
    got = _leaves(params, adam)
    assert not check.disagreeing(got, ref, act).any()
    # the whole event (with its resort) runs from the same inputs
    ev = R.event(dict(leaves), stats, active, epoch, d, 41, init, extent,
                 chunk, state)
    assert ev["active"] == act and ev["appended"] == appended


def test_resort_matches_the_port_where_no_slot_is_parked():
    """With every slot live the port's ``spatial_refine`` and the
    reference's resort give the same order."""
    from litegs_torch.training import densify as port
    leaves, _ = _model(4096, 4096, 12)
    leaves["xyz"] = leaves["xyz"][:, torch.randperm(4096)]
    got = _leaves(*port.spatial_refine(*_port(leaves, _model(
        4096, 4096, 12)[1], 4096)[:2], 4096))
    ref = R.resort(leaves, 4096)
    assert not check.disagreeing(got, ref, 4096).any()
    assert not torch.equal(ref["xyz"], leaves["xyz"])


def _tiny_run(spec, config, mix, seconds=0.5, trace=False):
    return gsrun.run_cell(CELL, 2 ** 31 + 41, seconds, trace, "cpu",
                          spec=spec, config_update=config,
                          traffic_update=mix)


def _detail(info):
    return json.loads(next(line for line in info
                           if line.startswith("detail "))[len("detail "):])


def test_tiny_cell_end_to_end(densify_spec, tiny_densify):
    result, info, lines = _tiny_run(densify_spec, *tiny_densify, trace=True)
    assert result["attempted"] > 0
    periods = [line for line in info if line.startswith("window period")]
    assert len(periods) == 1 and len(periods[0].split()) >= 5
    shown = result["check"]
    # every number within its limit but the order after the resort:
    # the port takes the resort's box over parked slots (PERF.md, Open
    # questions), and the same replay with that box agrees
    assert all(v["value"] <= v["limit"] for k, v in shown.items()
               if k != "event_mismatch_share"), shown
    event = _detail(info)["event"]
    assert event["mismatch_share_box_over_capacity"] == 0.0
    assert event["appended"] > 0
    assert event["active_after"] == event["reference_active_after"]
    assert {"train_step_mfu_pct", "host_waits_per_view.train"} <= set(
        result["metrics"])
    assert "boundary_ms" not in result["metrics"]   # a device time


def _split_unshrunk(mp):
    from litegs_torch.training import densify as port
    mp.setattr(port, "math", types.SimpleNamespace(log=lambda x: 0.0,
                                                   inf=math.inf))


def _prune_skipped(mp):
    from litegs_torch.training import densify as port
    mp.setattr(port, "prune", lambda p, a, s, n, *args, **kw: (p, a, n))


def _weight_halved(mp):
    from litegs_torch.training import statistics
    orig = statistics.update_stats

    def halved(stats, *a, **k):
        new = orig(stats, *a, **k)
        return new._replace(weight_sum=stats.weight_sum
                            + (new.weight_sum - stats.weight_sum) / 2)
    mp.setattr(statistics, "update_stats", halved)


@pytest.mark.parametrize("fault,number", [
    (_split_unshrunk, "event_gap"), (_prune_skipped, "event_count_gap"),
    (_weight_halved, "stats_gap")])
def test_fault_fails_its_number(fault, number, densify_spec, tiny_densify,
                                monkeypatch):
    fault(monkeypatch)
    result, _, _ = _tiny_run(densify_spec, *tiny_densify)
    assert result["correct"] is False
    v = result["check"][number]
    assert v["value"] > v["limit"], result["check"]
