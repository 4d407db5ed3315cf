"""The port's convergence checks and ablation sweeps against the JAX
scripts, on CPU.

``litegs_torch.{synthetic_convergence,convergence_parallel,
ablations_densify,ablations_culling}`` are the counterparts of
``scripts/{synthetic_convergence,convergence_parallel,ablations_densify,
ablations_culling}.py``.  The JAX scripts are loaded from their paths and
run with recorders in place of ``make_task``, ``Trainer``,
``ParallelTrainer`` and ``subprocess.run``, so nothing trains in JAX; the
port's modules run with the same recorders, and what both configure is
compared field by field:

* ``make_task``'s arguments, the four config groups (the JAX backend names
  mapped to the port's: pallas -> cuda, jnp -> torch), the spatial
  learning-rate scale and the padded model size, for the JAX script's
  default command, CONVERGENCE_r5.md's and ``--densify_mode official``;
* the data-parallel runs' labels, lr scales and iterations at D = 8 (the
  JAX script's virtual mesh; the port's world size is faked to 8);
* the ablations' commands, ``example_train.py`` mapped to ``-m
  litegs_torch.example_train`` and ``jnp`` to ``torch``, extra flags
  included.

Then a tiny real CPU run of ``synthetic_convergence``, one gloo run of
``convergence_parallel`` at D = 2, an ablation that goes on past a failed
variant, and every entry point refusing the absent card by default.
"""
import dataclasses
import importlib.util
import math
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import litegs_tpu.data.synthetic_train as jst
import litegs_tpu.parallel.trainer as jptr
import litegs_tpu.training.trainer as jtr

from litegs_torch import ablations_culling, ablations_densify
from litegs_torch import convergence_parallel, example_train
from litegs_torch import parallel as tpar
from litegs_torch import synthetic_convergence
from litegs_torch.data import synthetic_train as tst

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = {"pallas": "cuda", "jnp": "torch"}
R5 = ["--points", "1200000", "--init_points", "150000", "--color_freq",
      "3.0", "--target", "1000000", "--frames", "10", "--sh_degree", "3",
      "--tile", "32x24", "--static_caps", "--iters", "6000"]
CONVERGENCE_ARGV = {
    "default": [],
    "r5": R5,
    "official": ["--densify_mode", "official"],
}
GROUPS = ("lp", "op", "pp", "dp")


class Stop(Exception):
    """Raised by a recorder to end a run once it is recorded."""


def load_script(name: str, monkeypatch):
    """scripts/<name>.py as a fresh module; its sys.path insert and its
    environment writes are undone after the test."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    for var in ("JAX_PLATFORMS", "XLA_FLAGS"):
        monkeypatch.setenv(var, os.environ.get(var, ""))
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def task_recorder(calls: list):
    def make_task(**kw):
        calls.append(kw)
        return None, None, None
    return make_task


def groups(kw: dict) -> dict:
    """The config groups of a trainer's keyword arguments as dicts, the
    raster backend in the port's names."""
    out = {g: dataclasses.asdict(kw[g]) for g in GROUPS}
    be = out["pp"]["raster_backend"]
    out["pp"]["raster_backend"] = BACKENDS.get(be, be)
    out["pp"]["tile_size"] = tuple(out["pp"]["tile_size"])
    return out


@pytest.mark.parametrize("name", list(CONVERGENCE_ARGV))
def test_synthetic_convergence_configures_as_jax(name, monkeypatch):
    argv = CONVERGENCE_ARGV[name] + ["--backend", "jnp"]
    seen = {}
    for pkg, mod_tasks, mod_trainer in (
            ("jax", jst, jtr), ("torch", tst, synthetic_convergence)):
        tasks, trainers = [], []

        def trainer(**kw):
            trainers.append(kw)
            raise Stop

        monkeypatch.setattr(mod_tasks, "make_task", task_recorder(tasks))
        monkeypatch.setattr(mod_trainer, "Trainer", trainer)
        with pytest.raises(Stop):
            if pkg == "jax":
                load_script("synthetic_convergence", monkeypatch).main(argv)
            else:
                synthetic_convergence.main(argv, device="cpu")
        (task,), (kw,) = tasks, trainers
        seen[pkg] = (task, kw)
    (jtask, jkw), (ttask, tkw) = seen["jax"], seen["torch"]
    assert (jtask.pop("backend"), jtask.pop("interpret")) == ("jnp", False)
    assert str(ttask.pop("device")) == "cpu"
    assert ttask == jtask
    assert groups(tkw) == groups(jkw)
    assert tkw["spatial_lr_scale"] == jkw["spatial_lr_scale"] == 4.0
    assert (tkw["caps"].primitive_capacity
            == jkw["caps"].primitive_capacity)
    if name == "r5":
        assert ttask["init_points"] == 150000 and ttask["color_freq"] == 3.0
        assert tkw["pp"].tile_size == (32, 24)
        assert tkw["dp"].densify_until == 420


class FakeTrainer:
    """Records its keyword arguments; its train returns a history of one
    epoch."""

    def __init__(self, calls, **kw):
        calls.append(kw)
        self.total_epochs, self.n_frames = 1, 8

    def train(self, init_xyz, init_color, verbose=True):
        return types.SimpleNamespace(step=0), None, [{"psnr": 30.0}]


def test_convergence_parallel_runs_as_jax(monkeypatch, tmp_path):
    runs = {}
    for pkg in ("jax", "torch"):
        tasks, calls = [], []
        fake = lambda **kw: FakeTrainer(calls, **kw)  # noqa: E731
        mods = (jst, jtr, jptr) if pkg == "jax" else (
            tst, convergence_parallel, convergence_parallel)
        monkeypatch.setattr(mods[0], "make_task", task_recorder(tasks))
        monkeypatch.setattr(mods[1], "Trainer", fake)
        monkeypatch.setattr(mods[2], "ParallelTrainer", fake)
        if pkg == "jax":
            mod = load_script("convergence_parallel", monkeypatch)
            written = {}

            class Capture:
                def __init__(self, path, mode):
                    written[os.path.basename(path)] = self
                    self.text = ""

                def __enter__(self):
                    return self

                def __exit__(self, *exc):
                    return False

                def write(self, s):
                    self.text += s

            mod.open = Capture        # CONVERGENCE_r2.md stays untouched
            mod.main()
            rows = re.findall(r"^\| (sequential|parallel_\w+) \|",
                              written["CONVERGENCE_r2.md"].text, re.M)
        else:
            monkeypatch.setattr(tpar, "world", lambda: (8, 0))
            monkeypatch.setattr(tpar, "shard_camera_batch", lambda b: b)
            out = tmp_path / "table.md"
            rows = list(convergence_parallel.main(
                ["--output", str(out)], device="cpu"))
            assert len(re.findall(r"^\| parallel_|^\| sequential",
                                  out.read_text(), re.M)) == 4
        (task,) = tasks
        runs[pkg] = (task, calls, rows)
    (jtask, jcalls, jrows), (ttask, tcalls, trows) = runs["jax"], runs["torch"]
    assert str(ttask.pop("device")) == "cpu"
    assert ttask == jtask == dict(n_points=500, n_frames=8, img_h=48,
                                  img_w=64, sh_degree=1, seed=3)
    assert trows == jrows == ["sequential", "parallel_equal_images_lr1",
                              "parallel_equal_images_lrsqrtD",
                              "parallel_equal_updates_lr1"]
    assert len(tcalls) == len(jcalls) == 4
    for t, j in zip(tcalls, jcalls):
        assert groups(t) == groups(j)
        assert t["op"].iterations == j["op"].iterations
        assert t["spatial_lr_scale"] == j["spatial_lr_scale"] == 4.4
        assert dataclasses.asdict(t["caps"]) == dataclasses.asdict(j["caps"])
        assert t.get("lr_scale", 1.0) == pytest.approx(j.get("lr_scale",
                                                             1.0), rel=1e-12)
    assert [j["op"].iterations for j in jcalls] == [192, 192, 192, 192 * 8]
    assert [j["n_devices"] for j in jcalls[1:]] == [8, 8, 8]


ABLATIONS = {"densify": ablations_densify, "culling": ablations_culling}
ABLATION_ARGV = {
    "defaults": ["-s", "/d/scene"],
    "extra": ["-s", "/d/scene", "-m", "/o", "--iterations", "64",
              "--test_epochs", "3,7", "--sh_degree", "1"],
}


def run_recorder(cmds: list, codes=()):
    """subprocess.run's stand-in: records each command, returns the next of
    ``codes`` (0 past them)."""
    codes = list(codes)

    def run(cmd, check=False, **kw):
        cmds.append(list(cmd))
        return subprocess.CompletedProcess(cmd, codes.pop(0) if codes
                                           else 0)
    return run


def port_command(cmd: list) -> list:
    """A JAX ablation command in the port's names."""
    assert cmd[:2] == [sys.executable, "example_train.py"]
    return ([sys.executable, "-m", "litegs_torch.example_train"]
            + ["torch" if a == "jnp" else a for a in cmd[2:]])


@pytest.mark.parametrize("argv", list(ABLATION_ARGV))
@pytest.mark.parametrize("which", list(ABLATIONS))
def test_ablation_commands_match_jax(which, argv, monkeypatch):
    cmds = {"jax": [], "torch": []}
    monkeypatch.setattr(subprocess, "run", run_recorder(cmds["jax"]))
    load_script(f"ablations_{which}", monkeypatch).main(ABLATION_ARGV[argv])
    monkeypatch.setattr(subprocess, "run", run_recorder(cmds["torch"]))
    # the default device is the card: commands only, nothing runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    codes = ABLATIONS[which].main(ABLATION_ARGV[argv])
    assert cmds["torch"] == [port_command(c) for c in cmds["jax"]]
    assert codes == {name: 0 for name in ABLATIONS[which].VARIANTS}
    assert len(codes) == (2 if which == "densify" else 3)


def test_ablation_goes_on_after_a_failed_variant(monkeypatch, capsys):
    cmds = []
    monkeypatch.setattr(subprocess, "run", run_recorder(cmds, [3, 0, 7]))
    codes = ablations_culling.main(["-s", "scene", "-m", "out"],
                                   device="cpu")
    assert codes == {"clustered": 3, "no_culling": 0, "script_raster": 7}
    assert [line for line in capsys.readouterr().out.splitlines()] == [
        f"=== {name} ===" for name in codes]
    assert all(c[:3] == example_train.command("cpu") for c in cmds)
    assert [c[c.index("-m") + 1] for c in cmds] == [
        os.path.join("out", name) for name in codes]
    assert cmds[2][-2:] == ["--raster_backend", "torch"]


def test_synthetic_convergence_on_the_cpu(capsys):
    hist = synthetic_convergence.main(
        ["--points", "200", "--frames", "2", "--height", "16", "--width",
         "24", "--iters", "8", "--backend", "torch"], device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"scene built in \d+\.\ds", lines[0])
    epoch_re = (r"\[epoch +(\d+)\] psnr=\d+\.\d\d loss=(\d+\.\d{4}) "
                r"active=(\d+) \(\d+s\)")
    logged = [re.fullmatch(epoch_re, ln) for ln in lines[1:-1]]
    assert all(logged) and [int(m[1]) for m in logged] == [0, 3]
    assert re.fullmatch(r"final train PSNR \d+\.\d\d dB; 8 iters in \d+s = "
                        r"\d+\.\d\d it/s; overflows=0", lines[-1])
    assert [h["epoch"] for h in hist] == [0, 1, 2, 3]
    assert all(math.isfinite(h["loss"]) and h["loss"] > 0 for h in hist)
    assert float(logged[-1][2]) == pytest.approx(hist[-1]["loss"], abs=1e-4)
    assert hist[-1]["psnr"] > hist[0]["psnr"]


_CHILD = r'''
import os, sys
rank, work = int(sys.argv[1]), sys.argv[2]
sys.path.insert(0, os.getcwd())
import torch
torch.set_num_threads(1)
from litegs_torch import convergence_parallel, parallel
assert parallel.initialize_distributed(f"file://{work}/store", 2, rank,
                                       device="cpu", timeout=300) == 2
convergence_parallel.main(["--output", os.path.join(work, "table.md")],
                          device="cpu")
'''


def test_convergence_parallel_two_ranks_gloo(tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "CONV_ITERS": "8"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(r), str(tmp_path)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    rows = re.findall(r"^\| (\w+) \| ([\d.]+) \| (\d+) \| (\d+) \| "
                      r"([\d.]+) \|$", (tmp_path / "table.md").read_text(),
                      re.M)
    # 8 frames: an epoch is 8 sequential updates or 4 of two views
    assert [r[:4] for r in rows] == [
        ("sequential", "1", "8", "8"),
        ("parallel_equal_images_lr1", "1", "8", "4"),
        ("parallel_equal_images_lrsqrtD", f"{math.sqrt(2):.4g}", "8", "4"),
        ("parallel_equal_updates_lr1", "1", "16", "8")]
    assert all(np.isfinite(float(r[4])) and float(r[4]) > 5 for r in rows)
    assert "--nproc_per_node 2" in (tmp_path / "table.md").read_text()


@pytest.mark.parametrize("entry", [
    lambda: synthetic_convergence.main([]),
    lambda: convergence_parallel.main(["--output", os.devnull]),
    lambda: ablations_densify.main(["-s", "scene"]),
    lambda: ablations_culling.main(["-s", "scene"]),
], ids=["synthetic_convergence", "convergence_parallel",
        "ablations_densify", "ablations_culling"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.setattr(subprocess, "run", run_recorder([]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
