"""litegs_torch.challenge_train / challenge_eval against the root
3dgs_challenge_train.py / 3dgs_challenge_eval.py, on CPU.

* ``challenge_train.main`` passes 5,000 iterations and
  ``position_lr_max_steps`` 5,000 to the port's ``start`` (monkeypatched
  to record its arguments), with the other flags and the caller's device,
  and writes a timing JSON with the root script's keys.
* ``challenge_eval`` on ``tests/test_torch_io.py``'s disk scene (2
  views of 24x32) and a saved 256-point model runs the port's real
  ``example_metrics`` in process, reads its test line with the root
  script's pattern and merges SSIM and PSNR with the timing JSON that
  ``challenge_train`` wrote (``start`` monkeypatched) under the root
  script's keys.

The root scripts' keys are read from their sources with ``ast``; neither
is imported or run.
"""
import ast
import json
from pathlib import Path

from litegs_torch import challenge_eval, challenge_train, io, training
from litegs_torch.data import synthetic
from litegs_torch.scene import create_gaussians
from test_torch_io import make_disk_dataset

ROOT = Path(__file__).resolve().parent.parent


def root_keys():
    """(keys of the timing JSON that 3dgs_challenge_train.py dumps, keys
    that 3dgs_challenge_eval.py stores into its result)."""
    train = ast.parse((ROOT / "3dgs_challenge_train.py").read_text())
    timing = [k.value for node in ast.walk(train)
              if isinstance(node, ast.Call)
              and ast.unparse(node.func) == "json.dump"
              for k in node.args[0].keys]
    ev = ast.parse((ROOT / "3dgs_challenge_eval.py").read_text())
    stored = [node.slice.value for node in ast.walk(ev)
              if isinstance(node, ast.Subscript)
              and isinstance(node.ctx, ast.Store)
              and ast.unparse(node.value) == "result"]
    assert timing and stored
    return timing, stored


def test_challenge_train_overrides_reach_start(tmp_path, monkeypatch,
                                               capsys):
    calls = []
    monkeypatch.setattr(training, "start",
                        lambda *groups, **kw: calls.append((groups, kw)))
    timing = tmp_path / "out" / "train_time.json"
    got = challenge_train.main(["-s", "/data/scene", "-m", str(tmp_path),
                                "--sh_degree", "1", "--iterations", "7",
                                "--timing_json", str(timing)],
                               device="cpu")
    (lp, op, pp, dp), kw = calls[0]
    assert len(calls) == 1 and kw == {"device": "cpu"}
    assert op.iterations == 5000 and op.position_lr_max_steps == 5000
    assert lp.sh_degree == 1 and lp.source_path == "/data/scene"
    saved = json.loads(timing.read_text())
    assert saved == got
    assert list(saved) == root_keys()[0]
    assert saved["scene"] == "/data/scene" and saved["train_time_s"] >= 0
    assert capsys.readouterr().out.startswith("challenge train: ")


def test_challenge_eval_reads_the_port_metrics_line(tmp_path, monkeypatch,
                                                    capsys):
    scene = make_disk_dataset(str(tmp_path / "scene"), n_frames=2,
                              n_points=100, img_h=24, img_w=32)
    model = tmp_path / "model"
    xyz, rgb = synthetic.make_gaussian_cloud(256, seed=0)
    ply = model / "point_cloud" / "finish" / "point_cloud.ply"
    ply.parent.mkdir(parents=True)
    io.save_ply(str(ply), create_gaussians(xyz, rgb, 1, device="cpu"))
    timing = str(tmp_path / "train_time.json")
    monkeypatch.setattr(training, "start", lambda *groups, **kw: None)
    challenge_train.main(["-s", scene, "-m", str(model), "--timing_json",
                          timing], device="cpu")
    capsys.readouterr()
    out_json = tmp_path / "challenge.json"
    got = challenge_eval.main(["-s", scene, "-m", str(model),
                               "--timing_json", timing, "--output_json",
                               str(out_json), "--raster_backend", "torch"],
                              device="cpu")
    printed = capsys.readouterr().out
    timing_keys, stored = root_keys()
    assert list(got) == timing_keys + stored
    assert json.loads(out_json.read_text()) == got
    assert printed.rstrip().splitlines()[-1] == json.dumps(got)
    # example_metrics' own test line, echoed; the train split skipped
    line = next(ln for ln in printed.splitlines() if ln.startswith("test: "))
    assert line.startswith(f"test: SSIM {got['ssim']:.4f}  PSNR "
                           f"{got['psnr']:.2f}  LPIPS ")
    assert not any(ln.startswith("train: ") for ln in printed.splitlines())
    assert got["scene"] == scene
