"""The port's evaluation harness against the root scripts, on CPU.

``litegs_torch.full_eval`` (and its aggressive preset),
``litegs_torch.print_results`` and ``litegs_torch.scale_curve`` are copies
of the root ``full_eval.py`` and ``scripts/{full_eval_aggressive,
print_results,scale_curve}.py`` that drive the port's command line
(``python -m litegs_torch.example_train`` / ``example_metrics``).  The
root scripts import no JAX.

* ``--dry_run`` prints the root script's commands with the port's
  modules, over the same budgets, image folders and iteration rule;
* ``print_results`` prints byte-equal tables (markdown, ``--latex``,
  ``--conf``);
* ``full_eval.METRIC_RE`` and ``scale_curve.parse_row`` read the lines the
  port's ``example_metrics`` prints, with an LPIPS number and with n/a.
"""
import importlib.util
import os
import subprocess
import sys

import pytest

import full_eval as root_full_eval
from litegs_torch import example_metrics, example_train
from litegs_torch import full_eval, print_results, scale_curve
from test_torch_io import make_disk_dataset
from test_torch_lpips import write_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CMDS = (("example_train.py", "-m litegs_torch.example_train"),
             ("example_metrics.py", "-m litegs_torch.example_metrics"))


def _portable(text: str) -> str:
    for old, new in PORT_CMDS:
        text = text.replace(old, new)
    return text


def test_tables_equal_the_root_script():
    assert full_eval.SCENE_BUDGETS == root_full_eval.SCENE_BUDGETS
    for name in ("OUTDOOR", "MIPNERF360", "TANKS", "DEEPBLEND"):
        assert getattr(full_eval, name) == getattr(root_full_eval, name)
    assert full_eval.TIME_RE.pattern == root_full_eval.TIME_RE.pattern
    assert full_eval.METRIC_RE.pattern == root_full_eval.METRIC_RE.pattern
    assert scale_curve.BUDGETS == [300_000, 500_000, 1_000_000, 2_000_000,
                                   4_000_000, 6_000_000]


@pytest.mark.parametrize("extra", [[], ["--iterations", "7000"],
                                   ["--primitives", "123456", "--",
                                    "--sh_degree", "1"]])
def test_dry_run_prints_the_port_commands(capsys, extra):
    argv = ["--mipnerf360", "/d/m360", "--tanksandtemples", "/d/tt",
            "--deepblending", "/d/db", "--output_path", "/o", "--dry_run",
            *extra]
    root_full_eval.main(argv)
    want = capsys.readouterr().out
    full_eval.main(argv)
    got = capsys.readouterr().out
    assert "-m litegs_torch.example_train" in got
    assert "example_train.py" not in got
    assert got == _portable(want)
    if not extra:      # Tanks&Temples takes 40k iterations by default
        assert "/d/tt/truck -m /o/truck -i images --eval --iterations " \
               "40000 --target_primitives 2500000" in got


def test_aggressive_preset_equals_the_root_script(tmp_path):
    argv = ["--mipnerf360", "/d/m360", "--output_path", str(tmp_path),
            "--dry_run"]
    root = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "full_eval_aggressive.py"), *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True)
    port = subprocess.run(
        [sys.executable, "-m", "litegs_torch.full_eval_aggressive", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    assert "--position_lr_final 0.000016" in port.stdout
    assert port.stdout == _portable(root.stdout)


def _root_print_results():
    spec = importlib.util.spec_from_file_location(
        "root_print_results", os.path.join(ROOT, "scripts",
                                           "print_results.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flags", [[], ["--latex"], ["--conf"],
                                   ["--latex", "--conf"]])
def test_print_results_byte_equal(tmp_path, capsys, flags):
    cols = "scene,time_s,test_ssim,test_psnr,test_lpips,primitives\n"
    rows = [("bicycle", "51.2", "0.771", "25.31", "None", "6000000"),
            ("garden", "48.0", "0.861", "27.42", "0.121", "6000000"),
            ("room", "", "0.911", "31.9", "", "1500000")]
    paths = []
    for rep in range(3):
        p = tmp_path / f"run{rep}.csv"
        lines = [",".join([r[0], *(str(float(v) + 0.1 * rep) if v not in
                                   ("", "None") else v for v in r[1:5]),
                           r[5]]) for r in rows]
        p.write_text(cols + "\n".join(lines) + "\n")
        paths.append(str(p))
    _root_print_results().main(paths + flags)
    want = capsys.readouterr().out
    print_results.main(paths + flags)
    got = capsys.readouterr().out
    assert got == want
    assert "n/a" in got and "bicycle" in got


def test_metric_lines_of_the_port_parse(tmp_path, capsys, monkeypatch):
    scene = make_disk_dataset(str(tmp_path / "scene"))
    model = str(tmp_path / "model")
    example_train.main(["-s", scene, "-m", model, "--eval", "--iterations",
                        "10", "--sh_degree", "1", "--raster_backend",
                        "torch"], device="cpu")
    capsys.readouterr()
    argv = ["-s", scene, "-m", model, "--raster_backend", "torch"]
    example_metrics.main(argv, device="cpu")
    plain = capsys.readouterr().out
    monkeypatch.setenv("LPIPS_WEIGHTS",
                       write_weights(tmp_path / "lpips_vgg.npz"))
    example_metrics.main(argv, device="cpu")
    weighted = capsys.readouterr().out
    for out, lpips_is_number in ((plain, False), (weighted, True)):
        found = full_eval.METRIC_RE.findall(out)
        assert [f[0] for f in found] == ["train", "test"], out
        for split, ssim, psnr, lpips in found:
            assert 0.0 < float(ssim) <= 1.0 and float(psnr) > 10.0
            assert (lpips != "n/a") == lpips_is_number, out
            if lpips_is_number:
                assert float(lpips) > 0.0
        row = scale_curve.parse_row(1000, out)
        assert row["primitives"] == 1000
        assert row["psnr"] == float(found[1][2])
        assert row["ssim"] == float(found[1][1])
    assert scale_curve.parse_row(1, "no metrics here") is None
