"""A configuration, a traffic mix, a cell and a metric come in as new
files and new entries of BENCHMARK.json, with no edit to a file that is
there."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _copy(tmp_path, tiny):
    """A copy of the benchmark beside BENCHMARK.json's entries, with a
    tiny configuration of its own: (package, spec)."""
    shutil.copytree(ROOT / "gsbench", tmp_path / "gsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    pkg = tmp_path / "gsbench"
    conf = json.loads((pkg / "configs" / "garden-1m.json").read_text())
    conf.update(tiny, name="tiny-garden")
    (pkg / "configs" / "tiny-garden.json").write_text(json.dumps(conf))
    spec["configs"].append({"name": "tiny-garden", "source": "https://x.org",
                            "file": "gsbench/configs/tiny-garden.json",
                            "reduced": [], "why": "a test"})
    return pkg, spec


def _run(tmp_path, cell):
    code = ("import json, sys; sys.path.append(sys.argv[1]);"
            "from gsbench import run;"
            f"print(json.dumps(run.run_cell({cell!r}, 5, 0.5, False, "
            "'cpu')[0]))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_new_files_are_picked_up(tmp_path, tiny):
    pkg, spec = _copy(tmp_path, tiny)
    mix = json.loads((pkg / "traffic" / "refine.json").read_text())
    mix["trace_views"] = 2
    (pkg / "traffic" / "refine-short.json").write_text(json.dumps(mix))
    lim = json.loads((pkg / "limits" / "garden1m-refine.json").read_text())
    lim["limits"]["step_gap"] = 1e-3   # Adam's noise at this tiny size
    (pkg / "limits" / "tiny.refine.json").write_text(json.dumps(lim))
    (pkg / "metrics" / "throwaway_views.py").write_text(
        "def read(run):\n    return run.window['views']\n")
    spec["workloads"].append({"name": "tiny.refine", "config": "tiny-garden",
                              "traffic": "refine-short", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_views_s":
            m["workloads"].append("tiny.refine")
    spec["end_to_end"].append({"name": "throwaway_views", "unit": "views",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["tiny.refine"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    res = _run(tmp_path, "tiny.refine")
    assert res["correct"] is True
    assert res["metrics"]["throwaway_views"]["value"] == res["attempted"]
    assert {"train_views_s", "setup_s"} <= set(res["metrics"])


def test_a_loop_module_of_a_known_kind(tmp_path, tiny):
    """A new loop module (``loops/<name>.py``) whose mix says ``"kind":
    "train"`` gets the training readers: ``train_views_s`` through new
    files and entries alone."""
    pkg, spec = _copy(tmp_path, tiny)
    (pkg / "loops" / "train_again.py").write_text(
        '"""The training loop under a name of its own."""\n'
        "from gsbench.loops.train import (check, release, setup, traced,"
        "  # noqa: F401\n    window, work)\n")
    mix = json.loads((pkg / "traffic" / "refine.json").read_text())
    mix.update(loop="train_again", kind="train")
    (pkg / "traffic" / "refine-again.json").write_text(json.dumps(mix))
    lim = json.loads((pkg / "limits" / "garden1m-refine.json").read_text())
    lim["limits"]["step_gap"] = 1e-3   # Adam's noise at this tiny size
    (pkg / "limits" / "tiny.again.json").write_text(json.dumps(lim))
    spec["workloads"].append({"name": "tiny.again", "config": "tiny-garden",
                              "traffic": "refine-again", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_views_s":
            m["workloads"].append("tiny.again")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    res = _run(tmp_path, "tiny.again")
    assert res["correct"] is True
    assert set(res["metrics"]) == {"train_views_s", "setup_s"}
    assert res["metrics"]["train_views_s"]["value"] > 0
