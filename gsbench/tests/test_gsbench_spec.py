"""BENCHMARK.json against the format's characters, keys and limits, and
every file a name in it stands for."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "gsbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= len(SPEC["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in SPEC["paths"])
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_text(w) and not w.startswith("/") for w in SPEC["command"])


@pytest.mark.parametrize("group,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"})])
def test_entries_have_just_their_keys(group, keys):
    assert 1 <= len(SPEC[group]) <= 24
    for e in SPEC[group]:
        assert set(e) == keys, e
        assert NAME.match(e["name"]) and _text(e["why"])


def test_metric_names_units_and_keys():
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _text(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_names_stand_for_files():
    cells = {w["name"] for w in SPEC["workloads"]}
    configs = {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and c["file"].startswith("gsbench/")
        assert c["source"].startswith("https://")
        data = json.loads(f.read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    pairs = set()
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (PKG / "traffic" / f"{w['traffic']}.json").is_file()
        assert (PKG / "limits" / f"{w['name']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(SPEC["workloads"])
    for m in METRICS:
        assert (PKG / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
    assert {c for w in SPEC["workloads"] for c in [w["config"]]} == configs


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in SPEC["workloads"]:
        name = w["name"]
        e2e = [m["name"] for m in SPEC["end_to_end"]
               if name in m.get("workloads", [name])]
        layer = [m for m in SPEC["per_layer"]
                 if name in m.get("workloads", [name])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:
            assert m["moves"] in e2e


def test_four_chip_cells_within_their_share():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_time_budget_fits_every_later_check():
    per_run = SPEC["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200
