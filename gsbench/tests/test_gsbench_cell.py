"""One tiny cell of each mix end to end on the CPU, and the result line."""
import json

import pytest

from gsbench import run

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("cell,trace", [("garden1m-refine", False),
                                        ("garden6m-serve", True)])
def test_tiny_cell_end_to_end(cell, trace, tiny):
    result, info, lines = run.run_cell(cell, 2 ** 31 + 11, 1.0, trace, "cpu",
                                       config_update=tiny)
    print(json.dumps({k: result[k] for k in KEYS}))
    assert KEYS <= set(result)
    assert list(result)[-1] == "check"
    # at this size Adam's noise on a small leaf can pass the step limit
    # set for the full-size cell; the verdict is every number within its
    # limit
    shown = result["check"]
    assert result["correct"] == all(v["value"] <= v["limit"]
                                    for v in shown.values())
    assert all(shown[k]["value"] <= shown[k]["limit"] for k in shown
               if k != "step_gap")
    assert result["attempted"] > 0
    names = {m["name"] for m in run.metrics_for(run.load_spec(), cell, trace)}
    assert set(result["metrics"]) <= names
    if trace:
        assert "breakdown" in result and "busy_s" in result["device"]
    else:
        assert "setup_s" in result["metrics"]
        assert len(result["metrics"]) >= 2
    assert lines and all(line.startswith("check ") for line in lines)
    json.dumps(result)


def test_same_seed_same_inputs(tiny):
    import torch
    from gsbench import scene
    a = scene.model(256, 512, 3, 7, 1.5, torch.device("cpu"),
                    json.loads((run.ROOT / "gsbench/configs/garden-1m.json")
                               .read_text())["model"])
    b = scene.model(256, 512, 3, 7, 1.5, torch.device("cpu"),
                    json.loads((run.ROOT / "gsbench/configs/garden-1m.json")
                               .read_text())["model"])
    assert all(torch.equal(a[k], b[k]) for k in a)
    t1 = scene.targets(2, 8, 16, 2 ** 31 + 5, torch.device("cpu"))
    t2 = scene.targets(2, 8, 16, 2 ** 31 + 5, torch.device("cpu"))
    assert torch.equal(t1, t2) and 0 <= float(t1.min()) <= float(t1.max()) <= 1


def test_no_card_means_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "garden1m-refine", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
