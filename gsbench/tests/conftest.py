"""Shared fixtures of the benchmark's tests.  They run on the CPU at a
tiny size with the program's plain path; tests marked ``cuda`` need a
card and skip without one."""
import pytest

from gsbench import run as gsrun

# a tiny stand-in for a configuration's sizes
TINY = {"img_h": 48, "img_w": 64, "train_views": 8,
        "target_primitives": 20000, "active_primitives": 20096}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.fixture
def tiny():
    return dict(TINY)


@pytest.fixture
def tiny_densify():
    """(config update, traffic update) of a tiny densify cell: the tiny
    sizes with garden-1m's 62 epochs (496 iterations of 8 views), a budget
    of 20,000 grown from 4,096 points, and 2 traced views."""
    config = dict(TINY, optimization={"iterations": 496,
                                      "position_lr_final": 1.6e-05,
                                      "position_lr_max_steps": 496},
                  densify={"densification_interval": 2,
                           "target_primitives": 20000})
    return config, {"init_primitives": 4096, "trace_views": 2}


# the densify cell's entries where BENCHMARK.json does not hold them
DENSIFY = {"name": "garden1m-densify", "config": "garden-1m",
           "traffic": "densify", "chips": 1, "why": "a test"}
BOUNDARY = {"name": "boundary_ms", "unit": "ms", "better": "lower",
            "source": "device_trace", "layer": "a test",
            "moves": "train_views_s", "workloads": [DENSIFY["name"]]}


@pytest.fixture
def densify_spec():
    """BENCHMARK.json with the densify cell among its workloads, in the
    training metrics' cells, and its ``boundary_ms``."""
    spec = gsrun.load_spec()
    cell = DENSIFY["name"]
    if cell not in {w["name"] for w in spec["workloads"]}:
        spec["workloads"].append(dict(DENSIFY))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "train_views_s" in (m["name"], m.get("moves")):
                m["workloads"].append(cell)
        spec["per_layer"].append(dict(BOUNDARY))
    return spec
