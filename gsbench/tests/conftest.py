"""Shared fixtures of the benchmark's tests.  They run on the CPU at a
tiny size with the program's plain path; tests marked ``cuda`` need a
card and skip without one."""
import pytest

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
