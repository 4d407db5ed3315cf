from __future__ import annotations

import torch

from . import math, profiling, sh  # noqa: F401


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.

    The port runs on the card: the CPU is used only when the caller asks
    for it by name.  A CUDA device without a card raises; nothing falls
    back to the CPU quietly.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev
