"""Configuration system for litegs_torch.

The same four parameter groups, defaults and command-line flags as
``litegs_tpu/config.py``, so a user of either package finds identical
knobs.  The groups are frozen dataclasses.

Differences from the JAX package:

* ``PipelineParams.raster_backend`` is ``'cuda'`` (the hand-written Hopper
  kernels, the default) or ``'torch'`` (the plain PyTorch version).
* The TPU-only module constants ``RASTER_BLOCK`` and ``RASTER_MXU_MODE`` are
  not ported: they size the Pallas kernels' 128-entry blocks and choose
  which blend stages run on the TPU's matrix unit, and have no meaning
  here.  ``BINNING_STREAM`` is ported as a module constant and is on by
  default; it reads no environment variable.
* The render path sizes its buffers exactly from the data, so it takes no
  :class:`CapacityParams`; the training path uses only its
  ``primitive_capacity``, the padded model size (``auto_capacity``).
"""
from __future__ import annotations

import dataclasses
from argparse import ArgumentParser

# Binning's streaming route: a bool, as in the JAX package.  True builds
# the table by the 'keys' route of ops/binning.build_tile_table (the
# reference's count -> scan -> duplicate-with-keys -> sort -> ranges,
# binning.cu:33-110: the kernels of ops/binning_cuda on CUDA tensors, their
# plain version on CPU tensors); False by the two expansions through
# torch.repeat_interleave and a row gather.  Read at each call of
# build_tile_table, whose ``stream`` argument overrides it (and reaches the
# stream_gather kernels' routes by name).
BINNING_STREAM = True


@dataclasses.dataclass(frozen=True)
class ModelParams:
    """Scene/model-level options (reference: litegs/arguments.py:58-67)."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = False
    _shorthand = {"source_path": "-s", "model_path": "-m", "images": "-i",
                  "resolution": "-r", "white_background": "-w"}


@dataclasses.dataclass(frozen=True)
class PipelineParams:
    """Render pipeline options (reference: litegs/arguments.py:69-78)."""

    cluster_size: int = 128
    tile_size: tuple[int, int] = (8, 16)
    sparse_grad: bool = True
    device_preload: bool = True
    enable_transmitance: bool = False
    enable_depth: bool = False
    input_color_type: str = "sh"  # 'rgb' or 'sh'
    # 'cuda' = hand-written Hopper kernels; 'torch' = plain PyTorch path
    raster_backend: str = "cuda"
    adaptive_capacity: bool = True
    capacity_margin: float = 1.05
    disable_culling: bool = False
    parallel: str = "auto"
    batch_views: int = 1
    grad_allreduce_dtype: str = "bf16"


@dataclasses.dataclass(frozen=True)
class OptimizationParams:
    """Optimizer options (reference: litegs/arguments.py:80-93)."""

    iterations: int = 30000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_max_steps: int = 30000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.025
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    lambda_dssim: float = 0.2
    reg_weight: float = 0.0
    learnable_viewproj: bool = False
    pose_lr: float = 1e-4


@dataclasses.dataclass(frozen=True)
class DensifyParams:
    """Densification options (reference: litegs/arguments.py:95-112)."""

    densification_interval: int = 5
    densify_from: int = 3
    densify_until: int = -1
    densify_mode: str = "taming"
    opacity_reset_interval: int = 10
    opacity_reset_mode: str = "decay"  # 'decay' | 'reset'
    prune_mode: str = "weight"         # 'weight' | 'threshold'
    target_primitives: int = 1000000
    densify_grad_threshold: float = 0.00015
    opacity_threshold: float = 0.005
    screen_size_threshold: int = 128
    percent_dense: float = 0.01


@dataclasses.dataclass(frozen=True)
class CapacityParams:
    """Fixed capacities for the training step (not used by rendering).

    Attributes:
      primitive_capacity: max primitives N_cap.
      visible_capacity:   max visible primitives per view M_cap.
      row_capacity:       max (point, tile-row) pairs per view.
      entry_capacity:     max (point, tile) pairs per view.
    """

    primitive_capacity: int = 0
    visible_capacity: int = 0
    row_capacity: int = 0
    entry_capacity: int = 0


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def auto_capacity(target_primitives: int) -> CapacityParams:
    """The padded model size for a primitive budget: the
    ``primitive_capacity`` of ``litegs_tpu.config.auto_capacity``, so the
    padded size and the densify budget equal the JAX package's.  The
    per-view capacities it also derives size buffers the port does not
    have."""
    return CapacityParams(
        primitive_capacity=round_up(int(target_primitives * 1.08), 128 * 128))


def get_default_arg():
    """Default bundle (reference: litegs/config/__init__.py:3-8)."""
    return (ModelParams(), OptimizationParams(), PipelineParams(),
            DensifyParams())


def get_quality_arg():
    """Quality bundle (reference: litegs/config/__init__.py:10-16)."""
    dp = dataclasses.replace(DensifyParams(), target_primitives=4000000)
    return ModelParams(), OptimizationParams(), PipelineParams(), dp


_GROUPS = (ModelParams, OptimizationParams, PipelineParams, DensifyParams)


def add_cmdline_args(parser: ArgumentParser) -> None:
    seen = set()
    for cls in _GROUPS:
        group = parser.add_argument_group(cls.__name__)
        shorthand = getattr(cls, "_shorthand", {})
        for f in dataclasses.fields(cls):
            if f.name in seen:
                continue
            seen.add(f.name)
            names = ["--" + f.name]
            if f.name in shorthand:
                names.append(shorthand[f.name])
            if f.type in ("bool", bool):
                group.add_argument(*names, default=f.default,
                                   action="store_true")
            elif f.type in ("tuple[int, int]",):
                group.add_argument(*names, default=f.default, type=int,
                                   nargs=2)
            else:
                ty = {"int": int, "float": float, "str": str}.get(
                    f.type, type(f.default))
                group.add_argument(*names, default=f.default, type=ty)


def extract_groups(args) -> tuple[ModelParams, OptimizationParams,
                                  PipelineParams, DensifyParams]:
    out = []
    for cls in _GROUPS:
        kwargs = {}
        for f in dataclasses.fields(cls):
            if hasattr(args, f.name):
                v = getattr(args, f.name)
                if f.name == "tile_size" and isinstance(v, list):
                    v = tuple(v)
                kwargs[f.name] = v
        out.append(cls(**kwargs))
    return tuple(out)
