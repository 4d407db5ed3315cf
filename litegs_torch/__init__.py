"""litegs_torch: LiteGS 3D Gaussian Splatting on PyTorch and CUDA (Hopper).

The port of ``litegs_tpu`` to an NVIDIA H100.  It mirrors the JAX
package's module tree and names; each TPU kernel becomes a CUDA kernel
written by hand (``csrc/``, built on first use by ``ops/_kernels.py``).
It imports neither JAX nor ``litegs_tpu``.
"""
from . import (config, data, evaluation, io, metrics, ops,  # noqa: F401
               render, scene, training, utils)
