"""IO layer: COLMAP loading, 3DGS ply import/export, checkpoints.

The port of ``litegs_tpu/io`` (the reference's ``litegs/io_manager``
package: colmap.py / ply.py / checkpoint.py).
"""
from . import checkpoint, colmap, ply
from .checkpoint import load_checkpoint, save_checkpoint
from .colmap import load_colmap_result
from .ply import load_ply, save_ply

__all__ = ["checkpoint", "colmap", "ply", "load_checkpoint",
           "save_checkpoint", "load_colmap_result", "load_ply", "save_ply"]
