"""Checkpoint save/resume of the full training state.

The reference pickles {epoch, optimizer, scheduler} wholesale
(litegs/io_manager/checkpoint.py:4-25); ``litegs_tpu/io/checkpoint.py``
saves its pytree's leaves in treedef order.  The port saves a tree of
named arrays: one ``chkpnt{epoch}.npz`` whose keys are the dotted paths of
the leaves (``state.params.xyz``, ``state.adam.exp_avg.xyz``,
``state.active_count``, ``stats.visible_count``, ``pose.extr``, ...), plus
a ``.json`` sidecar with the epoch and the key list.  No object is
pickled.

A tree is built of ``GaussianModel``s, NamedTuples and dicts, with tensors
and Python ints at its leaves.  Loading rebuilds the template's structure:
the key sets must be equal and every leaf's shape and dtype must match the
template's, or it raises.  Restored tensors go to the device of the
template's leaf.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..scene.gaussians import GaussianModel


def _children(node):
    """(name, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, GaussianModel):
        return list(node.fields().items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(node._asdict().items())
    if isinstance(node, dict):
        return list(node.items())
    return None


def _leaves(tree, prefix: str = ""):
    """(dotted key, leaf) for every leaf of ``tree``."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for name, child in kids:
        yield from _leaves(child, f"{prefix}.{name}" if prefix else name)


def _rebuild(tree, fn, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by fn(key, leaf)."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    new = {name: _rebuild(child, fn, f"{prefix}.{name}" if prefix else name)
           for name, child in kids}
    if isinstance(tree, dict):
        return new
    return type(tree)(**new)


def _to_numpy(key: str, leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int64)
    raise TypeError(f"checkpoint leaf {key}: unsupported {type(leaf)}")


def _spec(leaf) -> tuple[tuple, np.dtype]:
    if torch.is_tensor(leaf):
        return (tuple(leaf.shape),
                torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    return (), np.dtype(np.int64)


def save_checkpoint(ckpt_dir: str, epoch: int, state,
                    extra: dict | None = None) -> str:
    """Write chkpnt{epoch}.npz (+ .json metadata). Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {key: _to_numpy(key, leaf) for key, leaf in _leaves(state)}
    path = os.path.join(ckpt_dir, f"chkpnt{epoch}.npz")
    np.savez(path, **arrays)
    meta = {"epoch": epoch, "keys": list(arrays), "extra": extra or {}}
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    return path


def load_checkpoint(path: str, state_template):
    """Restore (epoch, state) from a checkpoint file.

    ``state_template`` supplies the structure, every leaf's shape and dtype
    (capacity is part of the saved shapes, as the reference's pickled
    tensors fix N) and the device of every restored tensor.
    """
    with open(path + ".json") as f:
        meta = json.load(f)
    want = dict(_leaves(state_template))
    with np.load(path, allow_pickle=False) as data:
        have = set(data.files)
        if set(meta["keys"]) != have or have != set(want):
            raise ValueError(
                f"checkpoint {path} keys differ from the template: missing "
                f"{sorted(set(want) - have)}, unexpected "
                f"{sorted(have - set(want))}")
        for key, leaf in want.items():
            shape, dtype = _spec(leaf)
            arr = data[key]
            if arr.shape != shape or arr.dtype != dtype:
                raise ValueError(
                    f"checkpoint leaf {key}: {arr.shape} {arr.dtype} against "
                    f"the template's {shape} {dtype}")

        def restore(key, leaf):
            arr = data[key]
            if torch.is_tensor(leaf):
                return torch.from_numpy(arr).to(leaf.device)
            return int(arr)

        return meta["epoch"], _rebuild(state_template, restore)
