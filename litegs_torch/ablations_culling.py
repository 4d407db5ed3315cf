"""Culling ablation (the port of ``scripts/ablations_culling.py``;
reference scripts/ablations_culling.py): a scene trained with clustered
frustum culling, with culling off (every chunk kept), and with the plain
PyTorch raster path, to quantify the culling win and hold the kernels'
training run to the plain path's.

    python -m litegs_torch.ablations_culling -s <scene_dir> [-m <out_dir>] \
        [--iterations N] [extra example_train flags]

Each variant runs ``python -m litegs_torch.example_train`` in a process of
its own; a variant that fails does not stop the next.
"""
from .example_train import train_variants

VARIANTS = {
    "clustered": [],
    # every chunk kept: quantifies the frustum-culling win (the
    # reference's --cluster_size 0 point, ablations_culling.py:75)
    "no_culling": ["--disable_culling"],
    # the plain PyTorch raster path (the reference's script-path ablation)
    "script_raster": ["--raster_backend", "torch"],
}


def main(argv=None, device="cuda"):
    """Train each variant on ``device``; returns {variant: exit code}."""
    return train_variants(VARIANTS, argv, "ablation_culling", device)


if __name__ == "__main__":
    main()
