"""Densification ablation (the port of ``scripts/ablations_densify.py``;
reference scripts/ablations_densify.py:61): an official-ADC-style
configuration -- densify every epoch, opacity 'reset' mode, threshold
prune -- against the default TamingGS score-based control.

    python -m litegs_torch.ablations_densify -s <scene_dir> [-m <out_dir>] \
        [--iterations N] [extra example_train flags]

Each variant runs ``python -m litegs_torch.example_train`` in a process of
its own; a variant that fails does not stop the next.
"""
from .example_train import train_variants

VARIANTS = {
    "tamings": [],
    "official_adc": ["--densify_mode", "official",
                     "--densification_interval", "1",
                     "--opacity_reset_interval", "20",
                     "--opacity_reset_mode", "reset",
                     "--prune_mode", "threshold"],
}


def main(argv=None, device="cuda"):
    """Train each variant on ``device``; returns {variant: exit code}."""
    return train_variants(VARIANTS, argv, "ablation_densify", device)


if __name__ == "__main__":
    main()
