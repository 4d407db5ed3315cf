"""The headline ~50s-per-scene configuration (the port of
``scripts/full_eval_aggressive.py``; reference
scripts/full_eval_aggressive.py:74-76): 10k iterations, densify every 2nd
epoch, fast xyz lr decay, 1M primitives.  Forwards to
``litegs_torch.full_eval``.

    python -m litegs_torch.full_eval_aggressive --mipnerf360 <dir> ...
"""
import sys

from . import full_eval

PRESET = ["--iterations", "10000", "--primitives", "1000000",
          "--", "--position_lr_max_steps", "10000",
          "--position_lr_final", "0.000016",
          "--densification_interval", "2"]


def main(argv=None):
    return full_eval.main(list(sys.argv[1:] if argv is None else argv)
                          + PRESET)


if __name__ == "__main__":
    main()
