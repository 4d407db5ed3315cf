from . import densify, optimizer, statistics, trainer  # noqa: F401
from .start import start  # noqa: F401
from .trainer import CameraBatch, Trainer, TrainState  # noqa: F401
