from . import camera, synthetic  # noqa: F401
from .camera import FrameInfo, PinholeCamera, camera_dataset_norm  # noqa: F401
