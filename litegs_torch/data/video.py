"""Video-frame data source (reference VideoFrame, litegs/data.py:118-136):
frames pulled from a video file by index via OpenCV, usable wherever image
frames are (the frame's ``image`` field is filled lazily).  The port of
``litegs_tpu/data/video.py``."""
from __future__ import annotations

import dataclasses

import numpy as np

from .camera import FrameInfo


@dataclasses.dataclass
class VideoFrame(FrameInfo):
    """A camera frame whose pixels come from a video file."""

    video_path: str = ""
    frame_index: int = 0

    def load_image(self, downsample: int = -1) -> np.ndarray:
        import cv2
        cap = cv2.VideoCapture(self.video_path)
        try:
            cap.set(cv2.CAP_PROP_POS_FRAMES, self.frame_index)
            ok, frame = cap.read()
            if not ok:
                raise IOError(f"cannot read frame {self.frame_index} "
                              f"from {self.video_path}")
        finally:
            cap.release()
        rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if downsample in (2, 4, 8):
            h, w = rgb.shape[:2]
            rgb = cv2.resize(rgb, (round(w / downsample),
                                   round(h / downsample)),
                             interpolation=cv2.INTER_AREA)
        self.image = rgb.transpose(2, 0, 1)
        return self.image


def video_frames(video_path: str, poses, camera_id: int = 0,
                 stride: int = 1) -> list[VideoFrame]:
    """Build VideoFrames from a pose list [(qvec, tvec), ...]."""
    frames = []
    for i, (qvec, tvec) in enumerate(poses):
        frames.append(VideoFrame(
            id=i, qvec=np.asarray(qvec), tvec=np.asarray(tvec),
            camera_id=camera_id, name=f"video_{i:05d}",
            video_path=video_path, frame_index=i * stride))
    return frames
