"""Video frame loading with a RAM cache.

Random-access H.264 seeks cost 30-80 ms/frame; one sequential decode pass is
~1 ms/frame (reference ``video_loader.py:8-9``), so ``preload`` decodes the
needed frame set in a single monotonic sweep and later reads are dict
lookups — same strategy as the reference (``video_loader.py:22-53``)."""

from __future__ import annotations

import logging
from typing import Dict, Iterable, Optional

import cv2
import numpy as np

log = logging.getLogger(__name__)


class VideoLoader:
    def __init__(self, video_path: str, cache_frames: bool = True):
        self.video_path = str(video_path)
        self.capture = cv2.VideoCapture(self.video_path)
        if not self.capture.isOpened():
            raise IOError(f"cannot open video: {video_path}")
        self.cache_frames = cache_frames
        self.frame_cache: Dict[int, np.ndarray] = {}
        self.num_frames = int(self.capture.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = float(self.capture.get(cv2.CAP_PROP_FPS) or 30.0)
        self.width = int(self.capture.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.capture.get(cv2.CAP_PROP_FRAME_HEIGHT))

    def preload(self, frame_indices: Iterable[int]) -> None:
        """Decode the given frames in one sequential pass into the cache."""
        want = sorted(set(int(i) for i in frame_indices))
        if not want:
            return
        self.capture.set(cv2.CAP_PROP_POS_FRAMES, 0)
        pos = 0
        wi = 0
        while wi < len(want):
            ok, frame = self.capture.read()
            if not ok:
                break
            if pos == want[wi]:
                self.frame_cache[pos] = frame
                wi += 1
            pos += 1
        log.info("preloaded %d/%d frames from %s", len(self.frame_cache), len(want), self.video_path)

    def get_frame(self, idx: int) -> Optional[np.ndarray]:
        """BGR frame (H, W, 3) uint8, from cache if present."""
        idx = int(idx)
        if idx in self.frame_cache:
            return self.frame_cache[idx]
        self.capture.set(cv2.CAP_PROP_POS_FRAMES, idx)
        ok, frame = self.capture.read()
        if not ok:
            return None
        if self.cache_frames:
            self.frame_cache[idx] = frame
        return frame

    def frames(self, stride: int = 1):
        """Generator over (index, frame) at the given stride."""
        self.capture.set(cv2.CAP_PROP_POS_FRAMES, 0)
        idx = 0
        while True:
            ok, frame = self.capture.read()
            if not ok:
                return
            if idx % stride == 0:
                yield idx, frame
            idx += 1

    def release(self):
        self.capture.release()
