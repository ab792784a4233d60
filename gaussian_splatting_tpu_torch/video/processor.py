"""Multi-video ingestion: per-video SfM, pickle caching with validation,
cross-video alignment into video 1's coordinates, duplicate-point removal.

The same contract as the reference ``MultiVideoProcessor.process_videos``
(``multi_video_processor.py:42-65``) — output dict keys: ``points_3d (N,3)``,
``colors (N,3)`` in [0,1], ``all_poses`` (list of per-video (M,4,4)
world-to-camera), ``all_intrinsics`` (list of 3x3 K), ``frame_indices``
(list of int arrays), ``video_info`` (list of {path, fps, num_frames}).
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from gaussian_splatting_tpu_torch.video.align import align_clouds, apply_similarity_to_pose
from gaussian_splatting_tpu_torch.video.calibrate import Calibrator
from gaussian_splatting_tpu_torch.video.loader import VideoLoader
from gaussian_splatting_tpu_torch.video.sfm import VideoSfM

log = logging.getLogger(__name__)


class MultiVideoProcessor:
    def __init__(self, cache_dir: str = "./cache", matcher: str = "sift",
                 focal_px: Optional[float] = None, focal_35mm: Optional[float] = None):
        self.cache_dir = cache_dir
        self.matcher = matcher
        self.focal_px = focal_px
        self.focal_35mm = focal_35mm
        os.makedirs(cache_dir, exist_ok=True)

    # ---- caching (reference multi_video_processor.py:67-114) -------------

    def _cache_path(self, video_path: str, stride: int) -> str:
        h = hashlib.sha1(
            f"{os.path.abspath(video_path)}:{stride}:{self.matcher}:{self.focal_px}:{self.focal_35mm}".encode()
        ).hexdigest()[:16]
        return os.path.join(self.cache_dir, f"sfm_{h}.pkl")

    @staticmethod
    def _cache_valid(data: Dict) -> bool:
        """Reject degenerate/outlier-poisoned results: <2 poses, 0 points, or
        absurd extent (reference validation thresholds)."""
        if data.get("poses") is None or len(data["poses"]) < 2:
            return False
        pts = np.asarray(data.get("points_3d", np.zeros((0, 3))))
        if len(pts) == 0:
            return False
        bbox = pts.max(0) - pts.min(0)
        centroid = np.median(pts, axis=0)
        med_r = np.median(np.linalg.norm(pts - centroid, axis=1))
        if np.max(bbox) > 100.0 or med_r > 100.0:
            return False
        return True

    # ---- per-video -------------------------------------------------------

    def _process_single_video(self, video_path: str, stride: int,
                              use_cache: bool) -> Optional[Dict]:
        cpath = self._cache_path(video_path, stride)
        if use_cache and os.path.exists(cpath):
            try:
                with open(cpath, "rb") as f:
                    data = pickle.load(f)
                if self._cache_valid(data):
                    log.info("SfM cache hit: %s", cpath)
                    return data
                log.warning("SfM cache rejected (degenerate): %s", cpath)
            except Exception as e:
                log.warning("SfM cache load failed: %s", e)

        loader = VideoLoader(video_path)
        frames, indices = [], []
        for idx, frame in loader.frames(stride=stride):
            frames.append(frame)
            indices.append(idx)
        if len(frames) < 2:
            log.warning("video %s: <2 frames at stride %d", video_path, stride)
            return None
        calib = Calibrator(matcher=self.matcher, focal_px=self.focal_px,
                           focal_35mm=self.focal_35mm)
        sfm = VideoSfM(calibrator=calib)
        res = sfm.process_video_frames(frames, indices)
        data = {
            "poses": res.poses,
            "frame_indices": res.frame_indices,
            "points_3d": res.points_3d,
            "colors": res.colors,
            "K": res.K,
            "skip_stats": res.skip_stats,
            "video_info": {
                "path": video_path, "fps": loader.fps,
                "num_frames": loader.num_frames,
                "width": loader.width, "height": loader.height,
            },
        }
        loader.release()
        try:
            with open(cpath, "wb") as f:
                pickle.dump(data, f)
        except Exception as e:
            log.warning("cache write failed: %s", e)
        return data

    # ---- merge (reference multi_video_processor.py:165-252) --------------

    @staticmethod
    def _dedupe(points: np.ndarray, colors: np.ndarray, radius: float = 0.01):
        """Drop near-duplicate points (radius 0.01, reference
        ``multi_video_processor.py:219-252``) — native grid-hash dedupe with
        scipy fallback."""
        if len(points) == 0:
            return points, colors
        from gaussian_splatting_tpu_torch.utils.native import radius_dedupe

        keep = radius_dedupe(points, radius)
        return points[keep], colors[keep] if len(colors) == len(points) else colors

    @staticmethod
    def log_environment_probe() -> Dict:
        """Environment probe logged once per ingest run (reference
        ``video_sfm.py:285-345``): library versions and codec availability,
        so SfM regressions across machines are diagnosable from logs."""
        import cv2 as _cv2
        import numpy as _np
        import scipy as _scipy

        info = {
            "opencv": _cv2.__version__,
            "numpy": _np.__version__,
            "scipy": _scipy.__version__,
            "sift": hasattr(_cv2, "SIFT"),
            "videoio_ffmpeg": "FFMPEG" in _cv2.getBuildInformation(),
        }
        log.info("environment probe: %s", info)
        return info

    def process_videos(self, video_paths: List[str], stride: int = 30,
                       use_cache: bool = True) -> Dict:
        self.log_environment_probe()
        per_video = []
        for vp in video_paths:
            data = self._process_single_video(vp, stride, use_cache)
            if data is not None:
                per_video.append(data)
        if not per_video:
            raise RuntimeError("SfM failed on every input video")

        ref = per_video[0]
        all_points = [np.asarray(ref["points_3d"])]
        all_colors = [np.asarray(ref["colors"])]
        all_poses = [np.asarray(ref["poses"])]
        all_intrinsics = [np.asarray(ref["K"])]
        frame_indices = [np.asarray(ref["frame_indices"])]
        video_info = [ref["video_info"]]

        for data in per_video[1:]:
            src = np.asarray(data["points_3d"])
            # Cross-video 3D-3D correspondences enable the RANSAC similarity
            # path (reference RANSAC.py:15-174 intent, done correctly —
            # video/correspond.py); PCA+ICP remains the no-overlap fallback.
            corr = None
            try:
                from gaussian_splatting_tpu_torch.video.correspond import (
                    cross_video_correspondences,
                )

                corr = cross_video_correspondences(data, ref)
            except Exception as e:
                log.warning("cross-video correspondence generation failed: %s", e)
            s, R, t, method = align_clouds(src, all_points[0], correspondences=corr)
            log.info("aligned %s via %s (scale %.3f)", data["video_info"]["path"], method, s)
            pts = (s * (R @ src.T)).T + t
            poses = np.stack([
                apply_similarity_to_pose(p, s, R, t) for p in np.asarray(data["poses"])
            ])
            all_points.append(pts)
            all_colors.append(np.asarray(data["colors"]))
            all_poses.append(poses)
            all_intrinsics.append(np.asarray(data["K"]))
            frame_indices.append(np.asarray(data["frame_indices"]))
            video_info.append(data["video_info"])

        points = np.concatenate(all_points, axis=0)
        colors = (np.concatenate(all_colors, axis=0)
                  if all(len(c) for c in all_colors) else np.zeros((0, 3)))
        points, colors = self._dedupe(points, colors)
        return {
            "points_3d": points,
            "colors": colors,
            "all_poses": all_poses,
            "all_intrinsics": all_intrinsics,
            "frame_indices": frame_indices,
            "video_info": video_info,
        }
