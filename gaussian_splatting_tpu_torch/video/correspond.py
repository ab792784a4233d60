"""Cross-video 3D-3D correspondence generation for multi-video alignment.

The reference aligns video k to video 1 by matching frames across the two
videos, locating each match in BOTH reconstructions, and fitting a RANSAC
similarity over the resulting 3D-3D pairs (reference ``RANSAC.py:15-174``).
Its correspondence code is self-described test code with a triangulation
bug (``pts1_h, pts1_h`` twice, ``RANSAC.py:97,104``) and mismatched
pose/frame indexing; this module implements the capability correctly:

1. Sample pose-backed frames from each video and SIFT-match across videos.
2. A cross-match gives the SAME physical point seen at ``p_ref`` (ref video)
   and ``p_src`` (src video). Locate it in each reconstruction by KLT-
   tracking to a neighboring pose-backed frame of the SAME video (with the
   forward-backward check) and triangulating under that video's own poses —
   never mixing intrinsics or poses across videos.
3. Gate with the SfM cheirality/reprojection filters and return the paired
   3D points for ``align.align_clouds``'s RANSAC+ICP path.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import cv2
import numpy as np

from gaussian_splatting_tpu_torch.video.calibrate import Calibrator
from gaussian_splatting_tpu_torch.video.loader import VideoLoader
from gaussian_splatting_tpu_torch.video.sfm import VideoSfM

log = logging.getLogger(__name__)

MIN_CROSS_MATCHES = 30      # reference RANSAC.py:64 gate
MIN_CORRESPONDENCES = 10    # reference RANSAC.py:116 gate
FB_MAX_PX = 1.0             # forward-backward KLT gate (as in sfm.py)


def _klt_track(gray1, gray2, pts):
    """KLT with forward-backward check. Returns (tracked_pts, ok_mask)."""
    if len(pts) == 0:
        return pts, np.zeros((0,), bool)
    p = pts.reshape(-1, 1, 2).astype(np.float32)
    nxt, st, _ = cv2.calcOpticalFlowPyrLK(gray1, gray2, p, None)
    back, st2, _ = cv2.calcOpticalFlowPyrLK(gray2, gray1, nxt, None)
    fb = np.linalg.norm((back - p).reshape(-1, 2), axis=1)
    ok = (st.ravel().astype(bool) & st2.ravel().astype(bool)
          & (fb < FB_MAX_PX))
    return nxt.reshape(-1, 2), ok


class _VideoSide:
    """Frames + poses of one reconstruction, with lazy gray conversion."""

    def __init__(self, data: Dict, n_sample: int):
        self.poses = np.asarray(data["poses"])
        self.K = np.asarray(data["K"], np.float64)
        fidx = np.asarray(data["frame_indices"])[: len(self.poses)]
        self.loader = VideoLoader(data["video_info"]["path"])
        n = min(n_sample, len(self.poses) - 1)
        # Sampled pose indices, each with a successor for triangulation.
        self.sample = np.unique(
            np.linspace(0, max(len(self.poses) - 2, 0), max(n, 1)).astype(int))
        self.fidx = fidx
        self._frames: Dict[int, np.ndarray] = {}
        self._grays: Dict[int, np.ndarray] = {}

    def frame(self, pose_i: int):
        if pose_i not in self._frames:
            self._frames[pose_i] = self.loader.get_frame(int(self.fidx[pose_i]))
        return self._frames[pose_i]

    def gray(self, pose_i: int):
        if pose_i not in self._grays:
            f = self.frame(pose_i)
            self._grays[pose_i] = (cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)
                                   if f is not None and f.ndim == 3 else f)
        return self._grays[pose_i]

    def locate_3d(self, pose_i: int, pts: np.ndarray):
        """3D-locate 2D points of frame ``pose_i`` in THIS reconstruction:
        KLT to the next pose-backed frame, triangulate under own poses.
        Returns (X (M,3), ok mask over the input points)."""
        j = pose_i + 1 if pose_i + 1 < len(self.poses) else pose_i - 1
        g1, g2 = self.gray(pose_i), self.gray(j)
        if g1 is None or g2 is None:
            return np.zeros((len(pts), 3)), np.zeros((len(pts),), bool)
        tracked, ok = _klt_track(g1, g2, pts)
        X = np.zeros((len(pts), 3))
        keep = np.zeros((len(pts),), bool)
        if ok.any():
            Xt, kt = VideoSfM._triangulate(
                pts[ok], tracked[ok], self.K,
                self.poses[pose_i], self.poses[j])
            idx = np.flatnonzero(ok)
            X[idx] = Xt
            keep[idx] = kt
        return X, keep

    def release(self):
        self.loader.release()


def cross_video_correspondences(
    src_data: Dict,
    ref_data: Dict,
    calibrator: Optional[Calibrator] = None,
    n_sample_frames: int = 5,
    max_pairs: int = 12,
    target: int = 400,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """3D-3D correspondences (X_src, X_ref) between two per-video SfM
    results, or None when the videos don't visually overlap."""
    if len(src_data.get("poses", ())) < 2 or len(ref_data.get("poses", ())) < 2:
        return None
    cal = calibrator or Calibrator(matcher="sift")
    src = _VideoSide(src_data, n_sample_frames)
    ref = _VideoSide(ref_data, n_sample_frames)
    xs, xr = [], []
    try:
        pairs = [(ri, si) for ri in ref.sample for si in src.sample]
        tried = 0
        for ri, si in pairs:
            if tried >= max_pairs or sum(len(a) for a in xs) >= target:
                break
            f_ref, f_src = ref.frame(ri), src.frame(si)
            if f_ref is None or f_src is None:
                continue
            tried += 1
            p_ref, p_src = cal.match_pair(
                f_ref, f_src, key1=("r", ri), key2=("s", si))
            if len(p_ref) < MIN_CROSS_MATCHES:
                continue
            X_ref, ok_ref = ref.locate_3d(ri, p_ref)
            X_src, ok_src = src.locate_3d(si, p_src)
            ok = ok_ref & ok_src
            if ok.any():
                xs.append(X_src[ok])
                xr.append(X_ref[ok])
    finally:
        src.release()
        ref.release()
    if not xs:
        return None
    X_src = np.concatenate(xs, axis=0)
    X_ref = np.concatenate(xr, axis=0)
    if len(X_src) < MIN_CORRESPONDENCES:
        log.info("cross-video: only %d correspondences — falling back", len(X_src))
        return None
    log.info("cross-video: %d 3D-3D correspondences", len(X_src))
    return X_src, X_ref
