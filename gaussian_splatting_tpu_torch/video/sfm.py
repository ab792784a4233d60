"""Incremental structure-from-motion over video frames.

The same pipeline shape as the reference (``video_sfm.py:20-283``):
- first accepted pair: essential-matrix pose (with homography-degeneracy
  check) via ``recoverPose`` — fixes the global scale at |t| = 1;
- subsequent frames: KLT-track the 2D observations of existing 3D points,
  register with ``solvePnPRansac`` (EPNP) + LM refinement, then discover new
  points from feature matches away from tracked ones and triangulate against
  the previous keyframe;
- per-gate skip accounting mirrors the reference's counters
  (``video_sfm.py:66-77, 255-274``).

Gate constants match the reference exactly (``video_sfm.py:80-89``).
Poses are world-to-camera 4x4 (reference ``README.md:6``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np
from scipy.spatial import cKDTree

from gaussian_splatting_tpu_torch.video.calibrate import Calibrator

log = logging.getLogger(__name__)

MIN_MATCHES = 8
MIN_INLIERS = 30
MIN_FLOW_PX = 4.0
MIN_PNP_TRACKS = 8
TRACK_RADIUS_PX = 6.0
MAX_REPROJ_PX = 1.0


@dataclasses.dataclass
class SfMResult:
    poses: np.ndarray          # (M, 4, 4) world-to-camera
    frame_indices: np.ndarray  # (M,)
    points_3d: np.ndarray      # (N, 3)
    colors: np.ndarray         # (N, 3) in [0, 1]
    K: np.ndarray              # (3, 3)
    skip_stats: Dict[str, int]


class VideoSfM:
    def __init__(self, calibrator: Optional[Calibrator] = None, matcher: str = "sift"):
        self.calib = calibrator or Calibrator(matcher=matcher)

    # ---- public ----------------------------------------------------------

    def process_video_frames(
        self, frames: List[np.ndarray], frame_indices: Optional[List[int]] = None,
        K: Optional[np.ndarray] = None,
    ) -> SfMResult:
        n = len(frames)
        if frame_indices is None:
            frame_indices = list(range(n))
        if n < 2:
            raise ValueError("need at least 2 frames")
        h, w = frames[0].shape[:2]
        if K is None:
            K = self.calib.identify_intrinsics(w, h, sample_frames=frames[: min(50, n)])
        K = np.asarray(K, np.float64)

        skip = {k: 0 for k in (
            "too_similar", "few_matches", "few_inliers", "low_flow",
            "few_pnp_tracks", "pnp_failed", "accepted")}

        poses: List[np.ndarray] = []
        pose_frames: List[int] = []
        points: List[np.ndarray] = []       # world coords per 3D point
        colors: List[np.ndarray] = []
        track_2d: Dict[int, np.ndarray] = {}  # point idx -> last observed 2D
        last_frame = None
        last_gray = None
        initialized = False

        for i in range(n):
            frame = frames[i]
            gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            if last_frame is None:
                last_frame, last_gray, last_i = frame, gray, i
                continue

            if self._too_similar(last_gray, gray):
                skip["too_similar"] += 1
                continue

            p1, p2 = self.calib.match_pair(last_frame, frame, key1=last_i, key2=i)

            if not initialized:
                ok = (len(p1) >= MIN_MATCHES) and self._initialize_pair(
                    p1, p2, K, last_frame, frame, poses, points, colors,
                    track_2d, skip)
                if len(p1) < MIN_MATCHES:
                    skip["few_matches"] += 1
                if not ok:
                    # Slide the initialization base forward: keeping the old
                    # base only grows the baseline and makes every later pair
                    # harder (a one-bad-pair death spiral observed on short
                    # clips — adjacent pairs pass while (0, k) pairs fail).
                    last_frame, last_gray, last_i = frame, gray, i
                    continue
                # The accepted pair defines the world frame: identity at the
                # base frame, recovered pose at the current frame.
                pose_frames.append(frame_indices[last_i])
                pose_frames.append(frame_indices[i])
                initialized = True
            else:
                ok = self._register_frame(frame, gray, last_gray, K, poses,
                                          points, colors, track_2d, skip,
                                          last_frame, p1, p2)
                if not ok:
                    continue
                pose_frames.append(frame_indices[i])

            skip["accepted"] += 1
            last_frame, last_gray, last_i = frame, gray, i

        pts = np.asarray(points, np.float64).reshape(-1, 3)
        cols = (np.asarray(colors, np.float64).reshape(-1, 3)
                if colors else np.zeros((0, 3)))
        pts, cols = self._filter_points(pts, cols)
        log.info("SfM: %d poses, %d points, skips %s", len(poses), len(pts), skip)
        return SfMResult(
            poses=np.asarray(poses, np.float64),
            frame_indices=np.asarray(pose_frames, np.int64),
            points_3d=pts, colors=cols, K=K, skip_stats=skip,
        )

    # ---- stages ----------------------------------------------------------

    def _too_similar(self, g1: np.ndarray, g2: np.ndarray) -> bool:
        """Histogram correlation + mean-abs-diff + KLT flow probe
        (reference ``video_sfm.py:455-497``)."""
        h1 = cv2.calcHist([g1], [0], None, [64], [0, 256])
        h2 = cv2.calcHist([g2], [0], None, [64], [0, 256])
        corr = cv2.compareHist(h1, h2, cv2.HISTCMP_CORREL)
        mad = float(np.mean(np.abs(g1.astype(np.int16) - g2.astype(np.int16))))
        if corr < 0.98 or mad > 4.0:
            return False
        # Flow probe on a sparse corner grid.
        pts = cv2.goodFeaturesToTrack(g1, maxCorners=200, qualityLevel=0.01, minDistance=8)
        if pts is None or len(pts) < 8:
            return mad < 1.0
        nxt, st, _ = cv2.calcOpticalFlowPyrLK(g1, g2, pts, None)
        st = st.ravel().astype(bool)
        if st.sum() < 8:
            return False
        flow = np.linalg.norm((nxt - pts).reshape(-1, 2)[st], axis=1)
        return float(np.median(flow)) < MIN_FLOW_PX

    def _initialize_pair(self, p1, p2, K, frame1, frame2, poses, points,
                         colors, track_2d, skip) -> bool:
        """Essential-matrix bootstrap (reference ``video_sfm.py:410-443``)."""
        E, maskE = cv2.findEssentialMat(p1, p2, K, method=cv2.RANSAC,
                                        prob=0.999, threshold=1.0)
        if E is None or E.shape != (3, 3):
            skip["few_inliers"] += 1
            return False
        # Homography degeneracy check: if H explains far more inliers than E,
        # the pair is planar/rotation-only.
        H, maskH = cv2.findHomography(p1, p2, cv2.RANSAC, 3.0)
        nE = int(maskE.sum()) if maskE is not None else 0
        nH = int(maskH.sum()) if maskH is not None else 0
        if nE < MIN_INLIERS or (nH > 0 and nE < 0.7 * nH):
            skip["few_inliers"] += 1
            return False
        flow = np.linalg.norm(p2 - p1, axis=1)
        if float(np.median(flow)) < MIN_FLOW_PX:
            skip["low_flow"] += 1
            return False
        _, R, t, maskP = cv2.recoverPose(E, p1, p2, K, mask=maskE)
        pose = np.eye(4)
        pose[:3, :3] = R
        pose[:3, 3] = t.ravel()  # |t| = 1 fixes global scale
        inl = maskP.ravel().astype(bool)
        X, keep = self._triangulate(p1[inl], p2[inl], K, np.eye(4), pose)
        if keep.sum() < MIN_INLIERS // 2:
            skip["few_inliers"] += 1
            return False
        poses.append(np.eye(4))  # the base frame defines the world frame
        poses.append(pose)
        base = len(points)
        Xk = X[keep]
        p2k = p2[inl][keep]  # track observations live in frame-2 coords
        cols = self._colors_at(frame2, p2k)
        for j in range(len(Xk)):
            points.append(Xk[j])
            colors.append(cols[j])
            track_2d[base + j] = p2k[j]
        return True

    def _register_frame(self, frame, gray, last_gray, K, poses, points,
                        colors, track_2d, skip, last_frame, p1, p2) -> bool:
        """KLT + PnP registration and new-point triangulation
        (reference ``video_sfm.py:165-242``)."""
        if len(track_2d) < MIN_PNP_TRACKS:
            skip["few_pnp_tracks"] += 1
            return False
        ids = np.fromiter(track_2d.keys(), dtype=np.int64)
        prev_pts = np.asarray([track_2d[i] for i in ids], np.float32).reshape(-1, 1, 2)
        nxt, st, _ = cv2.calcOpticalFlowPyrLK(last_gray, gray, prev_pts, None)
        st = st.ravel().astype(bool)
        # Forward-backward check for robustness.
        back, st2, _ = cv2.calcOpticalFlowPyrLK(gray, last_gray, nxt, None)
        fb = np.linalg.norm((back - prev_pts).reshape(-1, 2), axis=1)
        good = st & st2.ravel().astype(bool) & (fb < 1.0)
        if good.sum() < MIN_PNP_TRACKS:
            skip["few_pnp_tracks"] += 1
            return False
        obj = np.asarray([points[i] for i in ids[good]], np.float64)
        img = nxt.reshape(-1, 2)[good].astype(np.float64)
        ok, rvec, tvec, inliers = cv2.solvePnPRansac(
            obj, img, K, None, flags=cv2.SOLVEPNP_EPNP,
            reprojectionError=3.0, iterationsCount=200, confidence=0.999)
        if not ok or inliers is None or len(inliers) < MIN_PNP_TRACKS:
            skip["pnp_failed"] += 1
            return False
        rvec, tvec = cv2.solvePnPRefineLM(obj[inliers.ravel()], img[inliers.ravel()],
                                          K, None, rvec, tvec)
        R, _ = cv2.Rodrigues(rvec)
        pose = np.eye(4)
        pose[:3, :3] = R
        pose[:3, 3] = tvec.ravel()
        prev_pose = poses[-1]
        poses.append(pose)

        # Update tracked observations.
        new_tracks: Dict[int, np.ndarray] = {}
        for sel, pid in zip(good.nonzero()[0], ids[good]):
            new_tracks[int(pid)] = nxt.reshape(-1, 2)[sel]
        track_2d.clear()
        track_2d.update(new_tracks)

        # Discover new points: matches away from currently tracked 2D points.
        if len(p1) >= MIN_MATCHES:
            tracked = np.asarray(list(track_2d.values()), np.float64).reshape(-1, 2)
            if len(tracked):
                tree = cKDTree(tracked)
                d, _ = tree.query(p2.astype(np.float64))
                fresh = d > TRACK_RADIUS_PX
            else:
                fresh = np.ones(len(p2), bool)
            if fresh.sum() >= 4:
                X, keep = self._triangulate(p1[fresh], p2[fresh], K, prev_pose, pose)
                Xk = X[keep]
                pk = p2[fresh][keep]
                cols = self._colors_at(frame, pk)
                base = len(points)
                for j in range(len(Xk)):
                    points.append(Xk[j])
                    colors.append(cols[j])
                    track_2d[base + j] = pk[j]
        return True

    # ---- geometry --------------------------------------------------------

    @staticmethod
    def _triangulate(p1, p2, K, pose1, pose2) -> Tuple[np.ndarray, np.ndarray]:
        """Triangulate matched pixels between two world-to-camera poses.
        Returns (X_world (M,3), keep mask) with finite/cheirality/reprojection
        gates (reference ``video_sfm.py:347-408``)."""
        if len(p1) == 0:
            return np.zeros((0, 3)), np.zeros((0,), bool)
        P1 = K @ pose1[:3]
        P2 = K @ pose2[:3]
        Xh = cv2.triangulatePoints(P1, P2, p1.T.astype(np.float64), p2.T.astype(np.float64))
        with np.errstate(invalid="ignore", divide="ignore"):
            X = (Xh[:3] / Xh[3:4]).T
        finite = np.isfinite(X).all(axis=1)
        Xh4 = np.hstack([X, np.ones((len(X), 1))])
        z1 = (pose1 @ Xh4.T).T[:, 2]
        z2 = (pose2 @ Xh4.T).T[:, 2]
        cheir = (z1 > 1e-4) & (z2 > 1e-4)
        # Reprojection gate in both views.
        def reproj_err(P, pts2d):
            with np.errstate(invalid="ignore", divide="ignore"):
                uvw = (P @ Xh4.T).T
                uv = uvw[:, :2] / uvw[:, 2:3]
            return np.linalg.norm(uv - pts2d, axis=1)
        e1 = reproj_err(P1, p1)
        e2 = reproj_err(P2, p2)
        keep = finite & cheir & (e1 <= MAX_REPROJ_PX) & (e2 <= MAX_REPROJ_PX)
        keep &= np.isfinite(e1) & np.isfinite(e2)
        return X, keep

    @staticmethod
    def _colors_at(frame: np.ndarray, pts: np.ndarray) -> np.ndarray:
        """RGB in [0,1] sampled at pixel locations (BGR frame input)."""
        h, w = frame.shape[:2]
        xi = np.clip(pts[:, 0].astype(int), 0, w - 1)
        yi = np.clip(pts[:, 1].astype(int), 0, h - 1)
        bgr = frame[yi, xi].astype(np.float64) / 255.0
        return bgr[:, ::-1]

    @staticmethod
    def _filter_points(pts: np.ndarray, cols: np.ndarray):
        """Robust outlier gate: drop points beyond 5x the median radius from
        the median centroid (reference ``video_sfm.py:499-531``)."""
        if len(pts) == 0:
            return pts, cols
        centroid = np.median(pts, axis=0)
        r = np.linalg.norm(pts - centroid, axis=1)
        med = np.median(r[np.isfinite(r)]) if np.isfinite(r).any() else 1.0
        keep = np.isfinite(r) & (r <= 5.0 * max(med, 1e-9))
        return pts[keep], (cols[keep] if len(cols) == len(pts) else cols)
