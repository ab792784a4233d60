"""Camera calibration and pairwise feature matching.

Mirrors the reference ``calibrate.py`` behaviors:
- intrinsics: explicit focal override, 35mm-equivalent conversion
  ``(f35/36)*max(W,H)``, or the COLMAP-style prior ``1.2*max(W,H)``
  (reference ``calibrate.py:333-382``, ``README.md:7``);
- SIFT (default, ``nfeatures=4000, contrastThreshold=0.005,
  edgeThreshold=20`` — reference ``calibrate.py:54``) or ORB matching with
  Lowe ratio test 0.75 (``calibrate.py:85-125``);
- intrinsics validation via Sampson distance on fundamental-matrix inliers
  (``calibrate.py:285-331``).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np

log = logging.getLogger(__name__)


class Calibrator:
    def __init__(self, matcher: str = "sift", focal_px: Optional[float] = None,
                 focal_35mm: Optional[float] = None, nfeatures: int = 4000):
        self.matcher_kind = matcher
        self.focal_px = focal_px
        self.focal_35mm = focal_35mm
        if matcher == "sift":
            self.detector = cv2.SIFT.create(
                nfeatures=nfeatures, contrastThreshold=0.005, edgeThreshold=20
            )
            self.bf = cv2.BFMatcher(cv2.NORM_L2)
        elif matcher in ("orb", "opencv"):
            self.detector = cv2.ORB.create(nfeatures=nfeatures)
            self.bf = cv2.BFMatcher(cv2.NORM_HAMMING)
        else:
            raise ValueError(f"unknown matcher {matcher!r} (sift | orb)")
        self._feat_cache: Dict[int, tuple] = {}

    # ---- features / matches ---------------------------------------------

    def detect(self, frame: np.ndarray, cache_key: Optional[int] = None):
        if cache_key is not None and cache_key in self._feat_cache:
            return self._feat_cache[cache_key]
        gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY) if frame.ndim == 3 else frame
        kps, desc = self.detector.detectAndCompute(gray, None)
        out = (kps, desc)
        if cache_key is not None:
            self._feat_cache[cache_key] = out
        return out

    def match_pair(self, frame1, frame2, key1=None, key2=None,
                   ratio: float = 0.75) -> Tuple[np.ndarray, np.ndarray]:
        """Lowe-ratio-tested matches. Returns (pts1 (M,2), pts2 (M,2))."""
        kps1, d1 = self.detect(frame1, key1)
        kps2, d2 = self.detect(frame2, key2)
        if d1 is None or d2 is None or len(kps1) < 2 or len(kps2) < 2:
            return np.zeros((0, 2), np.float32), np.zeros((0, 2), np.float32)
        knn = self.bf.knnMatch(d1, d2, k=2)
        pts1, pts2 = [], []
        for pair in knn:
            if len(pair) < 2:
                continue
            m, n = pair
            if m.distance < ratio * n.distance:
                pts1.append(kps1[m.queryIdx].pt)
                pts2.append(kps2[m.trainIdx].pt)
        if not pts1:
            return np.zeros((0, 2), np.float32), np.zeros((0, 2), np.float32)
        return np.asarray(pts1, np.float32), np.asarray(pts2, np.float32)

    # ---- intrinsics ------------------------------------------------------

    def identify_intrinsics(self, width: int, height: int,
                            sample_frames: Optional[List[np.ndarray]] = None) -> np.ndarray:
        """Focal prior + optional Sampson-distance validation on sample frames
        (reference ``calibrate.py:333-382``)."""
        m = float(max(width, height))
        if self.focal_px is not None:
            f = float(self.focal_px)
        elif self.focal_35mm is not None:
            f = (float(self.focal_35mm) / 36.0) * m
        else:
            f = 1.2 * m
        K = np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1.0]], np.float64)
        if sample_frames and len(sample_frames) >= 2:
            err = self.validate_intrinsics(K, sample_frames)
            if err is not None:
                log.info("intrinsics Sampson check: %.3f px (focal %.1f)", err, f)
        return K

    def refine_focal_bundle_adjustment(
        self, K: np.ndarray, frames: List[np.ndarray], max_pairs: int = 4,
    ) -> np.ndarray:
        """Focal-only bundle adjustment: optimize f to minimize two-view
        reprojection error over sample pairs (the reference ships this but
        leaves it commented out, ``calibrate.py:162-283,371``; here it works
        and is opt-in). Pose+structure re-estimated per candidate focal via
        essential-matrix decomposition + triangulation; scipy least_squares
        on the residual stack."""
        from scipy.optimize import least_squares

        pairs = []
        step = max(1, len(frames) // (max_pairs + 1))
        for i in range(0, len(frames) - step, step):
            p1, p2 = self.match_pair(frames[i], frames[i + step])
            if len(p1) >= 30:
                pairs.append((p1, p2))
            if len(pairs) >= max_pairs:
                break
        if not pairs:
            return K
        w2, h2 = K[0, 2], K[1, 2]

        def residuals(params):
            f = abs(params[0])
            Kc = np.array([[f, 0, w2], [0, f, h2], [0, 0, 1.0]])
            res = []
            for p1, p2 in pairs:
                E, mask = cv2.findEssentialMat(p1, p2, Kc, method=cv2.RANSAC,
                                               prob=0.999, threshold=1.0)
                if E is None or E.shape != (3, 3):
                    res.append(np.full(32, 10.0))
                    continue
                _, R, t, maskP = cv2.recoverPose(E, p1, p2, Kc, mask=mask)
                inl = maskP.ravel().astype(bool)
                if inl.sum() < 8:
                    res.append(np.full(32, 10.0))
                    continue
                P1 = Kc @ np.eye(4)[:3]
                pose2 = np.eye(4)
                pose2[:3, :3] = R
                pose2[:3, 3] = t.ravel()
                P2 = Kc @ pose2[:3]
                Xh = cv2.triangulatePoints(P1, P2, p1[inl].T.astype(np.float64),
                                           p2[inl].T.astype(np.float64))
                with np.errstate(invalid="ignore", divide="ignore"):
                    X = (Xh[:3] / Xh[3:4]).T
                    uvw = (P2 @ np.hstack([X, np.ones((len(X), 1))]).T).T
                    uv = uvw[:, :2] / uvw[:, 2:3]
                err = np.linalg.norm(uv - p2[inl], axis=1)
                err = err[np.isfinite(err)][:32]
                res.append(np.clip(err, 0, 10.0))
            return np.concatenate(res) if res else np.zeros(1)

        try:
            sol = least_squares(residuals, x0=[K[0, 0]], method="trf",
                                diff_step=0.02, max_nfev=20)
            f_new = float(abs(sol.x[0]))
            if 0.3 * K[0, 0] < f_new < 3.0 * K[0, 0]:
                K = K.copy()
                K[0, 0] = K[1, 1] = f_new
                log.info("focal BA: %.1f px", f_new)
        except Exception as e:
            log.warning("focal BA failed: %s", e)
        return K

    def match_with_loftr(self, frame1, frame2, conf: float = 0.5):
        """Dense neural matching via kornia LoFTR when available (the
        reference's optional path, ``calibrate.py:127-160``); this
        environment has no kornia, so it raises a clear error and callers
        fall back to SIFT."""
        try:
            import kornia  # noqa: F401
            import torch
        except ImportError as e:
            raise RuntimeError(
                "LoFTR matching requires kornia (not installed); use matcher='sift'"
            ) from e
        from kornia.feature import LoFTR  # pragma: no cover

        matcher = LoFTR(pretrained="outdoor")
        g1 = cv2.cvtColor(frame1, cv2.COLOR_BGR2GRAY).astype(np.float32) / 255.0
        g2 = cv2.cvtColor(frame2, cv2.COLOR_BGR2GRAY).astype(np.float32) / 255.0
        inp = {
            "image0": torch.tensor(g1)[None, None],
            "image1": torch.tensor(g2)[None, None],
        }
        with torch.no_grad():
            out = matcher(inp)
        keep = out["confidence"].numpy() > conf
        return out["keypoints0"].numpy()[keep], out["keypoints1"].numpy()[keep]

    def validate_intrinsics(self, K: np.ndarray, frames: List[np.ndarray]) -> Optional[float]:
        """Median Sampson distance of F-inlier matches on consecutive sample
        pairs (reference ``calibrate.py:285-331``). Returns None if not enough
        matches anywhere."""
        errs = []
        for a, b in zip(frames[:-1], frames[1:]):
            p1, p2 = self.match_pair(a, b)
            if len(p1) < 16:
                continue
            F, mask = cv2.findFundamentalMat(p1, p2, cv2.FM_RANSAC, 1.0, 0.999)
            if F is None:
                continue
            inl = mask.ravel().astype(bool)
            if inl.sum() < 8:
                continue
            x1 = np.hstack([p1[inl], np.ones((inl.sum(), 1))])
            x2 = np.hstack([p2[inl], np.ones((inl.sum(), 1))])
            Fx1 = x1 @ F.T
            Ftx2 = x2 @ F
            num = np.sum(x2 * Fx1, axis=1) ** 2
            den = Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2
            errs.append(float(np.median(num / np.maximum(den, 1e-12))))
        return float(np.median(errs)) if errs else None
