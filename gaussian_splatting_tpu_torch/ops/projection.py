"""Perspective projection of anisotropic 3D gaussians to screen space
(counterpart of ``gaussian_splatting_tpu/ops/projection.py``).

EWA splatting:

    p_cam  = W_rot @ p_world + W_t
    Sigma3 = R S S^T R^T                (R from unit quat, S = diag(scales))
    Sigma_cam = W_rot Sigma3 W_rot^T
    J      = [[fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]]   (frustum-clamped)
    Sigma2 = J Sigma_cam J^T + eps2d * I                    (eps2d = 0.3)
    conic  = Sigma2^{-1}
    radius = ceil(k * sqrt(lambda_max(Sigma2)))   (k = 3, or opacity-aware)

Gaussians behind the near plane, off screen or with a degenerate covariance
get radius 0 (masked, never dropped). The arithmetic is written entry by
entry over (N,) vectors in the same order as the JAX function, so the two
agree to float32 rounding; plain PyTorch, differentiable through autograd.
"""

from typing import NamedTuple, Optional, Tuple

import torch


class Projected(NamedTuple):
    """Screen-space gaussians, leading dim N."""

    means2d: torch.Tensor        # (N, 2) pixel coords
    depths: torch.Tensor         # (N,) camera-frame z
    conics: torch.Tensor         # (N, 3) inverse 2D covariance (a, b, c)
    radii: torch.Tensor          # (N,) int32 screen radius in pixels, 0 = culled
    compensations: torch.Tensor  # (N,) antialiasing compensation factor


def _rotmat_cols(q: torch.Tensor, eps: float = 1e-12) -> Tuple[torch.Tensor, ...]:
    """The 9 row-major rotation-matrix entries of quats (w, x, y, z) as
    separate (N,) columns, normalizing the quaternion first."""
    w, x, y, z = q.unbind(-1)
    inv = 1.0 / torch.clamp_min(torch.sqrt(w * w + x * x + y * y + z * z), eps)
    w, x, y, z = w * inv, x * inv, y * inv, z * inv
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    )


def compute_cov3d_cols(quats: torch.Tensor, scales: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Upper-triangular entries (s00, s01, s02, s11, s12, s22) of
    Sigma3 = R S S^T R^T. quats raw (normalized here), scales activated."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _rotmat_cols(quats)
    v0 = scales[..., 0] * scales[..., 0]
    v1 = scales[..., 1] * scales[..., 1]
    v2 = scales[..., 2] * scales[..., 2]
    s00 = r00 * r00 * v0 + r01 * r01 * v1 + r02 * r02 * v2
    s01 = r00 * r10 * v0 + r01 * r11 * v1 + r02 * r12 * v2
    s02 = r00 * r20 * v0 + r01 * r21 * v1 + r02 * r22 * v2
    s11 = r10 * r10 * v0 + r11 * r11 * v1 + r12 * r12 * v2
    s12 = r10 * r20 * v0 + r11 * r21 * v1 + r12 * r22 * v2
    s22 = r20 * r20 * v0 + r21 * r21 * v1 + r22 * r22 * v2
    return s00, s01, s02, s11, s12, s22


def compute_cov3d(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Sigma3 as a dense (..., 3, 3) tensor (small sizes and tests; the
    render path uses the column form ``compute_cov3d_cols``)."""
    s00, s01, s02, s11, s12, s22 = compute_cov3d_cols(quats, scales)
    rows = torch.stack([s00, s01, s02, s01, s11, s12, s02, s12, s22], dim=-1)
    return rows.reshape(rows.shape[:-1] + (3, 3))


def project_gaussians(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    viewmat: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    eps2d: float = 0.3,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    opacities: Optional[torch.Tensor] = None,
) -> Projected:
    """Project N gaussians through one camera. With ``opacities`` the radius
    shrinks to where ``op * exp(-s)`` can still reach the 1/255 alpha gate
    (capped at 3 sigma): pixels outside can never pass the gate, so the
    tighter support is exact."""
    dtype = means.dtype
    R_wc = viewmat[:3, :3].to(dtype)
    t_wc = viewmat[:3, 3].to(dtype)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]

    m0, m1, m2 = means[:, 0], means[:, 1], means[:, 2]
    x = R_wc[0, 0] * m0 + R_wc[0, 1] * m1 + R_wc[0, 2] * m2 + t_wc[0]
    y = R_wc[1, 0] * m0 + R_wc[1, 1] * m1 + R_wc[1, 2] * m2 + t_wc[1]
    z = R_wc[2, 0] * m0 + R_wc[2, 1] * m1 + R_wc[2, 2] * m2 + t_wc[2]
    # Depth guard: clamp z away from 0 for the math; visibility is masked.
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)

    s00, s01, s02, s11, s12, s22 = compute_cov3d_cols(quats, scales)

    # cov_cam = R_wc Sigma3 R_wc^T, via B = Sigma3 R_wc^T then A = R_wc B.
    b00 = s00 * R_wc[0, 0] + s01 * R_wc[0, 1] + s02 * R_wc[0, 2]
    b01 = s00 * R_wc[1, 0] + s01 * R_wc[1, 1] + s02 * R_wc[1, 2]
    b02 = s00 * R_wc[2, 0] + s01 * R_wc[2, 1] + s02 * R_wc[2, 2]
    b10 = s01 * R_wc[0, 0] + s11 * R_wc[0, 1] + s12 * R_wc[0, 2]
    b11 = s01 * R_wc[1, 0] + s11 * R_wc[1, 1] + s12 * R_wc[1, 2]
    b12 = s01 * R_wc[2, 0] + s11 * R_wc[2, 1] + s12 * R_wc[2, 2]
    b20 = s02 * R_wc[0, 0] + s12 * R_wc[0, 1] + s22 * R_wc[0, 2]
    b21 = s02 * R_wc[1, 0] + s12 * R_wc[1, 1] + s22 * R_wc[1, 2]
    b22 = s02 * R_wc[2, 0] + s12 * R_wc[2, 1] + s22 * R_wc[2, 2]
    c00 = R_wc[0, 0] * b00 + R_wc[0, 1] * b10 + R_wc[0, 2] * b20
    c01 = R_wc[0, 0] * b01 + R_wc[0, 1] * b11 + R_wc[0, 2] * b21
    c02 = R_wc[0, 0] * b02 + R_wc[0, 1] * b12 + R_wc[0, 2] * b22
    c11 = R_wc[1, 0] * b01 + R_wc[1, 1] * b11 + R_wc[1, 2] * b21
    c12 = R_wc[1, 0] * b02 + R_wc[1, 1] * b12 + R_wc[1, 2] * b22
    c22 = R_wc[2, 0] * b02 + R_wc[2, 1] * b12 + R_wc[2, 2] * b22

    # Frustum-limited Jacobian: clamp x/z, y/z into 1.3x the view cone so
    # off-screen gaussians don't produce exploding covariances.
    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tx = zs * torch.clamp(x / zs, -lim_x, lim_x)
    ty = zs * torch.clamp(y / zs, -lim_y, lim_y)

    rz = 1.0 / zs
    rz2 = rz * rz
    j00 = fx * rz
    j02 = -fx * tx * rz2
    j11 = fy * rz
    j12 = -fy * ty * rz2
    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22)
    b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22)

    det_orig = a * c - b * b
    a = a + eps2d
    c = c + eps2d
    det = a * c - b * b
    det_safe = torch.where(det <= 0.0, torch.ones_like(det), det)
    compensations = torch.sqrt(torch.clamp_min(det_orig / det_safe, 0.0))

    inv_det = 1.0 / det_safe
    conics = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.01))
    lambda_max = mid + disc
    sigma_mult = torch.tensor(3.0, dtype=torch.float32, device=means.device)
    if opacities is not None:
        op = opacities.detach().reshape(-1).to(torch.float32)
        s_cut = torch.log(torch.clamp_min(op, 1e-12) * 255.0)
        sigma_mult = torch.clamp_max(torch.sqrt(2.0 * torch.clamp_min(s_cut, 1e-12)), 3.0)
    radius_f = torch.ceil(sigma_mult * torch.sqrt(torch.clamp_min(lambda_max, 0.0)))

    mean_x = fx * x * rz + cx
    mean_y = fy * y * rz + cy
    means2d = torch.stack([mean_x, mean_y], dim=-1)

    inside = (
        (mean_x + radius_f > 0)
        & (mean_x - radius_f < width)
        & (mean_y + radius_f > 0)
        & (mean_y - radius_f < height)
    )
    valid = (z > near_plane) & (z < far_plane) & (det > 0.0) & inside
    valid = valid & (radius_f > radius_clip)
    radii = torch.where(valid, radius_f, torch.zeros_like(radius_f)).to(torch.int32)

    return Projected(means2d=means2d, depths=z, conics=conics, radii=radii,
                     compensations=compensations)
