"""SE(3) exponential map for differentiable camera-pose refinement
(counterpart of ``gaussian_splatting_tpu/core/se3.py``).

A delta xi = (omega, upsilon) in R^6 corrects a world-to-camera matrix by
LEFT multiplication in the camera frame:

    viewmat' = exp([xi]) @ viewmat,
    exp([xi]) = [[R(omega), V(omega) upsilon], [0, 1]]

with R = Rodrigues(omega) and V the left Jacobian of SO(3). Small angles
take Taylor branches, so a zero delta gives the identity with zero (not
NaN) gradients.
"""

from __future__ import annotations

import torch


def _hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric cross-product matrix."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map se(3) -> SE(3). xi (..., 6) = (omega, upsilon);
    returns (..., 4, 4). The untaken branch's denominators are replaced by 1
    before dividing, since ``torch.where`` passes gradients through both."""
    omega = xi[..., 0:3]
    ups = xi[..., 3:6]
    th2 = (omega * omega).sum(-1)[..., None, None]
    small = th2 < 1e-8
    th2_safe = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2_safe)

    K = _hat(omega)
    K2 = K @ K
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)

    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2_safe)
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (1.0 - a) / th2_safe)

    R = eye + a * K + b * K2
    V = eye + b * K + c * K2
    t = (V @ ups[..., None])[..., 0]

    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=xi.dtype,
                          device=xi.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def apply_pose_delta(viewmat: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiply the world-to-camera ``viewmat`` (4, 4) by exp(xi): a
    correction of the camera itself in its own frame."""
    return se3_exp(xi) @ viewmat


def se3_log_rot_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation angle (radians) of (..., 3, 3) rotation matrices: the
    geodesic rotation error between two poses."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
