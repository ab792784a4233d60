"""Camera containers and projection conventions (counterpart of
``gaussian_splatting_tpu/core/cameras.py``).

- Poses are **world-to-camera** 4x4 matrices (``viewmat``):
  ``p_cam = W @ p_world``.
- ``K`` is the 3x3 pinhole matrix; +z looks forward, +x right, +y down,
  pixel (0, 0) at the top-left.
- Default focal heuristic: ``f = 1.2 * max(W, H)`` pixels, principal point
  at the image center.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from gaussian_splatting_tpu_torch._device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    """A pinhole camera. ``viewmat`` (..., 4, 4) world-to-camera and ``K``
    (..., 3, 3) intrinsics in pixels; a batch stacks along leading axes."""

    viewmat: torch.Tensor
    K: torch.Tensor
    width: int
    height: int

    @property
    def cam_to_world(self) -> torch.Tensor:
        R = self.viewmat[..., :3, :3]
        t = self.viewmat[..., :3, 3]
        Rt = R.transpose(-1, -2)
        pos = -torch.einsum("...ij,...j->...i", Rt, t)
        top = torch.cat([Rt, pos[..., :, None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                              device=top.device).expand(top.shape[:-2] + (1, 4))
        return torch.cat([top, bottom], dim=-2)

    @property
    def position(self) -> torch.Tensor:
        """Camera center in world coordinates: -R^T t."""
        R = self.viewmat[..., :3, :3]
        t = self.viewmat[..., :3, 3]
        return -torch.einsum("...ji,...j->...i", R, t)

    @property
    def focal(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.K[..., 0, 0], self.K[..., 1, 1]


def projection_matrix(K: torch.Tensor, width: int, height: int, znear: float = 0.01,
                      zfar: float = 100.0) -> torch.Tensor:
    """OpenGL-style (..., 4, 4) projection matrix from (..., 3, 3)
    pinhole intrinsics, built as the JAX package builds it, so exported
    viewpoints mean the same in both."""
    fx, fy, cx, cy = K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    rows = [
        torch.stack([2 * fx / width, zero, 2 * cx / width - 1, zero], dim=-1),
        torch.stack([zero, 2 * fy / height, 2 * cy / height - 1, zero], dim=-1),
        torch.stack([zero, zero, one * zfar / (zfar - znear),
                     -one * zfar * znear / (zfar - znear)], dim=-1),
        torch.stack([zero, zero, one, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def focal_from_heuristic(width: int, height: int, focal_35mm: float | None = None) -> float:
    """COLMAP-style focal prior in pixels: ``(f35 / 36) * max(W, H)`` with a
    35mm-equivalent focal length, else ``1.2 * max(W, H)``."""
    m = float(max(width, height))
    if focal_35mm is not None:
        return (float(focal_35mm) / 36.0) * m
    return 1.2 * m


def make_intrinsics(width: int, height: int, focal_px: float | None = None,
                    focal_35mm: float | None = None,
                    device: DeviceLike = None) -> torch.Tensor:
    """A 3x3 K from the focal heuristic with the principal point at the
    image center."""
    f = (float(focal_px) if focal_px is not None
         else focal_from_heuristic(width, height, focal_35mm))
    return torch.tensor(
        [[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=resolve_device(device))


def look_at(eye, target, up=(0.0, 1.0, 0.0), device: DeviceLike = None) -> torch.Tensor:
    """World-to-camera viewmat looking from ``eye`` to ``target`` (+z
    forward, +y down in the camera frame: the OpenCV convention)."""
    dev = resolve_device(device)

    def vec(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    eye, target, up = vec(eye), vec(target), vec(up)
    fwd = target - eye
    fwd = fwd / torch.clamp_min(torch.linalg.norm(fwd), 1e-12)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.clamp_min(torch.linalg.norm(right), 1e-12)
    down = torch.linalg.cross(fwd, right)
    R = torch.stack([right, down, fwd], dim=0)  # rows = camera axes in world
    view = torch.eye(4, dtype=torch.float32, device=dev)
    view[:3, :3] = R
    view[:3, 3] = -R @ eye
    return view
