"""Gaussian parameter container (counterpart of ``gaussian_splatting_tpu/
models/gaussians.py``).

The population lives in fixed-capacity buffers with an ``alive`` mask; dead
slots render with opacity ~0. Raw parameterization: log-space scales,
logit-space opacity, w-first unnormalized quaternions, SH split into dc
(C, 1, 3) + rest (C, 15, 3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from gaussian_splatting_tpu_torch._device import DeviceLike, resolve_device

NEG_INF_LOGIT = -20.0  # sigmoid(-20) ~ 2e-9: dead-slot opacity

PARAM_KEYS = ("means", "quats", "log_scales", "logit_opacities",
              "features_dc", "features_rest")


@dataclasses.dataclass
class GaussianParams:
    """Trainable parameters; every field has leading dim = capacity."""

    means: torch.Tensor            # (C, 3)
    quats: torch.Tensor            # (C, 4) w-first, unnormalized
    log_scales: torch.Tensor       # (C, 3)
    logit_opacities: torch.Tensor  # (C, 1)
    features_dc: torch.Tensor      # (C, 1, 3)
    features_rest: torch.Tensor    # (C, 15, 3)

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def sh_coeffs(self) -> torch.Tensor:
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def masked_opacities(self, alive: torch.Tensor) -> torch.Tensor:
        """Logit opacities with dead slots clamped to ~0 opacity."""
        return torch.where(alive[:, None], self.logit_opacities,
                           torch.full_like(self.logit_opacities, NEG_INF_LOGIT))


@dataclasses.dataclass
class GaussianState:
    """Parameters plus the densification bookkeeping buffers."""

    params: GaussianParams
    alive: torch.Tensor           # (C,) bool
    xyz_grad_accum: torch.Tensor  # (C, 3)
    xyz_grad_count: torch.Tensor  # (C, 1)
    max_radii2d: torch.Tensor     # (C,) int32

    @property
    def capacity(self) -> int:
        return self.params.capacity

    def n_alive(self) -> torch.Tensor:
        return torch.sum(self.alive.to(torch.int32))


def empty_state(capacity: int, device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> GaussianState:
    C = capacity
    dev = resolve_device(device)

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    quats = z(C, 4)
    quats[:, 0] = 1.0
    params = GaussianParams(
        means=z(C, 3), quats=quats,
        log_scales=torch.full((C, 3), -3.0, dtype=dtype, device=dev),
        logit_opacities=z(C, 1), features_dc=z(C, 1, 3),
        features_rest=z(C, 15, 3))
    return GaussianState(params=params, alive=z(C, dt=torch.bool),
                         xyz_grad_accum=z(C, 3), xyz_grad_count=z(C, 1),
                         max_radii2d=z(C, dt=torch.int32))


def state_from_numpy(arrays: Dict[str, np.ndarray],
                     device: DeviceLike = None) -> GaussianState:
    """A GaussianState on ``device`` from numpy arrays named like the JAX
    package's fields: the six ``PARAM_KEYS`` (required), and optionally
    ``alive`` (default: all alive), ``xyz_grad_accum``, ``xyz_grad_count``
    and ``max_radii2d`` (default: zeros). This is how parameters made or
    trained by the JAX package enter the port."""
    dev = resolve_device(device)
    missing = [k for k in PARAM_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"state_from_numpy: missing parameter arrays {missing}")
    params = GaussianParams(**{
        k: torch.as_tensor(np.asarray(arrays[k], np.float32), device=dev)
        for k in PARAM_KEYS})
    C = params.capacity
    for k in PARAM_KEYS:
        if getattr(params, k).shape[0] != C:
            raise ValueError(f"{k} has {getattr(params, k).shape[0]} rows, means has {C}")

    def opt(name, shape, dt):
        if name in arrays:
            return torch.as_tensor(np.asarray(arrays[name]), dtype=dt, device=dev)
        return torch.zeros(shape, dtype=dt, device=dev)

    alive = (torch.as_tensor(np.asarray(arrays["alive"], bool), device=dev)
             if "alive" in arrays else torch.ones((C,), dtype=torch.bool, device=dev))
    return GaussianState(
        params=params, alive=alive,
        xyz_grad_accum=opt("xyz_grad_accum", (C, 3), torch.float32),
        xyz_grad_count=opt("xyz_grad_count", (C, 1), torch.float32),
        max_radii2d=opt("max_radii2d", (C,), torch.int32))
