"""Gaussian parameter container, initialization and capacity growth
(counterpart of ``gaussian_splatting_tpu/models/gaussians.py``).

The population lives in fixed-capacity buffers with an ``alive`` mask; dead
slots render with opacity ~0; densification fills free slots
(``models/densify.py``) and the trainer grows the buffers when they are
nearly full (``grow_capacity``). Raw parameterization: log-space scales,
logit-space opacity, w-first unnormalized quaternions, SH split into dc
(C, 1, 3) + rest (C, 15, 3). A surfel scene (2D Gaussian Splatting,
``ops/surfel.py``) has two log-scales a row, (C, 2): the shape says what the
scene holds, in every buffer, checkpoint and PLY.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from gaussian_splatting_tpu_torch._device import DeviceLike, resolve_device
from gaussian_splatting_tpu_torch.core.activations import opacity_inverse_activation
from gaussian_splatting_tpu_torch.core.sh import rgb_to_sh0

NEG_INF_LOGIT = -20.0  # sigmoid(-20) ~ 2e-9: dead-slot opacity

PARAM_KEYS = ("means", "quats", "log_scales", "logit_opacities",
              "features_dc", "features_rest")


@dataclasses.dataclass
class GaussianParams:
    """Trainable parameters; every field has leading dim = capacity."""

    means: torch.Tensor            # (C, 3)
    quats: torch.Tensor            # (C, 4) w-first, unnormalized
    log_scales: torch.Tensor       # (C, 3), (C, 2) for surfels
    logit_opacities: torch.Tensor  # (C, 1)
    features_dc: torch.Tensor      # (C, 1, 3)
    features_rest: torch.Tensor    # (C, 15, 3)

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def surfels(self) -> bool:
        """Whether the scene holds surfels (two scales a row)."""
        return self.log_scales.shape[-1] == 2

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


def _round_capacity(n: int, multiple: int = 2048) -> int:
    return max(((n + multiple - 1) // multiple) * multiple, multiple)


def empty_state(capacity: int, device: DeviceLike = None,
                dtype: torch.dtype = torch.float32, surfels: bool = False) -> GaussianState:
    """An all-dead buffer of ``capacity`` slots; ``surfels`` gives two
    log-scales a row."""
    C = capacity
    dev = resolve_device(device)

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    quats = z(C, 4)
    quats[:, 0] = 1.0
    params = GaussianParams(
        means=z(C, 3), quats=quats,
        log_scales=torch.full((C, 2 if surfels else 3), -3.0, dtype=dtype, device=dev),
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


def init_random(n: int, capacity: Optional[int] = None, seed: int = 0,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, surfels: bool = False) -> GaussianState:
    """Random init fallback (``models/gaussians.py:106`` of the JAX
    package): ``n`` alive gaussians with standard-normal means and opacity
    0.005 in a buffer of ``capacity`` (default 1.5 n rounded up to 2048).
    The means come from ``generator`` (default: one on ``device`` seeded
    with ``seed``); ``jax.random`` streams are not reproduced. ``surfels``
    makes surfels (identity rotations)."""
    dev = resolve_device(device)
    C = capacity or _round_capacity(int(n * 1.5))
    state = empty_state(C, dev, surfels=surfels)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    p = state.params
    p.means[:n] = torch.randn((n, 3), generator=generator, device=generator.device,
                              dtype=torch.float32).to(dev)
    p.logit_opacities[:n] = opacity_inverse_activation(
        torch.full((n, 1), 0.005, dtype=torch.float32, device=dev))
    state.alive[:n] = True
    return state


def knn_mean_distance(points: np.ndarray, queries: np.ndarray, k: int = 7) -> np.ndarray:
    """Mean distance to the k-1 nearest neighbors (excluding self): the
    port's native grid-hash kNN (``utils/native.py``), scipy KD-tree when it
    is unavailable. Init-time only, on the host."""
    from gaussian_splatting_tpu_torch.utils.native import knn_mean_distance as _knn

    return _knn(points, queries, k=min(k, len(points)))


def init_from_points(points: np.ndarray, colors: Optional[np.ndarray], n_gaussians: int,
                     capacity: Optional[int] = None, seed: int = 0,
                     init_opacity: float = 0.005, jitter: float = 1e-3,
                     device: DeviceLike = None, surfels: bool = False) -> GaussianState:
    """Initialize from a point cloud (``models/gaussians.py:135`` of the
    JAX package, the same numpy draws from ``default_rng(seed)``): sample
    points (with replacement when oversampling), add positional jitter,
    RGB -> SH0 DC coefficients, kNN-7 mean-distance isotropic scales,
    opacity ``init_opacity``, identity rotations, in a buffer of
    ``capacity`` (default 1.5 n rounded up to 2048) on ``device``.
    ``surfels`` makes surfels: two scales a row and, after the draws above,
    quaternions of uniform [0, 1) components (the published 2DGS
    initialisation's random orientations)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_pts = len(points)
    if n_pts == 0:
        raise ValueError("init_from_points needs at least one point")
    if n_gaussians <= n_pts:
        idx = rng.permutation(n_pts)[:n_gaussians]
    else:
        idx = rng.integers(0, n_pts, size=n_gaussians)
    pos = points[idx] + rng.normal(size=(n_gaussians, 3)) * jitter

    scales = np.clip(knn_mean_distance(points.astype(np.float64), pos, k=7), 1e-9, None)
    log_scales = np.log(scales)[:, None].repeat(2 if surfels else 3, axis=1)

    C = capacity or _round_capacity(int(n_gaussians * 1.5))
    state = empty_state(C, dev, surfels=surfels)
    p = state.params
    n = n_gaussians
    p.means[:n] = torch.as_tensor(np.asarray(pos, np.float32), device=dev)
    p.log_scales[:n] = torch.as_tensor(np.asarray(log_scales, np.float32), device=dev)
    p.logit_opacities[:n] = opacity_inverse_activation(
        torch.full((n, 1), init_opacity, dtype=torch.float32, device=dev))
    if colors is not None and len(colors) > 0:
        p.features_dc[:n, 0, :] = rgb_to_sh0(
            torch.as_tensor(np.asarray(colors[idx], np.float32), device=dev))
    if surfels:
        p.quats[:n] = torch.as_tensor(rng.random((n, 4)).astype(np.float32), device=dev)
    state.alive[:n] = True
    return state


def grow_capacity(state: GaussianState, new_capacity: int) -> GaussianState:
    """Capacity growth: every buffer zero-padded to ``new_capacity`` rows,
    the new slots' quaternions the identity (``models/gaussians.py:185`` of
    the JAX package). Returns a new state; ``state`` is not changed."""
    C_old = state.capacity
    if new_capacity <= C_old:
        raise ValueError(f"new capacity {new_capacity} must exceed {C_old}")

    def pad(x):
        out = x.new_zeros((new_capacity,) + tuple(x.shape[1:]))
        out[:C_old] = x
        return out

    params = GaussianParams(**{k: pad(getattr(state.params, k)) for k in PARAM_KEYS})
    params.quats[C_old:, 0] = 1.0
    return GaussianState(params=params, alive=pad(state.alive),
                         xyz_grad_accum=pad(state.xyz_grad_accum),
                         xyz_grad_count=pad(state.xyz_grad_count),
                         max_radii2d=pad(state.max_radii2d))


_STATE_KEYS = ("alive", "xyz_grad_accum", "xyz_grad_count", "max_radii2d")
_POSE_KEYS = ("deltas", "mu", "nu")


def train_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """A training state (``training.step.TrainState``) as numpy arrays,
    under the keys of the JAX package's ``.npz`` checkpoints:
    ``params/<k>``, ``adam_mu/<k>``, ``adam_nu/<k>`` for the six parameter
    groups, ``alive``, ``xyz_grad_accum``, ``xyz_grad_count``,
    ``max_radii2d``, ``adam_step``, ``iteration``, with pose refinement
    ``poses/deltas``, ``poses/mu``, ``poses/nu``, and with a deformation
    network ``deform/params/<name>``, ``deform/adam_mu/<name>``,
    ``deform/adam_nu/<name>`` or with a HexPlane field ``hexplane/...``
    (``models/hexplane.py::to_numpy``; the port's own keys)."""
    def npy(t):
        return t.detach().cpu().numpy()

    out = {}
    for k in PARAM_KEYS:
        out[f"params/{k}"] = npy(getattr(state.gauss.params, k))
        out[f"adam_mu/{k}"] = npy(getattr(state.opt.mu, k))
        out[f"adam_nu/{k}"] = npy(getattr(state.opt.nu, k))
    for k in _STATE_KEYS:
        out[k] = npy(getattr(state.gauss, k))
    out["adam_step"] = npy(state.opt.step)
    out["iteration"] = npy(state.iteration)
    if state.poses is not None:
        for k in _POSE_KEYS:
            out[f"poses/{k}"] = npy(getattr(state.poses, k))
    if getattr(state, "deform", None) is not None:
        from gaussian_splatting_tpu_torch.models import deform, hexplane

        mod = hexplane if isinstance(state.deform, hexplane.HexPlaneState) else deform
        out.update(mod.to_numpy(state.deform))
    return out


def train_state_from_numpy(arrays: Dict[str, np.ndarray], device: DeviceLike = None):
    """The ``training.step.TrainState`` on ``device`` (CUDA unless given)
    from numpy arrays under the keys ``train_state_to_numpy`` writes (the
    JAX checkpoint's keys): parameters, Adam moments and step, iteration,
    the densify accumulators, when ``poses/deltas`` is present the pose
    corrections, and when ``deform/params/*`` (or ``hexplane/*``) are the
    deformation network (or field) and its moments. This is how a JAX
    training state, or a checkpoint, enters the port."""
    from gaussian_splatting_tpu_torch.models.deform import from_numpy as deform_from_numpy
    from gaussian_splatting_tpu_torch.models.hexplane import from_numpy as hexplane_from_numpy
    from gaussian_splatting_tpu_torch.training.optimizer import AdamState
    from gaussian_splatting_tpu_torch.training.step import PoseState, TrainState

    dev = resolve_device(device)
    gauss = state_from_numpy({**{k: arrays[f"params/{k}"] for k in PARAM_KEYS},
                              **{k: arrays[k] for k in _STATE_KEYS}}, dev)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=dev)

    def moments(prefix):
        return GaussianParams(**{k: f32(arrays[f"{prefix}/{k}"]) for k in PARAM_KEYS})

    poses = (PoseState(*(f32(arrays[f"poses/{k}"]) for k in _POSE_KEYS))
             if "poses/deltas" in arrays else None)
    return TrainState(gauss=gauss,
                      opt=AdamState(mu=moments("adam_mu"), nu=moments("adam_nu"),
                                    step=i32(arrays["adam_step"])),
                      iteration=i32(arrays["iteration"]), poses=poses,
                      deform=(deform_from_numpy(arrays, dev)
                              or hexplane_from_numpy(arrays, dev)))
