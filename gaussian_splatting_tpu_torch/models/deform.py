"""Deformable 3D Gaussians (Yang et al., CVPR 2024, arXiv 2309.13101): a
deformation MLP that maps each canonical gaussian's position and a view's
time to offsets of its mean, rotation and scale.

    gamma(p) = (p, sin(2^k p), cos(2^k p) for k = 0 .. L-1)   (no pi, as the code)
    h_0      = (gamma(x), gamma(t))                              84 channels at L 10, 10
    h_{i+1}  = relu(W_i h_i + b_i), i = 0 .. D-1, with (gamma(x), gamma(t), h)
               fed again after linear ``skip`` (D // 2)
    dx, dr, ds = three linear heads of h_D (3, 4 and 3 outputs)

The renderer applies them after the activations (``ops/project_sh.py``):
mean + dx, exp(log s) + ds, normalize(q) + dr (4D Gaussian Splatting's
offsets, ``models/hexplane.py``, are added before them). The position fed
to gamma is detached: no gradient reaches the means through the MLP.

The network is a dict of tensors under the published module's names
(``linear.<i>.weight`` (out, in), ``linear.<i>.bias``, ``gaussian_warp.*``,
``gaussian_rotation.*``, ``gaussian_scaling.*``), initialised as
``torch.nn.Linear`` initialises from a seeded generator. Its GEMMs are
float32 (PyTorch's default; TF32 changes the offsets at the 1e-3 level).
The three heads run as one (W, 10) GEMM. ``DeformState`` holds the network
and its Adam moments; the training step updates it with the gaussians'
Adam step counter (``training/step.py``). Spans: ``deform.mlp`` (the
forward a view) and ``deform.mlp.bwd`` (its backward); counter
``deform.rows`` (the rows through the MLP a view).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gaussian_splatting_tpu_torch._device import DeviceLike, resolve_device
from gaussian_splatting_tpu_torch.training.optimizer import exp_lr_decay
from gaussian_splatting_tpu_torch.utils import profiling

HEADS = (("gaussian_warp", 3), ("gaussian_rotation", 4), ("gaussian_scaling", 3))
# The published schedules: the MLP's rate starts at the position rate's
# start times the code's spatial_lr_scale and decays over deform_lr_max_steps;
# the annealing noise (smooth_term) falls from 0.1 frame intervals to 0.
LR_SCALE = 5.0
LR_MAX_STEPS = 40_000
TIME_NOISE = 0.1
TIME_NOISE_STEPS = 20_000


@dataclasses.dataclass(frozen=True)
class DeformSpec:
    """The network's shape: ``depth`` linears of ``width`` with the input
    fed again after linear ``skip``, and the encodings' frequencies. The
    defaults are the published network's, the one the trainer builds."""

    depth: int = 8
    width: int = 256
    skip: int = 4
    multires_x: int = 10
    multires_t: int = 10

    @property
    def in_x(self) -> int:
        return 3 * (1 + 2 * self.multires_x)

    @property
    def in_t(self) -> int:
        return 1 + 2 * self.multires_t

    @property
    def in_ch(self) -> int:
        return self.in_x + self.in_t

    def shapes(self) -> List[Tuple[str, Tuple[int, ...]]]:
        """(name, shape) of every tensor, in order."""
        out = []
        for i in range(self.depth):
            fan_in = (self.in_ch if i == 0 else
                      self.width + self.in_ch if i == self.skip + 1 else self.width)
            out += [(f"linear.{i}.weight", (self.width, fan_in)),
                    (f"linear.{i}.bias", (self.width,))]
        for name, k in HEADS:
            out += [(f"{name}.weight", (k, self.width)), (f"{name}.bias", (k,))]
        return out

    def macs_per_row(self) -> int:
        """Multiply-adds of one row's forward."""
        return sum(s[0] * s[1] for _, s in self.shapes() if len(s) == 2)


def init_params(spec: DeformSpec, seed: int = 0, device: DeviceLike = None
                ) -> Dict[str, torch.Tensor]:
    """The network's tensors as ``torch.nn.Linear`` initialises them
    (weight and bias uniform in +-1/sqrt(fan_in)), drawn on the host from a
    generator seeded ``seed``, in ``spec.shapes()`` order."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    out = {}
    fan_in = None
    for name, shape in spec.shapes():
        if name.endswith(".weight"):
            fan_in = shape[1]
        bound = 1.0 / math.sqrt(fan_in)
        out[name] = (torch.rand(shape, generator=g, dtype=torch.float32) * 2.0 - 1.0) * bound
    return {k: v.to(dev) for k, v in out.items()}


def encode(p: torch.Tensor, multires: int) -> torch.Tensor:
    """gamma(p): (R, c) -> (R, c (1 + 2 L)), the NeRF embedder's order: p,
    then sin and cos of 2^k p for k = 0 .. L-1."""
    parts = [p]
    for k in range(multires):
        q = p * float(2 ** k)
        parts += [torch.sin(q), torch.cos(q)]
    return torch.cat(parts, dim=-1)


def mlp(params: Dict[str, torch.Tensor], spec: DeformSpec, x: torch.Tensor,
        t) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx (R, 3), dr (R, 4), ds (R, 3)) of positions ``x`` (R, 3) at time
    ``t`` (a float or a 0-dim tensor, the same for every row).
    Differentiable in ``params``; ``x`` is taken as it is given."""
    R = x.shape[0]
    tt = torch.as_tensor(t, dtype=x.dtype, device=x.device).reshape(1, 1)
    inp = torch.cat([encode(x, spec.multires_x),
                     encode(tt, spec.multires_t).expand(R, -1)], dim=-1)
    h = inp
    for i in range(spec.depth):
        h = F.relu(F.linear(h, params[f"linear.{i}.weight"], params[f"linear.{i}.bias"]),
                   inplace=True)
        if i == spec.skip:
            h = torch.cat([inp, h], dim=-1)
    w = torch.cat([params[f"{n}.weight"] for n, _ in HEADS])
    b = torch.cat([params[f"{n}.bias"] for n, _ in HEADS])
    out = F.linear(h, w, b)
    return out[:, :3], out[:, 3:7], out[:, 7:]


def offsets(params: Dict[str, torch.Tensor], spec: DeformSpec, means: torch.Tensor,
            rows: Optional[torch.Tensor], t):
    """The (N, 3), (N, 4), (N, 3) offsets of a buffer of N slots at time
    ``t``: the MLP over the slots ``rows`` (all where None) of the detached
    ``means``, zero elsewhere. Span ``deform.mlp``, its backward
    ``deform.mlp.bwd``; counts ``deform.rows``."""
    x = means.detach()
    n = x.shape[0]
    with profiling.annotate("deform.mlp"):
        mark = profiling.grad_span("deform.mlp.bwd")
        if rows is not None:
            x = x.index_select(0, rows)
        profiling.count("deform.rows", x.shape[0])
        # The span closes when the gradient reaches the first linear's
        # weight, the last the backward computes.
        p = dict(params)
        p["linear.0.weight"] = mark.input(params["linear.0.weight"])
        out = mark.outputs(*mlp(p, spec, x, t))
        if rows is None:
            return out
        return tuple(o.new_zeros((n, o.shape[1])).index_copy(0, rows, o) for o in out)


@dataclasses.dataclass
class DeformState:
    """The network, its Adam moments (the step counter is the gaussians'),
    and its shape."""

    params: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    spec: DeformSpec


def deform_state_init(spec: DeformSpec, seed: int = 0, device: DeviceLike = None
                      ) -> DeformState:
    params = init_params(spec, seed, device)
    return DeformState(params=params, mu={k: torch.zeros_like(v) for k, v in params.items()},
                       nu={k: torch.zeros_like(v) for k, v in params.items()}, spec=spec)


def lr_schedule(config, iteration: torch.Tensor) -> torch.Tensor:
    """The published rate: exponential decay from LR_SCALE x the position
    rate's start to the position rate's end over LR_MAX_STEPS."""
    return exp_lr_decay(iteration, LR_SCALE * config.position_lr_init,
                        config.position_lr_final, LR_MAX_STEPS)


def time_noise_scale(iteration: int, n_frames: int) -> float:
    """The annealing noise's standard deviation at ``iteration``: the frame
    interval 1 / n_frames times TIME_NOISE, falling linearly to zero at
    TIME_NOISE_STEPS."""
    if iteration >= TIME_NOISE_STEPS:
        return 0.0
    return TIME_NOISE * (1.0 - iteration / float(TIME_NOISE_STEPS)) / max(n_frames, 1)


_SPEC_FIELDS = ("depth", "width", "skip", "multires_x", "multires_t")


def to_numpy(state: DeformState) -> Dict[str, np.ndarray]:
    """The checkpoint's arrays: ``deform/params/<name>``,
    ``deform/adam_mu/<name>``, ``deform/adam_nu/<name>`` and ``deform/spec``
    (depth, width, skip, multires_x, multires_t)."""
    out = {"deform/spec": np.asarray([getattr(state.spec, f) for f in _SPEC_FIELDS],
                                     np.int32)}
    for k in state.params:
        out[f"deform/params/{k}"] = state.params[k].detach().cpu().numpy()
        out[f"deform/adam_mu/{k}"] = state.mu[k].detach().cpu().numpy()
        out[f"deform/adam_nu/{k}"] = state.nu[k].detach().cpu().numpy()
    return out


def from_numpy(arrays: Dict[str, np.ndarray], device: DeviceLike = None
               ) -> Optional[DeformState]:
    """The ``DeformState`` in a checkpoint's arrays, or None without one."""
    if not any(k.startswith("deform/params/") for k in arrays):
        return None
    dev = resolve_device(device)

    def tab(prefix):
        return {k[len(prefix):]: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                for k, v in arrays.items() if k.startswith(prefix)}

    params = tab("deform/params/")
    spec = DeformSpec(*(int(v) for v in np.asarray(arrays["deform/spec"]).reshape(-1)))
    order = [n for n, _ in spec.shapes()]
    mu, nu = tab("deform/adam_mu/"), tab("deform/adam_nu/")
    return DeformState(params={k: params[k] for k in order}, mu={k: mu[k] for k in order},
                       nu={k: nu[k] for k in order}, spec=spec)
