"""Adam with per-parameter-group learning rates and spliceable moments
(counterpart of ``gaussian_splatting_tpu/training/optimizer.py``).

Plain tensor code rather than ``torch.optim.Adam``: densification splices
moment rows of reused slots, and ``torch.optim.Adam`` keeps a step counter
per parameter where this optimizer keeps one shared counter (the groups
step in lockstep, so it is equivalent, including fresh rows inheriting the
global bias correction). The update is
``p - lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``, eps 1e-15.
"""

from __future__ import annotations

import dataclasses

import torch

from gaussian_splatting_tpu_torch.models.gaussians import PARAM_KEYS, GaussianParams


@dataclasses.dataclass
class AdamState:
    mu: GaussianParams
    nu: GaussianParams
    step: torch.Tensor  # () int32


def adam_init(params: GaussianParams) -> AdamState:
    def zeros():
        return GaussianParams(**{k: torch.zeros_like(getattr(params, k))
                                 for k in PARAM_KEYS})

    return AdamState(mu=zeros(), nu=zeros(),
                     step=torch.zeros((), dtype=torch.int32, device=params.means.device))


def group_lrs(config, xyz_lr) -> GaussianParams:
    """Per-group learning rates, GaussianParams-shaped; ``xyz_lr`` follows
    the exponential decay schedule."""
    return GaussianParams(
        means=xyz_lr,
        quats=config.lr_rotation,
        log_scales=config.lr_scaling,
        logit_opacities=config.lr_opacity,
        features_dc=config.lr_features_dc,
        features_rest=config.lr_features_rest,
    )


def adam_bias_corrections(step: torch.Tensor, b1: float, b2: float):
    """(1 - b1^t, 1 - b2^t) in float32 for the step counter t."""
    t = step.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=step.device)
    return 1.0 - (one * b1) ** t, 1.0 - (one * b2) ** t


@torch.no_grad()
def adam_update(grads: GaussianParams, state: AdamState, params: GaussianParams,
                lrs: GaussianParams, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-15):
    """One Adam step of every group, in place: ``params``, ``state.mu``,
    ``state.nu`` and ``state.step`` are updated where they lie (no copies of
    the 1M-row tensors) and returned as ``(params, state)``."""
    state.step += 1
    c1, c2 = adam_bias_corrections(state.step, b1, b2)
    for k in PARAM_KEYS:
        g, p = getattr(grads, k), getattr(params, k)
        m, v = getattr(state.mu, k), getattr(state.nu, k)
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * g * g)
        p.sub_(getattr(lrs, k) * (m / c1) / (torch.sqrt(v / c2) + eps))
    return params, state


def xyz_lr_schedule(config, iteration: torch.Tensor) -> torch.Tensor:
    """Exponential decay from position_lr_init to position_lr_final over
    position_lr_max_steps."""
    progress = torch.clamp_max(
        iteration.to(torch.float32) / float(config.position_lr_max_steps), 1.0)
    ratio = config.position_lr_final / config.position_lr_init
    return config.position_lr_init * torch.pow(torch.full_like(progress, ratio), progress)
