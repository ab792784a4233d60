"""The plain reference of 4D Gaussian Splatting (Wu et al., CVPR 2024, arXiv
2310.08528; code ``github.com/hustvl/4DGaussians``: ``scene/hexplane.py``,
``scene/deformation.py``, ``arguments/dynerf/default.py``) in plain float32
PyTorch, written from the paper and its code, apart from the port: it
imports nothing of ``ops/`` or ``csrc/`` and no JAX.

- The coordinates: x^ = (x - a_min) (2 / (a_max - a_min)) - 1 of a fixed box,
  the view's time t appended as it is (in [0, 1], no annealing noise).
- The HexPlane field, as the K-Planes wrapper samples it: scales [1, 2],
  six planes a scale over the pairs of (x, y, z, t) in
  ``itertools.combinations(range(4), 2)`` order, each (1, 16, R_j, R_i)
  with R = 64 s in space and 150 in time, sampled by
  ``F.grid_sample(align_corners=True, padding_mode="border")``; a scale's
  feature is 1. times the six samples, left to right; the scales'
  features are concatenated (32 channels).
- The decoder (``defor_depth`` 0, ``net_width`` 64): h = Linear(32, 64) of
  the feature; each head (pos 3, scales 3, rotations 4) is ReLU,
  Linear(64, 64), ReLU, Linear(64, k) of h, run one by one.
- The offsets before the activations: mean + dx, log-scales + ds,
  quaternion + dr, normalized by the renderer; the means are not detached.
- The regularizers (``compute_regulation``): plane_tv_weight 2e-4 times the
  spatial planes' (xy, xz, yz) mean squared second difference along their
  rows, time_smoothness_weight 1e-3 times the time planes' (xt, yt, zt),
  l1_time_planes 1e-4 times the time planes' mean |1 - P|, summed over the
  scales.
- A training step: the photometric loss of each view rendered by the
  caller's ``render_fn`` from the deformed gaussians, the scale-ratio hinge
  on the canonical scales, the regularizers, one backward, Adam on the six
  groups, the planes (rate ``grid``) and the decoder (rate
  ``deformation``) with one shared step counter, the scale ceiling.

Recalled, not checked against the published code offline: the widths,
resolutions and weights above, the rates (grid_lr 1.6e-3 -> 1.6e-4,
deformation_lr 1.6e-4 -> 1.6e-5, both times the scene extent, over 20k
iterations of the fine stage), the init (spatial planes uniform in [0.1,
0.5], time planes ones; linears' weights Xavier-uniform, biases as
``torch.nn.Linear``) and the box formula.

Departures from the published code, each kept because the port does the
same:
- the planes are held channel-last, (R_j, R_i, 16); ``published`` gives the
  code's (1, 16, R_j, R_i) view;
- the scale-ratio hinge and the scale ceiling are the port's own and stay
  on, as in every cell of the port;
- the densify statistic is the 3D mean's gradient norm (the code's is the
  screen-space one), as the static port accumulates it.

``torch.backends.cuda.matmul.allow_tf32`` and ``cudnn.allow_tf32`` are set
False on import: the reference's matrix products are float32.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from gaussian_splatting_tpu_torch.models.deform_ref import (
    PARAM_KEYS,
    RenderFn,
    exp_lr,
    photometric,
    scale_reg,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PAIRS = list(itertools.combinations(range(4), 2))
SCALES = (1, 2)
HEADS = (("pos_deform", 3), ("scales_deform", 3), ("rotations_deform", 4))
PLANE_TV_WEIGHT, TIME_SMOOTHNESS_WEIGHT, L1_TIME_PLANES_WEIGHT = 2e-4, 1e-3, 1e-4


def published(plane: torch.Tensor) -> torch.Tensor:
    """The code's (1, C, R_j, R_i) parameter of a channel-last plane."""
    return plane.permute(2, 0, 1)[None]


def grid_sample_wrapper(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """K-Planes' ``grid_sample_wrapper`` for a 2D grid: (N, 2) -> (N, C)."""
    n = coords.shape[0]
    interp = F.grid_sample(grid, coords.view(1, 1, n, 2), align_corners=True, mode="bilinear",
                           padding_mode="border")
    return interp.view(grid.shape[1], n).transpose(0, 1)


def field(params: Dict[str, torch.Tensor], pts: torch.Tensor) -> torch.Tensor:
    """``interpolate_ms_features`` of ``pts`` (N, 4) = (x^, t): (N, 32)."""
    feats = []
    for s in range(len(SCALES)):
        interp = 1.0
        for p, (i, j) in enumerate(PAIRS):
            grid = published(params[f"grids.{s}.{p}"])
            interp = interp * grid_sample_wrapper(grid, pts[:, [i, j]])
        feats.append(interp)
    return torch.cat(feats, dim=-1)


def normalize_aabb(x: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    return (x - box[0]) * (2.0 / (box[1] - box[0])) - 1.0


def decoder(params: Dict[str, torch.Tensor], feat: torch.Tensor):
    """(dx, ds, dr): ``feature_out`` then each head run one by one."""
    h = F.linear(feat, params["feature_out.0.weight"], params["feature_out.0.bias"])
    out = []
    for n, _ in HEADS:
        z = F.relu(F.linear(F.relu(h), params[f"{n}.1.weight"], params[f"{n}.1.bias"]))
        out.append(F.linear(z, params[f"{n}.3.weight"], params[f"{n}.3.bias"]))
    return tuple(out)


def offsets(params: Dict[str, torch.Tensor], box: torch.Tensor, x: torch.Tensor, t: float):
    """(dx, dr, ds) of the means ``x`` (N, 3) at time ``t``, differentiable
    in ``x``."""
    pts = torch.cat([normalize_aabb(x, box),
                     torch.full((x.shape[0], 1), float(t), dtype=x.dtype, device=x.device)], -1)
    dx, ds, dr = decoder(params, field(params, pts))
    return dx, dr, ds


def deformed(means, quats, log_scales, dx, dr, ds):
    """(mean', unit quaternion', scale'): the offsets before the
    activations."""
    q = quats + dr
    q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), 1e-12)
    return means + dx, q, torch.exp(log_scales + ds)


def compute_plane_smoothness(t: torch.Tensor) -> torch.Tensor:
    """The code's smoothness of a (1, C, H, W) plane, along H."""
    h = t.shape[2]
    first = t[..., 1:, :] - t[..., :h - 1, :]
    second = first[..., 1:, :] - first[..., :h - 2, :]
    return torch.square(second).mean()


def regularizer(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``compute_regulation`` at the dynerf weights."""
    grids = [[published(params[f"grids.{s}.{p}"]) for p in range(6)]
             for s in range(len(SCALES))]
    plane = sum(compute_plane_smoothness(g[k]) for g in grids for k in (0, 1, 3))
    time = sum(compute_plane_smoothness(g[k]) for g in grids for k in (2, 4, 5))
    l1 = sum(torch.abs(1 - g[k]).mean() for g in grids for k in (2, 4, 5))
    return PLANE_TV_WEIGHT * plane + TIME_SMOOTHNESS_WEIGHT * time + L1_TIME_PLANES_WEIGHT * l1


def lr(kind: str, iteration: int, warmup: int, extent: float) -> torch.Tensor:
    """The ``grid`` or ``deformation`` rate at the port's ``iteration``
    (the fine stage's iteration - ``warmup``)."""
    init, final = (1.6e-3, 1.6e-4) if kind == "grid" else (1.6e-4, 1.6e-5)
    return exp_lr(init * extent, final * extent, 20_000, max(iteration - warmup, 0))


def reference_step(p: Dict[str, torch.Tensor], net: Dict[str, torch.Tensor],
                   mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor], adam_step: int,
                   alive: torch.Tensor, box: torch.Tensor,
                   views: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, float]],
                   render_fn: RenderFn, cfg: dict) -> dict:
    """One training step from the gaussians ``p`` (the six raw groups), the
    field and decoder ``net`` and the Adam moments ``mu``, ``nu`` (keyed by
    the groups' and the field's names) at the shared ``adam_step``, over
    the alive rows (dead rows take zero offsets). ``views`` is (viewmat, K,
    target (H, W, 3) in [0, 1], t) a view; ``render_fn(means, unit_quats,
    scales, masked_logits (N,), sh (N, K, 3), viewmat, K)`` the image.
    ``cfg``: lambda_dssim, scale_reg_max_ratio, scale_reg_weight, adam_b1,
    adam_b2, adam_eps, the rates ``lrs`` (the groups' and ``grid``,
    ``deformation``), extent, scale_clamp_ratio. Returns the loss, the
    regularizers, every leaf's gradient, the offsets of each view and the
    new parameters, field and moments."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    wleaves = {k: v.detach().clone().requires_grad_(True) for k, v in net.items()}
    sh = torch.cat([leaves["features_dc"], leaves["features_rest"]], dim=1)
    logits = torch.where(alive[:, None], leaves["logit_opacities"],
                         torch.full_like(leaves["logit_opacities"], -20.0)).reshape(-1)
    rows = torch.nonzero(alive).reshape(-1)
    n = alive.shape[0]
    total = torch.zeros(())
    offs: List[tuple] = []
    for viewmat, K, gt, t in views:
        part = offsets(wleaves, box, leaves["means"][rows], t)
        full = [torch.zeros((n, o.shape[1])).index_put((rows,), o) for o in part]
        offs.append(tuple(o.detach() for o in full))
        m2, q2, s2 = deformed(leaves["means"], leaves["quats"], leaves["log_scales"], *full)
        img = render_fn(m2, q2, s2, logits, sh, viewmat, K)
        total = total + photometric(img, gt, cfg["lambda_dssim"])
    reg = scale_reg(leaves["log_scales"], alive, cfg["scale_reg_max_ratio"],
                    cfg["scale_reg_weight"])
    field_reg = regularizer(wleaves)
    loss = total / len(views) + reg + field_reg
    names = list(leaves) + list(wleaves)
    tensors = list(leaves.values()) + list(wleaves.values())
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g for k, v, g in zip(names, tensors, grads)}
    b1, b2, eps = cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"]
    step = adam_step + 1
    tt = torch.tensor(float(step), dtype=torch.float32)
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** tt
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** tt
    new_p, new_net, new_mu, new_nu = {}, {}, {}, {}
    with torch.no_grad():
        for k in names:
            g = grads[k]
            m = b1 * mu[k] + (1.0 - b1) * g
            v = b2 * nu[k] + (1.0 - b2) * g * g
            if k in PARAM_KEYS:
                rate, src, dst = cfg["lrs"][k], p[k], new_p
            else:
                rate = cfg["lrs"]["grid" if k.startswith("grids.") else "deformation"]
                src, dst = net[k], new_net
            dst[k] = src - rate * (m / c1) / (torch.sqrt(v / c2) + eps)
            new_mu[k], new_nu[k] = m, v
        ceil = torch.log(torch.tensor(cfg["extent"] * cfg["scale_clamp_ratio"] + 1e-9))
        new_p["log_scales"] = torch.clamp_max(new_p["log_scales"], ceil)
    return {"loss": float(loss.detach()), "field_reg": float(field_reg.detach()),
            "grads": grads, "offsets": offs, "params": new_p, "net": new_net, "mu": new_mu,
            "nu": new_nu}
