"""Adaptive densification on fixed-capacity buffers (counterpart of
``gaussian_splatting_tpu/models/densify.py``).

One clone/split/prune sweep of masked scatters, with no host read and no
change of shape:

- clone: high-gradient, small (max scale <= extent * clone ratio), visible
  gaussians copied into free slots, the i-th clone into the i-th free slot
  in ascending order;
- split: high-gradient large gaussians become two children at scale / 1.6
  with positional noise ~ N(0, child scale): child 1 reuses the parent's
  slot, child 2 takes the free slot after the clones'. Surfels (two scales
  a row) draw the noise in their tangent plane, s_u n_1 t_u + s_v n_2 t_v at
  the child's scales, their third standard deviation 0;
- population cap: when clones + splits would exceed ``max_gaussians`` (or
  the capacity), only the highest-gradient candidates are kept, ranked by
  a stable sort of the negated gradient;
- prune: opacity below ``min_opacity`` or max scale above extent * prune
  ratio -> dead;
- Adam: the moments of every new gaussian (clone destinations, both split
  children) are zeroed, the others are kept.

A scatter destination past the buffer (a free-slot list run dry, an
invalid candidate) is dropped, as ``.at[].set(mode="drop")`` drops it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from gaussian_splatting_tpu_torch.core.activations import (
    opacity_activation,
    opacity_inverse_activation,
    scale_activation,
)
from gaussian_splatting_tpu_torch.core.quaternions import quat_normalize, quat_to_rotmat
from gaussian_splatting_tpu_torch.models.gaussians import (
    PARAM_KEYS,
    GaussianParams,
    GaussianState,
)


class DensifyStats(NamedTuple):
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    n_before: torch.Tensor
    n_after: torch.Tensor
    capped: torch.Tensor


def _nonzero_padded(mask: torch.Tensor) -> torch.Tensor:
    """``jnp.nonzero(mask, size=C, fill_value=C)``: the ascending indices of
    the true entries, then C, as an int64 (C,) tensor, without a host read."""
    C = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    out = torch.full((C + 1,), C, dtype=torch.int64, device=mask.device)
    out.scatter_(0, torch.where(mask, pos, torch.full_like(pos, C)),
                 torch.arange(C, device=mask.device))
    out[C] = C
    return out[:C]


def _set_rows(a: torch.Tensor, dst: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``a.at[dst].set(rows, mode="drop")`` for destinations in [0, C] (C
    dropped): a new tensor."""
    C = a.shape[0]
    ext = torch.cat([a, a[:1]])
    ext.index_copy_(0, dst, rows)
    return ext[:C]


def _scatter_rows(params: GaussianParams, src, dst, valid) -> GaussianParams:
    """params[dst] = params[src] where ``valid`` (dropped elsewhere)."""
    C = params.capacity
    src_c = torch.clamp_max(src, C - 1)
    dst_w = torch.where(valid, dst, torch.full_like(dst, C))
    return GaussianParams(**{k: _set_rows(getattr(params, k), dst_w, getattr(params, k)[src_c])
                             for k in PARAM_KEYS})


def _zero_rows(moments: GaussianParams, idx, valid) -> GaussianParams:
    C = moments.capacity
    dst_w = torch.where(valid, idx, torch.full_like(idx, C))
    return GaussianParams(**{k: _set_rows(getattr(moments, k), dst_w,
                                          torch.zeros_like(getattr(moments, k)))
                             for k in PARAM_KEYS})


def densify_and_prune(
    state: GaussianState,
    adam_moments: Tuple[GaussianParams, GaussianParams],
    grads_threshold: float,
    min_opacity: float,
    extent,
    max_gaussians: int,
    clone_extent_ratio: float = 0.1,
    prune_extent_ratio: float = 2.0,
    topk_fraction: float = 0.0,
    generator: Optional[torch.Generator] = None,
    _normals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[GaussianState, Tuple[GaussianParams, GaussianParams], DensifyStats]:
    """One clone/split/prune sweep (``densify.py:69-204`` of the JAX
    package). Returns ``(new_state, (mu, nu), stats)``; the inputs are not
    changed.

    ``topk_fraction > 0`` replaces the absolute gradient threshold by a rank
    threshold: the top ``topk_fraction`` of the alive gaussians by
    accumulated gradient norm. The split noise is two (C, 3) standard
    normals drawn from ``generator`` (on the state's device); ``_normals``
    passes them in instead (the tests feed the JAX package's draws)."""
    p = state.params
    C = state.capacity
    dev = p.means.device
    alive = state.alive
    extent = torch.as_tensor(extent, dtype=torch.float32, device=dev)

    grads = state.xyz_grad_accum / (state.xyz_grad_count + 1e-8)
    grad_norm = torch.linalg.norm(grads, dim=-1)
    max_scale = torch.amax(scale_activation(p.log_scales), dim=-1)
    op = opacity_activation(p.logit_opacities)[:, 0]
    neg_inf = torch.full_like(grad_norm, -math.inf)

    n_alive = torch.sum(alive.to(torch.int32))
    if topk_fraction > 0.0:
        k = torch.clamp_min((topk_fraction * n_alive.to(torch.float32)).to(torch.int32), 1)
        desc = torch.sort(torch.where(alive, grad_norm, neg_inf)).values.flip(0)
        rank_thresh = desc[torch.clamp_max(k, C - 1).long()]
        # Strict >: exactly the top k; never densify zero-gradient gaussians.
        sel = grad_norm > torch.clamp_min(rank_thresh, 1e-12)
    else:
        sel = grad_norm >= grads_threshold
    hot = alive & sel & (op > min_opacity)
    clone_mask = hot & (max_scale <= extent * clone_extent_ratio)
    split_mask = hot & (max_scale > extent * clone_extent_ratio)

    cap = min(int(max_gaussians), C)
    budget = torch.clamp_min(cap - n_alive, 0)
    combined = clone_mask | split_mask
    capped = torch.sum(combined.to(torch.int32)) > budget
    # Rank candidates by gradient, descending (stable); keep the top budget.
    order = torch.argsort(-torch.where(combined, grad_norm, neg_inf), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(C, device=dev)
    keep = combined & (rank < budget)
    clone_mask = clone_mask & keep
    split_mask = split_mask & keep
    n_clone = torch.sum(clone_mask.to(torch.int32))
    n_split = torch.sum(split_mask.to(torch.int32))

    free_idx = _nonzero_padded(~alive)
    clone_src = _nonzero_padded(clone_mask)
    split_src = _nonzero_padded(split_mask)
    slot = torch.arange(C, device=dev)
    mu, nu = adam_moments

    # Clones -> free slots [0, n_clone).
    clone_valid = slot < n_clone
    clone_dst = free_idx
    params = _scatter_rows(p, clone_src, clone_dst, clone_valid)
    alive = _set_rows(alive, torch.where(clone_valid, clone_dst, C),
                      torch.ones_like(alive))
    mu = _zero_rows(mu, clone_dst, clone_valid)
    nu = _zero_rows(nu, clone_dst, clone_valid)

    # Splits: child 1 reuses the parent slot, child 2 takes free slot
    # n_clone + i.
    split_valid = slot < n_split
    child2_dst = free_idx[torch.clamp_max(slot + n_clone, C - 1)]
    params = _scatter_rows(params, split_src, child2_dst, split_valid)
    alive = _set_rows(alive, torch.where(split_valid, child2_dst, C), torch.ones_like(alive))

    # Both children: scale / 1.6, means + N(0, child scale).
    if _normals is None:
        if generator is None:
            raise ValueError("densify_and_prune needs a generator for the split noise")
        _normals = tuple(torch.randn((C, 3), generator=generator, device=generator.device,
                                     dtype=p.means.dtype).to(dev) for _ in range(2))
    n1, n2 = (torch.as_tensor(x, dtype=p.means.dtype, device=dev) for x in _normals)
    src_c = torch.clamp_max(split_src, C - 1)
    child_log_scales = p.log_scales[src_c] - torch.log(
        torch.tensor(1.6, dtype=p.log_scales.dtype, device=dev))
    child_scales = scale_activation(child_log_scales)
    parent_means = p.means[src_c]
    d1 = torch.where(split_valid, split_src, C)
    d2 = torch.where(split_valid, child2_dst, C)
    if p.surfels:
        rot = quat_to_rotmat(quat_normalize(p.quats[src_c]))
        tu = rot[:, :, 0] * child_scales[:, :1]
        tv = rot[:, :, 1] * child_scales[:, 1:2]

        def offset(n):
            return tu * n[:, :1] + tv * n[:, 1:2]
    else:
        def offset(n):
            return n * child_scales
    params.means = _set_rows(_set_rows(params.means, d1, parent_means + offset(n1)),
                             d2, parent_means + offset(n2))
    params.log_scales = _set_rows(_set_rows(params.log_scales, d1, child_log_scales),
                                  d2, child_log_scales)
    for dst in (split_src, child2_dst):
        mu = _zero_rows(mu, dst, split_valid)
        nu = _zero_rows(nu, dst, split_valid)

    # Prune.
    max_scale2 = torch.amax(scale_activation(params.log_scales), dim=-1)
    op2 = opacity_activation(params.logit_opacities)[:, 0]
    prune_mask = alive & ((op2 < min_opacity) | (max_scale2 > extent * prune_extent_ratio))
    alive = alive & ~prune_mask

    new_state = GaussianState(params=params, alive=alive,
                              xyz_grad_accum=torch.zeros_like(state.xyz_grad_accum),
                              xyz_grad_count=torch.zeros_like(state.xyz_grad_count),
                              max_radii2d=torch.zeros_like(state.max_radii2d))
    stats = DensifyStats(n_cloned=n_clone, n_split=n_split,
                         n_pruned=torch.sum(prune_mask.to(torch.int32)), n_before=n_alive,
                         n_after=torch.sum(alive.to(torch.int32)), capped=capped)
    return new_state, (mu, nu), stats


def reset_opacity(params: GaussianParams, ceiling: float = 0.01) -> GaussianParams:
    """Opacity reset: every opacity -> min(current, ``ceiling``), clipped to
    [1e-6, 1 - 1e-6]; Adam moments untouched. Returns new parameters."""
    current = opacity_activation(params.logit_opacities)
    target = torch.clamp(torch.clamp_max(current, ceiling), 1e-6, 1.0 - 1e-6)
    out = GaussianParams(**{k: getattr(params, k) for k in PARAM_KEYS})
    out.logit_opacities = opacity_inverse_activation(target)
    return out


def clamp_scales(params: GaussianParams, extent: float, clamp_ratio: float) -> GaussianParams:
    """The per-step scale ceiling, in place: log scales at most log(extent *
    clamp_ratio + 1e-9), the ceiling a device fill (no blocking upload).
    Returns ``params``."""
    e = torch.full((), float(extent), dtype=torch.float32, device=params.log_scales.device)
    params.log_scales.clamp_max_(torch.log(e * clamp_ratio + 1e-9))
    return params
