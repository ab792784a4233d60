"""The training step (counterpart of ``gaussian_splatting_tpu/training/
step.py``): renders of a view batch through the kernels, the photometric
loss, one backward through the backward kernel and the gradient reduce,
per-group Adam, the scale ceiling, the densify accumulators and optional
camera-pose refinement.

PyTorch runs eagerly: a Python loop over the batch takes the place of the
JAX ``lax.scan``, and the step updates the state's tensors in place (no copy
of the 1M-row parameter and moment tensors) instead of donating buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gaussian_splatting_tpu_torch._device import DeviceLike, resolve_device
from gaussian_splatting_tpu_torch.core.se3 import apply_pose_delta
from gaussian_splatting_tpu_torch.models.densify import clamp_scales
from gaussian_splatting_tpu_torch.models.gaussians import (
    PARAM_KEYS,
    GaussianParams,
    GaussianState,
)
from gaussian_splatting_tpu_torch.ops.render import render, resolve_backend
from gaussian_splatting_tpu_torch.training.loss import photometric_loss, scale_ratio_reg
from gaussian_splatting_tpu_torch.training.optimizer import (
    AdamState,
    adam_bias_corrections,
    adam_update,
    group_lrs,
    xyz_lr_schedule,
)

STAT_KEYS = ("n_isect", "n_dropped", "n_budget_dropped", "n_grad_dropped")


@dataclasses.dataclass
class PoseState:
    """Per-view se(3) pose corrections and their Adam moments. Row v
    corrects view v's world-to-camera matrix by left multiplication
    (``core/se3.py``); views never in a batch keep zero rows."""

    deltas: torch.Tensor  # (V, 6) (omega, upsilon)
    mu: torch.Tensor      # (V, 6) Adam first moment
    nu: torch.Tensor      # (V, 6) Adam second moment


def pose_state_init(n_views: int, device: DeviceLike = None) -> PoseState:
    dev = resolve_device(device)
    return PoseState(*(torch.zeros((n_views, 6), dtype=torch.float32, device=dev)
                       for _ in range(3)))


@dataclasses.dataclass
class TrainState:
    gauss: GaussianState
    opt: AdamState
    iteration: torch.Tensor  # () int32
    poses: Optional[PoseState] = None


@dataclasses.dataclass
class ViewBatch:
    """A batch of training views."""

    images: torch.Tensor    # (B, H, W, 3) float32 in [0, 1]
    viewmats: torch.Tensor  # (B, 4, 4) world-to-camera
    Ks: torch.Tensor        # (B, 3, 3)
    view_idx: Optional[torch.Tensor] = None  # (B,) int dataset view ids


def pose_lr_schedule(config, iteration: torch.Tensor) -> torch.Tensor:
    """Exponential decay pose_lr_init -> pose_lr_final over
    position_lr_max_steps, zero before pose_start_iter."""
    progress = torch.clamp_max(
        iteration.to(torch.float32) / float(config.position_lr_max_steps), 1.0)
    ratio = config.pose_lr_final / config.pose_lr_init
    lr = config.pose_lr_init * torch.pow(torch.full_like(progress, ratio), progress)
    return torch.where(iteration >= config.pose_start_iter, lr, torch.zeros_like(lr))


def make_train_step(config, width: int, height: int, sh_degree: int, backend: str,
                    scene_extent: float, device: DeviceLike = None):
    """The training step for one (image size, sh_degree) configuration on
    ``device`` (CUDA unless given). Returns ``step(state, batch) -> (state,
    metrics)``: it updates ``state``'s tensors in place and returns it with
    a metrics dict of 0-dim tensors, keyed as the JAX step's (l1, ssim,
    psnr, scale_reg, loss, xyz_lr, grad_norm/<group>, stats/<counter> on the
    cuda backend, and pose_lr, grad_norm/poses, pose/delta_max when poses
    are refined)."""
    dev = resolve_device(device)
    backend = resolve_backend(backend)
    optimize_poses = bool(config.optimize_poses)
    want_stats = backend == "cuda"

    def render_batch(params: GaussianParams, alive, batch: ViewBatch, deltas, pose_on):
        sh = params.sh_coeffs
        masked_op = params.masked_opacities(alive)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        m_acc = {k: torch.zeros((), dtype=torch.float32, device=dev)
                 for k in ("l1", "ssim", "psnr")}
        s_acc = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in STAT_KEYS}
        radii_max = None
        for b in range(batch.images.shape[0]):
            viewmat = batch.viewmats[b]
            if pose_on:
                viewmat = apply_pose_delta(viewmat, deltas[batch.view_idx[b]])
            out = render(
                params.means, params.quats, params.log_scales, masked_op, sh, viewmat,
                batch.Ks[b], width, height, sh_degree=sh_degree, backend=backend,
                tile_size=config.tile_size,
                max_tiles_per_gaussian=config.max_tiles_per_gaussian,
                raster_chunk=config.raster_chunk, class_budgets=config.class_budgets,
                depth_bits=config.sort_depth_bits,
                grad_buffer_frac=config.grad_buffer_frac,
                sort_buckets=config.sort_buckets,
                bucket_headroom=config.partition_headroom,
                reduce_slices=config.reduce_slices,
                sort_bands=config.sort_bands,
                rasterize_mode=config.rasterize_mode, with_stats=want_stats,
                # The loss is photometric: the depth output never gets a
                # cotangent, so the reduce leaves out its payload.
                depth_grad=False, device=dev)
            radii = out.radii.detach()
            radii_max = radii if radii_max is None else torch.maximum(radii_max, radii)
            loss, m = photometric_loss(out.render, batch.images[b], config.lambda_dssim,
                                       dtype=config.loss_dtype)
            total = total + loss
            for k in m_acc:
                m_acc[k] = m_acc[k] + m[k].detach()
            if want_stats:
                for k in STAT_KEYS:
                    s_acc[k] = s_acc[k] + out.stats[k]
        return total, m_acc, s_acc, radii_max

    def step(state: TrainState, batch: ViewBatch):
        B = batch.images.shape[0]
        gauss = state.gauss
        pose_on = (optimize_poses and state.poses is not None
                   and batch.view_idx is not None)
        leaves = GaussianParams(**{k: getattr(gauss.params, k).detach().requires_grad_(True)
                                   for k in PARAM_KEYS})
        deltas = state.poses.deltas.detach().requires_grad_(True) if pose_on else None

        total, m_acc, s_acc, radii_max = render_batch(leaves, gauss.alive, batch, deltas,
                                                      pose_on)
        reg = scale_ratio_reg(leaves.log_scales, gauss.alive, config.scale_reg_max_ratio,
                              config.scale_reg_weight)
        loss = total / B + reg
        loss.backward()
        grads = GaussianParams(**{
            k: (getattr(leaves, k).grad if getattr(leaves, k).grad is not None
                else torch.zeros_like(getattr(leaves, k))) for k in PARAM_KEYS})
        metrics = {k: v / B for k, v in m_acc.items()}
        metrics["scale_reg"] = reg.detach()
        if want_stats:
            metrics.update({f"stats/{k}": v for k, v in s_acc.items()})

        with torch.no_grad():
            xyz_lr = xyz_lr_schedule(config, state.iteration)
            adam_update(grads, state.opt, gauss.params, group_lrs(config, xyz_lr),
                        b1=config.adam_b1, b2=config.adam_b2, eps=config.adam_eps)
            clamp_scales(gauss.params, scene_extent, config.scale_clamp_ratio)
            # Densify bookkeeping: ||grad means|| into all 3 accumulator
            # columns and count += 1 for every gaussian (the reference's
            # quirk the densify threshold was tuned against).
            gauss.xyz_grad_accum.add_(torch.linalg.norm(grads.means, dim=-1, keepdim=True))
            gauss.xyz_grad_count.add_(1.0)
            torch.maximum(gauss.max_radii2d, radii_max, out=gauss.max_radii2d)

            if pose_on:
                # Pose Adam with the gaussians' step counter; the schedule
                # gate zeroes gradient and lr before pose_start_iter.
                plr = pose_lr_schedule(config, state.iteration)
                gp = torch.where(plr > 0.0, deltas.grad, torch.zeros_like(deltas.grad))
                c1, c2 = adam_bias_corrections(state.opt.step, config.adam_b1,
                                               config.adam_b2)
                poses = state.poses
                poses.mu.mul_(config.adam_b1).add_((1.0 - config.adam_b1) * gp)
                poses.nu.mul_(config.adam_b2).add_((1.0 - config.adam_b2) * gp * gp)
                poses.deltas.sub_(plr * (poses.mu / c1)
                                  / (torch.sqrt(poses.nu / c2) + config.adam_eps))
                metrics["pose_lr"] = plr
                metrics["grad_norm/poses"] = torch.linalg.norm(deltas.grad)
                metrics["pose/delta_max"] = poses.deltas.abs().max()
            state.iteration += 1
            metrics["loss"] = loss.detach()
            metrics["xyz_lr"] = xyz_lr
            for k in PARAM_KEYS:
                metrics[f"grad_norm/{k}"] = torch.linalg.norm(getattr(grads, k))
        return state, metrics

    return step
