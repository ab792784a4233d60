"""The training step (counterpart of ``gaussian_splatting_tpu/training/
step.py``): renders of a view batch through the kernels, the photometric
loss, one backward through the backward kernel and the gradient reduce,
per-group Adam, the scale ceiling, the densify accumulators and optional
camera-pose refinement. With a deformation network in the state and times
in the batch (Deformable 3D Gaussians, ``models/deform.py``) each view first
runs the MLP over the alive slots at its time and renders the gaussians
moved by its offsets; the network takes a seventh Adam group. A HexPlane
field in the state (4D Gaussian Splatting, ``models/hexplane.py``) does the
same with offsets added before the activations, the means kept attached to
the field's coordinates, and adds the field's regularizers once a step; its
26 tensors take one Adam launch at two rates. A surfel
scene (2D Gaussian Splatting, two scales a row) adds per view, after the
photometric loss, the normal-consistency and depth-distortion terms at the
configuration's weights, each zero before its published start iteration
(``training/loss.py::surfel_terms``, read from the raster's map buffer
where it lies). Everything after the backward is
``apply_gradients``, which the sharded step (``parallel/sharded_step.py``)
runs too. Spans (``utils/profiling``): ``step.loss`` and its backward
``step.loss.bwd`` a view, for surfels ``step.surfel_reg`` and its backward
``step.surfel_reg.bwd`` a view, for a HexPlane field ``step.deform_reg`` a
step, ``step.backward``, ``step.adam`` and inside it ``step.adam.deform``;
the MLP's and the field's own are ``models/deform.py``'s and
``models/hexplane.py``'s.

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
from gaussian_splatting_tpu_torch.models import deform as deform_model
from gaussian_splatting_tpu_torch.models import hexplane as hexplane_model
from gaussian_splatting_tpu_torch.models.densify import clamp_scales
from gaussian_splatting_tpu_torch.models.gaussians import (
    PARAM_KEYS,
    GaussianParams,
    GaussianState,
)
from gaussian_splatting_tpu_torch.ops.render import render, resolve_backend
from gaussian_splatting_tpu_torch.training.loss import (
    SURFEL_DIST_FROM,
    SURFEL_NORMAL_FROM,
    photometric_loss,
    scale_ratio_reg,
    surfel_terms,
)
from gaussian_splatting_tpu_torch.training.optimizer import (
    AdamState,
    adam_bias_corrections,
    adam_multi,
    adam_update,
    exp_lr_decay,
    group_lrs,
    xyz_lr_schedule,
)
from gaussian_splatting_tpu_torch.utils import profiling

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
    # The deformation: a DeformState (MLP) or a HexPlaneState (field).
    deform: Optional[object] = None


@dataclasses.dataclass
class ViewBatch:
    """A batch of training views."""

    images: torch.Tensor    # (B, H, W, 3) float32 in [0, 1]
    viewmats: torch.Tensor  # (B, 4, 4) world-to-camera
    Ks: torch.Tensor        # (B, 3, 3)
    view_idx: Optional[torch.Tensor] = None  # (B,) int dataset view ids
    # (B,) float32 times of the views (with the annealing noise): set, with a
    # deformation network in the state, the step deforms the gaussians.
    times: Optional[torch.Tensor] = None


def pose_lr_schedule(config, iteration: torch.Tensor) -> torch.Tensor:
    """Exponential decay pose_lr_init -> pose_lr_final over
    position_lr_max_steps, zero before pose_start_iter."""
    lr = exp_lr_decay(iteration, config.pose_lr_init, config.pose_lr_final,
                      config.position_lr_max_steps)
    return torch.where(iteration >= config.pose_start_iter, lr, torch.zeros_like(lr))


def leaf_grad(leaf: torch.Tensor) -> torch.Tensor:
    """The gradient the backward left on ``leaf``; zeros where it left none
    (a group no view reached)."""
    return leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)


def group_grad_norms(grads: GaussianParams) -> dict:
    """The ``grad_norm/<group>`` metrics of a device's whole gradients."""
    return {f"grad_norm/{k}": torch.linalg.norm(getattr(grads, k)) for k in PARAM_KEYS}


def apply_gradients(config, state: TrainState, grads: GaussianParams, radii_max: torch.Tensor,
                    scene_extent: float, metrics: dict, pose_grad: Optional[torch.Tensor] = None,
                    deform_grads: Optional[dict] = None, grad_norms=group_grad_norms) -> None:
    """The step after the backward, in place and in span ``step.adam``,
    shared by ``make_train_step`` and the sharded step: Adam of the six
    groups, the scale ceiling, the densify accumulators, ``max_radii2d``
    (from ``radii_max``, the radius maximum of the state's rows), Adam of
    the pose deltas and of the deformation network or field (span
    ``step.adam.deform``) where their gradients are given, ``iteration``
    += 1; the rates and ``grad_norms(grads)`` go into ``metrics``. Each
    Adam is one ``adam_multi`` (one kernel launch on the card)."""
    gauss = state.gauss
    b1, b2, eps = config.adam_b1, config.adam_b2, config.adam_eps
    with torch.no_grad(), profiling.annotate("step.adam"):
        xyz_lr = xyz_lr_schedule(config, state.iteration)
        adam_update(grads, state.opt, gauss.params, group_lrs(config, xyz_lr),
                    b1=b1, b2=b2, eps=eps)
        clamp_scales(gauss.params, scene_extent, config.scale_clamp_ratio)
        # Densify bookkeeping: ||grad means|| into all 3 accumulator
        # columns and count += 1 for every gaussian (the reference's
        # quirk the densify threshold was tuned against).
        gauss.xyz_grad_accum.add_(torch.linalg.norm(grads.means, dim=-1, keepdim=True))
        gauss.xyz_grad_count.add_(1.0)
        torch.maximum(gauss.max_radii2d, radii_max, out=gauss.max_radii2d)

        if pose_grad is not None or deform_grads is not None:
            c1, c2 = adam_bias_corrections(state.opt.step, b1, b2)
        if pose_grad is not None:
            # The schedule gate zeroes gradient and lr before pose_start_iter.
            plr = pose_lr_schedule(config, state.iteration)
            gp = torch.where(plr > 0.0, pose_grad, torch.zeros_like(pose_grad))
            poses = state.poses
            adam_multi([poses.deltas], [gp], [poses.mu], [poses.nu], [plr], c1, c2, b1, b2, eps)
            metrics["pose_lr"] = plr
            metrics["grad_norm/poses"] = torch.linalg.norm(pose_grad)
            metrics["pose/delta_max"] = poses.deltas.abs().max()
        if deform_grads is not None:
            with profiling.annotate("step.adam.deform"):
                ds = state.deform
                names = list(ds.params)
                if isinstance(ds, hexplane_model.HexPlaneState):
                    rates = hexplane_model.lr_schedule(config, state.iteration, scene_extent)
                    lrs = [rates[k] for k in names]
                    metrics["grid_lr"] = rates[names[0]]
                else:
                    lrs = [deform_model.lr_schedule(config, state.iteration)] * len(names)
                adam_multi([ds.params[k] for k in names], [deform_grads[k] for k in names],
                           [ds.mu[k] for k in names], [ds.nu[k] for k in names],
                           lrs, c1, c2, b1, b2, eps)
                metrics["deform_lr"] = lrs[-1]
                metrics["grad_norm/deform"] = torch.linalg.norm(
                    torch.stack([torch.linalg.norm(g) for g in deform_grads.values()]))
        state.iteration += 1
        metrics["xyz_lr"] = xyz_lr
        metrics.update(grad_norms(grads))


def make_train_step(config, width: int, height: int, sh_degree: int, backend: str,
                    scene_extent: float, device: DeviceLike = None):
    """The training step for one (image size, sh_degree) configuration on
    ``device`` (CUDA unless given). Returns ``step(state, batch) -> (state,
    metrics)``: it updates ``state``'s tensors in place and returns it with
    a metrics dict of 0-dim tensors, keyed as the JAX step's (l1, ssim,
    psnr, scale_reg, loss, xyz_lr, grad_norm/<group>, stats/<counter> on the
    cuda backend, pose_lr, grad_norm/poses, pose/delta_max when poses are
    refined, deform_lr, grad_norm/deform when the gaussians deform, also
    grid_lr and deform_reg for a HexPlane field, and surfel/normal,
    surfel/dist (the unweighted terms' batch means) for surfels)."""
    dev = resolve_device(device)
    backend = resolve_backend(backend)
    optimize_poses = bool(config.optimize_poses)
    want_stats = backend == "cuda"
    # The alive slots the MLP runs over, found again (one host sync) only
    # when the alive mask is another tensor or was written to.
    rows_of = {"alive": None, "version": None, "rows": None}

    def alive_rows(alive: torch.Tensor) -> torch.Tensor:
        if rows_of["alive"] is not alive or rows_of["version"] != alive._version:
            rows_of.update(alive=alive, version=alive._version,
                           rows=torch.nonzero(alive).reshape(-1))
        return rows_of["rows"]

    def surfel_weights(iteration: torch.Tensor):
        """The normal and distortion terms' weights, zero before each
        term's start, as device scalars (no host read)."""
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return (torch.where(iteration >= SURFEL_NORMAL_FROM,
                            zero + config.surfel_lambda_normal, zero),
                torch.where(iteration >= SURFEL_DIST_FROM,
                            zero + config.surfel_lambda_dist, zero))

    def render_batch(params: GaussianParams, alive, batch: ViewBatch, deltas, pose_on,
                     net=None, field=None, iteration=None):
        sh = params.sh_coeffs
        masked_op = params.masked_opacities(alive)
        surfels = params.surfels
        total = torch.zeros((), dtype=torch.float32, device=dev)
        keys = ("l1", "ssim", "psnr") + (("surfel/normal", "surfel/dist") if surfels else ())
        m_acc = {k: torch.zeros((), dtype=torch.float32, device=dev) for k in keys}
        if surfels:
            lam_n, lam_d = surfel_weights(iteration)
        s_acc = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in STAT_KEYS}
        radii_max = None
        for b in range(batch.images.shape[0]):
            viewmat = batch.viewmats[b]
            if pose_on:
                viewmat = apply_pose_delta(viewmat, deltas[batch.view_idx[b]])
            offsets = None
            means, quats, log_scales = params.means, params.quats, params.log_scales
            if isinstance(field, hexplane_model.HexPlaneState):
                means, quats, log_scales = hexplane_model.deformed(
                    means, quats, log_scales,
                    hexplane_model.offsets(net, field.box, means, alive_rows(alive),
                                           batch.times[b]))
            elif net is not None:
                offsets = deform_model.offsets(net, field.spec, means, alive_rows(alive),
                                               batch.times[b])
            out = render(
                means, quats, log_scales, masked_op, sh, viewmat,
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
                depth_grad=False, offsets=offsets, device=dev)
            radii = out.radii.detach()
            radii_max = radii if radii_max is None else torch.maximum(radii_max, radii)
            with profiling.annotate("step.loss"):
                mark = profiling.grad_span("step.loss.bwd")
                loss, m = photometric_loss(mark.input(out.render), batch.images[b],
                                           config.lambda_dssim, dtype=config.loss_dtype)
                loss = mark.outputs(loss)
            if surfels:
                with profiling.annotate("step.surfel_reg"):
                    mark = profiling.grad_span("step.surfel_reg.bwd")
                    l_n, l_d = surfel_terms(mark.input(out.maps), viewmat, batch.Ks[b],
                                            config.surfel_depth_ratio)
                    reg_v = mark.outputs(lam_n * l_n + lam_d * l_d)
                loss = loss + reg_v
                m["surfel/normal"], m["surfel/dist"] = l_n, l_d
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
        deform_on = state.deform is not None and batch.times is not None
        net = ({k: v.detach().requires_grad_(True) for k, v in state.deform.params.items()}
               if deform_on else None)

        total, m_acc, s_acc, radii_max = render_batch(
            leaves, gauss.alive, batch, deltas, pose_on, net,
            state.deform if deform_on else None, state.iteration)
        reg = scale_ratio_reg(leaves.log_scales, gauss.alive, config.scale_reg_max_ratio,
                              config.scale_reg_weight)
        loss = total / B + reg
        field_reg = None
        if deform_on and isinstance(state.deform, hexplane_model.HexPlaneState):
            with profiling.annotate("step.deform_reg"):
                field_reg = hexplane_model.regularizer(net)
            loss = loss + field_reg
        with profiling.annotate("step.backward"):
            loss.backward()
        metrics = {k: v / B for k, v in m_acc.items()}
        metrics["scale_reg"] = reg.detach()
        if field_reg is not None:
            metrics["deform_reg"] = field_reg.detach()
        if want_stats:
            metrics.update({f"stats/{k}": v for k, v in s_acc.items()})
        metrics["loss"] = loss.detach()
        grads = GaussianParams(**{k: leaf_grad(getattr(leaves, k)) for k in PARAM_KEYS})
        apply_gradients(
            config, state, grads, radii_max, scene_extent, metrics,
            pose_grad=leaf_grad(deltas) if pose_on else None,
            deform_grads={k: leaf_grad(v) for k, v in net.items()} if deform_on else None)
        return state, metrics

    return step
