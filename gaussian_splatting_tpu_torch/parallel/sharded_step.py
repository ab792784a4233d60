"""The training step on a ("data", "model") mesh, with ZeRO-sharded
parameters and optimizer state (counterpart of
``gaussian_splatting_tpu/parallel/sharded_step.py``).

ZeRO placement: every tensor whose leading dimension is the capacity C
(the six parameter groups, both Adam moments, ``alive`` and the densify
accumulators) lives on rank (d, m) as rows [m C/M, (m+1) C/M), replicated
over ``data``; the pose state and the counters are replicated
(``shard_state`` / ``gather_state``). Per step, on each rank (d, m):

1. phase 1: project and SH-shade the rank's gaussian shard for each of its
   B/D views, then all-gather the compact screen-space tensors (11 floats a
   gaussian, against 59 parameter floats) over ``model``;
2. phase 2: rasterize the rank's band of tile rows (a viewport shifted by
   y0 = m band_h) against all gaussians, with the raster options of the
   single-device step;
3. the photometric loss over the band's valid rows, the SSIM exact at band
   edges through a 1-row halo exchange over ``model`` (edge bands receive
   zeros: the global SSIM's zero padding), normalized by the global pixel
   count;
4. each rank backpropagates its own partial loss. The gathers' backward is
   a reduce-scatter over ``model``, so per-gaussian gradients come back
   already sharded; an all-reduce over ``data`` of the shard gradients and
   one over the world of the pose gradient complete the global gradient.
   The single-device step's update (``training/step.py::apply_gradients``)
   then runs shard-local, the pose Adam replicated.

Every rank issues the same collectives in the same order (one gather and,
with M > 1, one halo exchange a view, in view order, whatever the band
holds), so the backward mirrors them too. As in the JAX sharded step, the
loss is float32 (``loss_dtype`` is not read) and ``psnr`` comes from the
mean squared error over the whole batch.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, List, Tuple

import torch
import torch.distributed as dist

from gaussian_splatting_tpu_torch.core.se3 import apply_pose_delta
from gaussian_splatting_tpu_torch.models.gaussians import (
    PARAM_KEYS,
    GaussianParams,
    GaussianState,
)
from gaussian_splatting_tpu_torch.ops.render import project_and_shade, resolve_backend
from gaussian_splatting_tpu_torch.ops.rasterize_ref import rasterize_reference
from gaussian_splatting_tpu_torch.ops.tiling import cdiv
from gaussian_splatting_tpu_torch.training.loss import scale_ratio_reg, ssim_map, stclamp
from gaussian_splatting_tpu_torch.training.optimizer import AdamState
from gaussian_splatting_tpu_torch.training.step import (
    STAT_KEYS,
    TrainState,
    ViewBatch,
    apply_gradients,
    leaf_grad,
)

_STATE_KEYS = ("alive", "xyz_grad_accum", "xyz_grad_count", "max_radii2d")

# (operation, axis, elements) of every collective the step issued since
# the last ``reset_collectives``: "all_gather", "reduce_scatter", "halo"
# (one batched send/receive exchange) and "all_reduce"; the axis is
# "model", "data" or "world".
_collectives: List[Tuple[str, str, int]] = []


def reset_collectives() -> None:
    _collectives.clear()


def collectives() -> List[Tuple[str, str, int]]:
    return list(_collectives)


def _all_reduce(x: torch.Tensor, mesh, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    group = {"data": mesh.data_group, "model": mesh.model_group,
             "world": mesh.world_group}[axis]
    _collectives.append(("all_reduce", axis, x.numel()))
    dist.all_reduce(x, op=op, group=group)
    return x


def _quiet(fn: Callable, *args, **kw):
    """``fn`` with its FutureWarning silenced: newer PyTorch renames the
    tensor collectives (``all_gather_single``, ``reduce_scatter_single``)
    and warns on the names that exist in every version this package
    runs on."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kw)


class _GatherModel(torch.autograd.Function):
    """All-gather over ``model`` of this rank's screen-space columns, (Cs,)
    or (Cs, w) each, packed into one (Cs, k) buffer: one collective a view.
    Returns each column gathered, (M Cs,) or (M Cs, w), contiguous. The
    backward is the transpose, a summing reduce-scatter of the packed
    gradients, so each rank gets back the gradient of its own rows summed
    over the bands. Integer columns travel as float32 (exact below 2^24)
    and carry no gradient."""

    @staticmethod
    def forward(ctx, mesh, *cols):
        ctx.mesh = mesh
        ctx.shapes = [tuple(c.shape[1:]) for c in cols]
        ctx.dtypes = [c.dtype for c in cols]
        Cs = cols[0].shape[0]
        packed = torch.cat([c.reshape(Cs, -1).to(torch.float32) for c in cols], dim=1)
        M = mesh.shape["model"]
        full = packed.new_empty((M * Cs, packed.shape[1]))
        _collectives.append(("all_gather", "model", full.numel()))
        _quiet(dist.all_gather_into_tensor, full, packed, group=mesh.model_group)
        outs = _unpack(full, ctx.shapes, ctx.dtypes)
        ctx.mark_non_differentiable(*[o for o in outs if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        mesh = ctx.mesh
        M = mesh.shape["model"]
        C = grads[0].shape[0]
        g = torch.cat([(gi if gi is not None and dt.is_floating_point
                        else torch.zeros((C,) + sh, dtype=torch.float32, device=grads[0].device)
                        ).reshape(C, -1) for gi, sh, dt in zip(grads, ctx.shapes, ctx.dtypes)],
                      dim=1)
        out = g.new_empty((C // M, g.shape[1]))
        _collectives.append(("reduce_scatter", "model", g.numel()))
        _quiet(dist.reduce_scatter_tensor, out, g, op=dist.ReduceOp.SUM, group=mesh.model_group)
        return (None,) + _unpack(out, ctx.shapes, ctx.dtypes)


def _unpack(buf, shapes, dtypes):
    """The contiguous columns of a packed (n, k) buffer."""
    outs, col = [], 0
    for sh, dt in zip(shapes, dtypes):
        w = math.prod(sh)
        outs.append(buf[:, col:col + w].reshape((buf.shape[0],) + sh).to(dt).contiguous())
        col += w
    return tuple(outs)


def _exchange_edges(top: torch.Tensor, bottom: torch.Tensor, mesh):
    """Send ``top`` (a band's first row) to the band above and ``bottom``
    (its last row) to the band below; return (the row received from the
    band above, the row received from the band below), zeros at the image's
    edges."""
    M = mesh.shape["model"]
    m = mesh.coord[1]
    ranks = mesh.model_ranks
    top, bottom = top.contiguous(), bottom.contiguous()
    from_above = torch.zeros(bottom.shape, dtype=bottom.dtype, device=bottom.device)
    from_below = torch.zeros(top.shape, dtype=top.dtype, device=top.device)
    ops = []
    if m > 0:
        ops += [dist.P2POp(dist.isend, top, ranks[m - 1], mesh.model_group),
                dist.P2POp(dist.irecv, from_above, ranks[m - 1], mesh.model_group)]
    if m < M - 1:
        ops += [dist.P2POp(dist.irecv, from_below, ranks[m + 1], mesh.model_group),
                dist.P2POp(dist.isend, bottom, ranks[m + 1], mesh.model_group)]
    _collectives.append(("halo", "model", top.numel()))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_above, from_below


class _HaloRows(torch.autograd.Function):
    """(h, W, C) band -> (h + 2, W, C): the last row of the band above on
    top, the first row of the band below at the bottom (zeros at the
    image's edges). The backward sends the halo rows' gradients back to the
    bands they came from and adds the ones received to the band's edge
    rows."""

    @staticmethod
    def forward(ctx, img, mesh):
        ctx.mesh = mesh
        above, below = _exchange_edges(img[0], img[-1], mesh)
        return torch.cat([above[None], img, below[None]], dim=0)

    @staticmethod
    def backward(ctx, g):
        # The gradient of row 0 belongs to the band above's last row, that
        # of row -1 to the band below's first row.
        above, below = _exchange_edges(g[0], g[-1], ctx.mesh)
        gi = g[1:-1].clone()
        gi[0] += above
        gi[-1] += below
        return gi, None


def _halo_extend_rows(img: torch.Tensor, mesh) -> torch.Tensor:
    """One row from each neighbouring band around ``img``; with M == 1 the
    image's own zero padding, with nothing communicated."""
    if mesh.shape["model"] == 1:
        z = torch.zeros_like(img[:1])
        return torch.cat([z, img, z], dim=0)
    return _HaloRows.apply(img, mesh)


def _masked_ssim_sum(img1, img2, mask):
    """Sum (not mean) of the SSIM map over the masked pixels of (h + 2, W,
    C) halo-extended images, so bands add up to the global mean over the
    global pixel count; the halo rows only feed the 3x3 windows of the
    band's edge rows."""
    return torch.sum(ssim_map(img1, img2)[1:-1] * mask)


# ---- ZeRO placement --------------------------------------------------------


def _map_capacity(state: TrainState, fn) -> TrainState:
    """``state`` with ``fn`` applied to every capacity-leading tensor."""
    g = state.gauss
    params = GaussianParams(**{k: fn(getattr(g.params, k)) for k in PARAM_KEYS})
    gauss = GaussianState(params=params, **{k: fn(getattr(g, k)) for k in _STATE_KEYS})
    opt = AdamState(mu=GaussianParams(**{k: fn(getattr(state.opt.mu, k)) for k in PARAM_KEYS}),
                    nu=GaussianParams(**{k: fn(getattr(state.opt.nu, k)) for k in PARAM_KEYS}),
                    step=state.opt.step)
    return TrainState(gauss=gauss, opt=opt, iteration=state.iteration, poses=state.poses)


def shard_state(state: TrainState, mesh) -> TrainState:
    """This rank's ZeRO shard of a full (replicated) state: rows
    [m C/M, (m+1) C/M) of every capacity-leading tensor, each its own
    contiguous copy; pose state and counters shared. With M == 1 the state
    itself. Raises when M does not divide the capacity."""
    M = mesh.shape["model"]
    C = state.gauss.capacity
    if C % M != 0:
        raise ValueError(f"capacity {C} must divide model axis {M}")
    if M == 1:
        return state
    m, Cs = mesh.coord[1], C // M
    return _map_capacity(state, lambda x: x[m * Cs:(m + 1) * Cs].clone())


def gather_state(state: TrainState, mesh) -> TrainState:
    """The full state from the shards (all-gathers over ``model``), the
    same on every rank; with M == 1 the state itself."""
    M = mesh.shape["model"]
    if M == 1:
        return state

    def gather(x):
        src = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
        out = src.new_empty((M * x.shape[0],) + tuple(x.shape[1:]))
        _quiet(dist.all_gather_into_tensor, out, src, group=mesh.model_group)
        return out.to(x.dtype)

    return _map_capacity(state, gather)


# ---- the step --------------------------------------------------------------


def band_geometry(height: int, tile_size: int, M: int) -> Tuple[int, int]:
    """(band_h, h_pad): each band's rows, whole tiles, and the padded image
    height M band_h."""
    band_h = cdiv(cdiv(height, tile_size), M) * tile_size
    return band_h, M * band_h


DEFORM_ON_MESH = (
    "Deformable 3D Gaussians on a mesh: the sharded step has no deformation MLP yet (its "
    "weights replicated on every rank with an all-reduce of their gradients, the offsets of "
    "each rank's ZeRO rows, the time of each rank's views); train with deform on one device")


def make_sharded_train_step(config, mesh, width: int, height: int, sh_degree: int,
                            backend: str, scene_extent: float):
    """The training step on ``mesh``. Returns ``(step, band_h, h_pad)``.

    ``step(state, batch) -> (state, metrics)`` takes this rank's ZeRO shard
    of the state (``shard_state``) and the whole batch, the same on every
    rank: images (B, H or h_pad, W, 3), B divisible by D. Rank (d, m)
    renders views [d B/D, (d+1) B/D) at rows [m band_h, (m+1) band_h). The
    state's tensors are updated in place; the metrics, keyed as the
    single-device step's, are reduced over the mesh and the same on every
    rank. The deformation (``config.deform``) is not sharded yet and
    raises ``NotImplementedError``."""
    if getattr(config, "deform", False):
        raise NotImplementedError(DEFORM_ON_MESH)
    backend = resolve_backend(backend)
    D, M = mesh.shape["data"], mesh.shape["model"]
    d, m = mesh.coord
    dev = mesh.device
    ts = config.tile_size
    band_h, h_pad = band_geometry(height, ts, M)
    y0 = m * band_h
    lam = config.lambda_dssim
    optimize_poses = bool(config.optimize_poses)
    want_stats = backend == "cuda"
    rows = torch.arange(band_h, dtype=torch.float32, device=dev)[:, None, None]
    valid = ((rows + y0) < float(height)).to(torch.float32)  # (band_h, 1, 1)
    shift = torch.tensor([0.0, float(y0)], dtype=torch.float32, device=dev)

    def band_rows(images: torch.Tensor) -> torch.Tensor:
        """Rows [y0 - 1, y0 + band_h + 1) of (Bl, h, W, 3) images, zero
        outside the image: the band with its SSIM halo rows."""
        Bl, h, W, C = images.shape
        out = images.new_zeros((Bl, band_h + 2, W, C))
        lo, hi = max(y0 - 1, 0), min(y0 + band_h + 1, h)
        if hi > lo:
            out[:, lo - (y0 - 1):hi - (y0 - 1)] = images[:, lo:hi]
        return out

    def rasterize_band(means2d, conics, colors, opac, depths, radii):
        if backend == "ref":
            return rasterize_reference(means2d, conics, colors, opac, depths, radii, width,
                                       band_h, tile_size=ts).image, None
        from gaussian_splatting_tpu_torch.ops.rasterize_cuda import rasterize_tiled

        img, _, _, stats = rasterize_tiled(
            means2d, conics, colors, opac, depths, radii, width, band_h, tile_size=ts,
            chunk=config.raster_chunk, max_tiles_per_gaussian=config.max_tiles_per_gaussian,
            class_budgets=config.class_budgets, depth_bits=config.sort_depth_bits,
            sort_buckets=config.sort_buckets, bucket_headroom=config.partition_headroom,
            sort_bands=config.sort_bands, with_stats=True,
            grad_buffer_frac=config.grad_buffer_frac, reduce_slices=config.reduce_slices,
            # The loss is photometric: the depth output never gets a
            # cotangent, so the reduce leaves out its payload.
            depth_grad=False)
        return img, stats

    def local_loss(params: GaussianParams, alive, deltas, images, viewmats, Ks, view_idx):
        """This rank's partial loss (its share of the global loss, before
        the regularizer) and its unreduced sums, stats and radii maximum."""
        sh = params.sh_coeffs
        masked_op = params.masked_opacities(alive)
        sums = torch.zeros(3, dtype=torch.float32, device=dev)  # l1, ssim, mse
        stats = torch.zeros(len(STAT_KEYS), dtype=torch.int64, device=dev)
        partial = torch.zeros((), dtype=torch.float32, device=dev)
        radii_max = None
        for b in range(images.shape[0]):
            viewmat = viewmats[b]
            if deltas is not None:
                viewmat = apply_pose_delta(viewmat, deltas[view_idx[b]])
            proj, colors_s, opac_s = project_and_shade(
                params.means, params.quats, params.log_scales, masked_op, sh, viewmat, Ks[b],
                width, height, sh_degree=sh_degree, rasterize_mode=config.rasterize_mode)
            means2d, conics, depths, colors, opac, radii = _GatherModel.apply(
                mesh, proj.means2d, proj.conics, proj.depths, colors_s, opac_s,
                proj.radii.detach())
            img, st = rasterize_band(means2d - shift, conics, colors, opac, depths, radii)
            radii_max = radii if radii_max is None else torch.maximum(radii_max, radii)
            gt_ext = images[b]
            gt = gt_ext[1:-1]
            # Zero the pad rows before SSIM: the single-device SSIM never
            # sees them, and its bottom-edge windows zero-pad.
            r = stclamp(img) * valid
            l1_b = torch.sum(torch.abs(r - gt) * valid)
            ssim_b = _masked_ssim_sum(_halo_extend_rows(r, mesh), gt_ext, valid)
            with torch.no_grad():
                mse_b = torch.sum(((torch.clamp(img, 0.0, 1.0) - gt) ** 2) * valid)
            partial = partial + (1.0 - lam) * l1_b - lam * ssim_b
            sums = sums + torch.stack([l1_b.detach(), ssim_b.detach(), mse_b])
            if st is not None:
                stats = stats + torch.stack([st[k] for k in STAT_KEYS])
        return partial, sums, stats, radii_max

    def mesh_grad_norms(grads: GaussianParams) -> dict:
        """Global gradient norms: the shards' squared sums over "model"."""
        sq = torch.stack([torch.sum(getattr(grads, k) ** 2) for k in PARAM_KEYS])
        if M > 1:
            sq = _all_reduce(sq, mesh, "model")
        return {f"grad_norm/{k}": v for k, v in zip(PARAM_KEYS, torch.sqrt(sq).unbind())}

    def step(state: TrainState, batch: ViewBatch):
        B = batch.images.shape[0]
        if B % D != 0:
            raise ValueError(f"batch {B} must divide mesh_data {D}")
        Bl = B // D
        gauss = state.gauss
        Cs = gauss.capacity
        pose_on = (optimize_poses and state.poses is not None
                   and batch.view_idx is not None)
        views = slice(d * Bl, (d + 1) * Bl)
        images = band_rows(batch.images[views])
        view_idx = batch.view_idx[views] if pose_on else None
        leaves = GaussianParams(**{k: getattr(gauss.params, k).detach().requires_grad_(True)
                                   for k in PARAM_KEYS})
        deltas = state.poses.deltas.detach().requires_grad_(True) if pose_on else None

        partial, sums, stats, radii_max = local_loss(
            leaves, gauss.alive, deltas, images, batch.viewmats[views], batch.Ks[views],
            view_idx)
        n_px = float(B * height * width * 3)
        (partial / n_px).backward()
        grads = [leaf_grad(getattr(leaves, k)) for k in PARAM_KEYS]
        if D > 1:
            flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh, "data")
            grads = [c.view_as(g) for c, g in zip(torch.split(flat, [g.numel() for g in grads]),
                                                   grads)]
        grads = GaussianParams(**dict(zip(PARAM_KEYS, grads)))
        # The regularizer is a mean over the global alive gaussians; its
        # gradient is added after the data reduce so it counts once.
        with torch.no_grad():
            n_alive = _all_reduce(gauss.alive.sum().to(torch.float32).reshape(1), mesh,
                                  "model")[0]
        ls = leaves.log_scales.detach().requires_grad_(True)
        reg_local = scale_ratio_reg(ls, gauss.alive, config.scale_reg_max_ratio,
                                    config.scale_reg_weight, n_alive=n_alive)
        reg_local.backward()
        grads.log_scales = grads.log_scales + ls.grad
        g_pose = None
        if pose_on:
            g_pose = _all_reduce(leaf_grad(deltas).contiguous(), mesh, "world")

        with torch.no_grad():
            # Logged values: sums and counts over the whole mesh.
            red = _all_reduce(torch.cat([sums.to(torch.float64), stats.to(torch.float64),
                                         reg_local.detach().reshape(1).to(torch.float64)]),
                              mesh, "world")
            l1, ssim_v, mse = (red[:3] / n_px).to(torch.float32).unbind()
            # The regularizer's shard sums are the same on every data rank.
            reg = (red[-1] / D).to(torch.float32)
            loss = (1.0 - lam) * l1 + lam * (1.0 - ssim_v) + reg
            psnr = torch.where(mse < 1e-10, torch.full_like(mse, 100.0),
                               -10.0 * torch.log10(torch.clamp_min(mse, 1e-10)))
            metrics = {"l1": l1, "ssim": ssim_v, "psnr": psnr, "scale_reg": reg}
            if want_stats:
                metrics.update({f"stats/{k}": v for k, v in
                                zip(STAT_KEYS, red[3:3 + len(STAT_KEYS)].to(torch.int64))})
            metrics["loss"] = loss
            # Densify bookkeeping: the per-gaussian maximum radius over the
            # rank's views (the gathered radii are the same on every band),
            # this rank's shard of it, maximized over the data ranks.
            rmax = radii_max[m * Cs:(m + 1) * Cs].contiguous()
            if D > 1:
                rmax = _all_reduce(rmax, mesh, "data", op=dist.ReduceOp.MAX)
        apply_gradients(config, state, grads, rmax, scene_extent, metrics, pose_grad=g_pose,
                        grad_norms=mesh_grad_norms)
        return state, metrics

    return step, band_h, h_pad


def pad_images_for_bands(images: torch.Tensor, h_pad: int) -> torch.Tensor:
    """Zero-pad (B, H, W, 3) images to (B, h_pad, W, 3) for band sharding."""
    B, H, W, C = images.shape
    if H == h_pad:
        return images
    return torch.cat([images, images.new_zeros((B, h_pad - H, W, C))], dim=1)
