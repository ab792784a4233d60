"""Host-side training orchestration (counterpart of
``gaussian_splatting_tpu/training/trainer.py``).

Division of labor, as in the JAX package:
- every step is ``training/step.py``'s step on the device, the training
  images resident there as uint8 and each batch gathered on the device;
- the host loop handles the cadenced events: densify and opacity reset
  (masked, in ``models/densify.py``), SH-degree bumps and capacity growth
  (each a new step function, cached by its configuration), validation with
  optional test-time pose alignment, checkpoints with resume, metrics;
- three watchdogs keep the static sizes honest: class-budget overflow
  re-measures the compact binning's budgets with escalating headroom,
  persistent tile-cap drops double ``max_tiles_per_gaussian``, and a probe
  of the exact gradient-stream occupancy raises ``grad_buffer_frac``.

Backends: ``auto`` and ``cuda`` run the kernels (compact binning chosen by
the trainer unless ``binning="dense"``), ``ref`` the PyTorch oracle. The
trainer runs on CUDA unless ``device`` names another device.

On a mesh (``mesh_data * mesh_tile > 1``, or a ``mesh`` the caller passes,
of any size; one process a rank, ``parallel/mesh.py``) every step is
``parallel/sharded_step.py``'s and the state lives as ZeRO shards between
steps. Each host-cadenced event that reads or changes the population
(densify, capacity growth, the budget and tile-cap re-measurements, the
grad-buffer probe, histograms, validation, checkpoints and the final
export) runs on the gathered state identically on every rank, with the same
seeds and generators, and densify re-shards its result; the opacity reset
is elementwise and runs on the shards. Only global rank 0 writes files and
logs.

Spans (``utils/profiling``): ``train.batch`` (the batch's gather and uint8
to float conversion on the device), ``train.step``, ``train.log`` (the
scalar record, whose reads wait for the device, and its write), and one a
host-cadenced event: ``train.densify``, ``train.grow``,
``train.watch_budgets``, ``train.watch_tile_cap``,
``train.probe_grad_buffer``, ``train.validate``, ``train.histograms``,
``train.checkpoint``.

Deformable 3D Gaussians (``config.deform``, ``models/deform.py``): the state
gains the deformation network and its moments (initialised from
``val_seed`` unless the checkpoint holds them); each view has a time
(``ViewDataset.times``, frame order v / (V - 1) by default); from
``deform_warmup`` on each batch carries its views' times plus the annealing
noise, drawn from the trainer's seeded generator, and the step deforms the
gaussians; validation renders each view at its time. Densify and capacity
growth leave the network as it is (it has no per-gaussian rows). Not on a
mesh yet (``NotImplementedError``).

4D Gaussian Splatting (``config.deform_field = "hexplane"``,
``models/hexplane.py``): the same, with a HexPlane field and its decoder in
place of the MLP, its box set from the initial points (the alive means
without them) and kept in the checkpoint, and no annealing noise on the
times. Not on a mesh, with surfels or with pose refinement (training or
validation alignment) (``NotImplementedError``).

2D Gaussian Splatting (``config.surfels``, ``ops/surfel.py``): the scene is
initialised as surfels (two scales a row, random orientations), the tile
cap and class budgets are measured from the surfels' binning ellipses, and
the step adds the normal and distortion terms. A checkpoint resumes only
with the ``surfels`` setting it was written with. Not on a mesh, with
``deform``, with pose refinement (training or validation alignment) or with
a gradient buffer below 1 (``NotImplementedError``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from gaussian_splatting_tpu_torch._device import DeviceLike, resolve_device
from gaussian_splatting_tpu_torch.core.activations import opacity_activation, scale_activation
from gaussian_splatting_tpu_torch.core.se3 import apply_pose_delta
from gaussian_splatting_tpu_torch.models import deform as deform_model
from gaussian_splatting_tpu_torch.models import hexplane as hexplane_model
from gaussian_splatting_tpu_torch.models.densify import densify_and_prune, reset_opacity
from gaussian_splatting_tpu_torch.models.gaussians import (
    PARAM_KEYS,
    GaussianParams,
    grow_capacity,
    init_from_points,
    init_random,
)
from gaussian_splatting_tpu_torch.ops.render import render, resolve_backend
from gaussian_splatting_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from gaussian_splatting_tpu_torch.training.config import TrainingConfig
from gaussian_splatting_tpu_torch.training.export import export_state_ply
from gaussian_splatting_tpu_torch.training.loss import psnr as psnr_fn
from gaussian_splatting_tpu_torch.training.loss import ssim as ssim_fn
from gaussian_splatting_tpu_torch.training.optimizer import AdamState, adam_init, adam_step
from gaussian_splatting_tpu_torch.training.step import (
    TrainState,
    ViewBatch,
    make_train_step,
    pose_state_init,
)
from gaussian_splatting_tpu_torch.utils import profiling
from gaussian_splatting_tpu_torch.utils.metrics import MetricsLogger, NullLogger

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ViewDataset:
    """All training views at one resolution, on the host."""

    images: np.ndarray    # (V, H, W, 3) uint8, RGB
    viewmats: np.ndarray  # (V, 4, 4) float32 world-to-camera
    Ks: np.ndarray        # (V, 3, 3) float32
    # (V,) float32 time of each view (a video's frame order); None: v / (V - 1)
    # where the deformation needs one.
    times: Optional[np.ndarray] = None

    def view_times(self) -> np.ndarray:
        """Each view's time: ``times``, or frame order v / (V - 1)."""
        if self.times is not None:
            return np.asarray(self.times, np.float32).reshape(-1)
        V = self.num_views
        return (np.arange(V, dtype=np.float64) / max(V - 1, 1)).astype(np.float32)

    @property
    def num_views(self) -> int:
        return self.images.shape[0]

    @property
    def height(self) -> int:
        return self.images.shape[1]

    @property
    def width(self) -> int:
        return self.images.shape[2]


def compute_scene_geometry(points_3d: np.ndarray, all_poses: List[np.ndarray]):
    """Robust scene extent: min(2 x median radius from the median centroid,
    2 x median camera-frame depth), and the in-extent mask that filters
    outliers (``trainer.py:67-93`` of the JAX package)."""
    points_3d = np.asarray(points_3d, np.float64)
    if len(points_3d) == 0:
        return 10.0, np.zeros(0, dtype=bool)
    centroid = np.median(points_3d, axis=0)
    radii = np.linalg.norm(points_3d - centroid, axis=1)
    bbox = points_3d.max(0) - points_3d.min(0)
    if len(radii) >= 8 and np.isfinite(radii).any():
        med_radius = float(np.median(radii[np.isfinite(radii)]))
        depths = []
        Xh = np.hstack([points_3d, np.ones((len(points_3d), 1))])
        for pose_arr in all_poses:
            for pose in np.asarray(pose_arr).reshape(-1, 4, 4):
                with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
                    z = (pose @ Xh.T).T[:, 2]
                z = z[(z > 0) & np.isfinite(z)]
                if len(z):
                    depths.append(float(np.median(z)))
        depth_cap = 2.0 * float(np.median(depths)) if depths else float("inf")
        extent = float(min(2.0 * med_radius, depth_cap))
    else:
        extent = float(np.linalg.norm(bbox))
    return extent, radii <= extent


def align_pose(render_image, viewmat: torch.Tensor, gt: torch.Tensor, n_steps: int, lr: float,
               lr_decay: float, b1: float, b2: float, eps: float) -> torch.Tensor:
    """Test-time pose alignment: ``n_steps`` of Adam on one se(3) delta xi of
    ``viewmat``, the gaussians frozen, against the MSE of the clipped
    ``render_image(apply_pose_delta(viewmat, xi))`` to ``gt``, at the rate
    ``lr * lr_decay ** (t / n_steps)`` of step t (``lr_decay`` 1 keeps it
    constant). Returns the view at the best delta visited, xi = 0 first, so
    the aligned MSE is never above the raw one.

    The trainer's validation decays the rate 30x with the config's betas
    (JAX ``trainer.py:845``); the eval CLI keeps it constant with betas
    (0.9, 0.999, 1e-8) (JAX ``eval_cli.py:164-208``)."""
    xi, mu, nu, best_xi = (torch.zeros((6,), dtype=torch.float32, device=viewmat.device)
                           for _ in range(4))
    best_l = torch.tensor(float("inf"), device=viewmat.device)
    for i in range(n_steps):
        leaf = xi.detach().requires_grad_(True)
        d = torch.clamp(render_image(apply_pose_delta(viewmat, leaf)), 0.0, 1.0) - gt
        loss = torch.mean(d * d)
        (g,) = torch.autograd.grad(loss, leaf)
        with torch.no_grad():
            better = loss < best_l
            best_xi = torch.where(better, xi, best_xi)
            best_l = torch.where(better, loss, best_l)
            # Bias corrections and rate as Python doubles, as the JAX eval
            # CLI computes them.
            t = float(i + 1)
            adam_step(xi, g, mu, nu, lr * lr_decay ** (t / float(n_steps)), 1.0 - b1 ** t,
                      1.0 - b2 ** t, b1, b2, eps)
    return apply_pose_delta(viewmat, best_xi)


def _pad_moments(moments: GaussianParams, params: GaussianParams) -> GaussianParams:
    """Adam moments zero-padded to the grown parameters' capacity."""
    def pad(m, p):
        out = torch.zeros_like(p)
        out[:m.shape[0]] = m
        return out

    return GaussianParams(**{k: pad(getattr(moments, k), getattr(params, k))
                             for k in PARAM_KEYS})


class GaussianTrainer:
    """``mesh`` (``parallel.make_mesh``), when given, is the mesh to train on
    and its device the rank's; without it the trainer builds one from
    ``mesh_data`` x ``mesh_tile`` when that is above 1."""

    def __init__(self, config: TrainingConfig, logger: Optional[MetricsLogger] = None,
                 device: DeviceLike = None, mesh=None):
        self.config = config
        self.logger = logger
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.backend = resolve_backend(config.backend)
        self._cum = {"cloned": 0, "split": 0, "pruned": 0, "events": 0}
        self._overflow_strikes = 0
        self._rebudget_count = 0
        self._last_rebudget_iter = -(10**9)
        self._tilecap_strikes = 0
        self._last_tilecap_iter = -(10**9)
        self._view_times = None

    def _active_sh_degree(self, iteration: int) -> int:
        cfg = self.config
        return min(iteration // cfg.sh_increment_interval, cfg.sh_degree_max)

    # ---- static sizes from the population ---------------------------------

    def _measure_footprints(self, state, dataset, cfg, bands: bool = False):
        """Exact per-gaussian sheared-window tile counts (``tiling.
        exact_tile_counts``, the formula of ``_tile_rects``) of the alive
        gaussians over up to 3 evenly spaced views: one array of the
        nonzero counts per view. With ``bands`` on a mesh whose model axis
        splits the image into bands of tile rows, one array per view and
        band, each footprint clipped to its band as the band's binning
        clips it (a footprint cut by a band edge falls into a smaller
        class)."""
        from gaussian_splatting_tpu_torch.ops.projection import project_gaussians
        from gaussian_splatting_tpu_torch.ops.tiling import exact_tile_counts

        M = self.mesh.shape["model"] if bands and self.mesh is not None else 1
        band_h = dataset.height
        if M > 1:
            from gaussian_splatting_tpu_torch.parallel.sharded_step import band_geometry

            band_h = band_geometry(dataset.height, cfg.tile_size, M)[0]

        p = state.gauss.params
        dev = p.means.device
        alive = state.gauss.alive.cpu().numpy()
        counts = []
        # A HexPlane field moves and scales the gaussians before the
        # activations: each view's footprints are the deformed gaussians'
        # at its time (the MLP's offsets are not applied here).
        field = isinstance(state.deform, hexplane_model.HexPlaneState)
        with torch.no_grad():
            scales = scale_activation(p.log_scales)
            opac = opacity_activation(p.logit_opacities)[:, 0].cpu().numpy()
            for i in np.linspace(0, dataset.num_views - 1, min(3, dataset.num_views)).astype(int):
                if field:
                    p = self._view_params(state, int(i))[0]
                    scales = scale_activation(p.log_scales)
                viewmat = torch.as_tensor(dataset.viewmats[i], dtype=torch.float32, device=dev)
                K = torch.as_tensor(dataset.Ks[i], dtype=torch.float32, device=dev)
                if p.surfels:
                    # The surfels' binning ellipses (ops/surfel.py).
                    from gaussian_splatting_tpu_torch.ops.surfel import surfel_screen

                    m2d, con, rad, _ = surfel_screen(p.means, p.quats, p.log_scales,
                                                     p.logit_opacities, viewmat, K,
                                                     dataset.width, dataset.height)
                else:
                    proj = project_gaussians(p.means, p.quats, scales, viewmat, K,
                                             dataset.width, dataset.height)
                    m2d, con, rad = proj.means2d, proj.conics, proj.radii
                means2d = m2d.cpu().numpy()[alive]
                radii = rad.cpu().numpy()[alive]
                conics = con.cpu().numpy()[alive]
                for m in range(M):
                    nt = exact_tile_counts(
                        means2d - np.asarray([0.0, m * band_h], means2d.dtype), radii,
                        dataset.width, band_h, cfg.tile_size, conics=conics,
                        opacities=opac[alive])
                    if (nt > 0).any():
                        counts.append(nt[nt > 0])
        return counts

    def _choose_max_tiles(self, state, dataset, cfg) -> int:
        """p95 of the population's per-gaussian tile count over a few views,
        clipped to [configured cap, sort-size budget, 256], rounded up to a
        power of two."""
        counts = self._measure_footprints(state, dataset, cfg)
        if not counts:
            return cfg.max_tiles_per_gaussian
        p95 = float(np.percentile(np.concatenate(counts), 95))
        budget = max(cfg.max_sort_entries // max(state.gauss.capacity, 1), 8)
        chosen = int(min(max(p95, cfg.max_tiles_per_gaussian), budget, 256))
        return 1 << (chosen - 1).bit_length()

    def _choose_class_budgets(self, state, dataset, cfg, max_t,
                              headroom: float = 1.1) -> tuple:
        """Per-footprint-class gaussian budgets for the compact binning: the
        per-class maximum of the class histograms over a few views (and
        over the bands of a mesh, which bins each band with these budgets),
        times ``headroom``, rounded up to 128 plus 128, capped at the
        capacity, trimmed under a power of two where that costs at most 10 %
        of the slots (never below the measured populations), and scaled
        down to ``max_sort_entries`` slots if above."""
        from gaussian_splatting_tpu_torch.ops.tiling import class_caps, squeeze_budgets_under_pow2

        caps = np.asarray(class_caps(int(max_t)), np.int64)
        L = len(caps)
        per_view = []
        for nt in self._measure_footprints(state, dataset, cfg, bands=True):
            cls = np.searchsorted(caps, np.clip(nt, 1, max_t))
            per_view.append(np.bincount(cls, minlength=L)[:L])
        counts = np.max(per_view, axis=0) if per_view else np.zeros(L, np.int64)
        budgets = np.ceil(counts * headroom / 128.0).astype(np.int64) * 128 + 128
        budgets = np.minimum(budgets, state.gauss.capacity)
        hard_min = np.minimum(np.ceil(counts / 128.0).astype(np.int64) * 128,
                              state.gauss.capacity)
        budgets = np.asarray(squeeze_budgets_under_pow2(budgets, hard_min, caps), np.int64)
        slots = int((budgets * caps).sum())
        if slots > cfg.max_sort_entries:
            scale = cfg.max_sort_entries / slots
            budgets = np.maximum((budgets * scale).astype(np.int64) // 128 * 128, 128)
            log.warning("class budgets scaled to fit max_sort_entries (%d -> %d slots)",
                        slots, int((budgets * caps).sum()))
        return tuple(int(b) for b in budgets)

    def _render_meta(self, extent: float) -> dict:
        """Checkpoint metadata: the run's raster settings, so a render of
        the checkpoint uses them."""
        cfg = self.config
        return {
            "scene_extent": float(extent),
            "render": {
                "backend": self.backend,
                "tile_size": cfg.tile_size,
                "raster_chunk": cfg.raster_chunk,
                "max_tiles_per_gaussian": cfg.max_tiles_per_gaussian,
                "class_budgets": list(cfg.class_budgets) if cfg.class_budgets else None,
                "sh_degree_max": cfg.sh_degree_max,
                "rasterize_mode": cfg.rasterize_mode,
                "sort_buckets": cfg.sort_buckets,
                "partition_headroom": cfg.partition_headroom,
                "reduce_slices": cfg.reduce_slices,
            },
        }

    # ---- events (methods, so a caller can time them) ----------------------

    @property
    def _is_main(self) -> bool:
        """Whether this process writes files: always without a mesh, on
        global rank 0 with one."""
        return self.mesh is None or self.mesh.rank == 0

    def _full(self, state: TrainState) -> TrainState:
        """The whole state from this rank's shards (a collective: every rank
        calls it at the same point); without a mesh the state itself."""
        if self.mesh is None:
            return state
        from gaussian_splatting_tpu_torch.parallel.sharded_step import gather_state

        return gather_state(state, self.mesh)

    def _shard(self, state: TrainState) -> TrainState:
        if self.mesh is None:
            return state
        from gaussian_splatting_tpu_torch.parallel.sharded_step import shard_state

        return shard_state(state, self.mesh)

    def _make_step(self, sh_degree: int, width: int, height: int, extent: float):
        if self.mesh is not None:
            from gaussian_splatting_tpu_torch.parallel.sharded_step import (
                make_sharded_train_step,
            )

            return make_sharded_train_step(self.config, self.mesh, width, height, sh_degree,
                                           self.backend, extent)[0]
        return make_train_step(self.config, width, height, sh_degree, self.backend, extent,
                               device=self.device)

    def _grow(self, state: TrainState, out: Path, extent: float) -> TrainState:
        """Capacity growth by ``capacity_headroom`` (+2048, rounded to 2048,
        at most ``max_gaussians``), after a pre-growth checkpoint; Adam
        moments zero-padded."""
        cfg = self.config
        new_cap = min(int(state.gauss.capacity * cfg.capacity_headroom) + 2048,
                      int(cfg.max_gaussians))
        new_cap = ((new_cap + 2047) // 2048) * 2048
        ck = out / "pre_growth.npz"
        if self._is_main:
            save_checkpoint(str(ck), state, extra=self._render_meta(extent))
        log.info("growing capacity %d -> %d (pre-growth checkpoint: %s)",
                 state.gauss.capacity, new_cap, ck)
        gauss = grow_capacity(state.gauss, new_cap)
        opt = AdamState(mu=_pad_moments(state.opt.mu, gauss.params),
                        nu=_pad_moments(state.opt.nu, gauss.params), step=state.opt.step)
        return TrainState(gauss=gauss, opt=opt, iteration=state.iteration, poses=state.poses,
                          deform=state.deform)

    def _densify(self, state: TrainState, extent: float, it: int) -> TrainState:
        cfg = self.config
        gauss, (mu, nu), dstats = densify_and_prune(
            state.gauss, (state.opt.mu, state.opt.nu),
            grads_threshold=cfg.densify_grads_threshold,
            min_opacity=cfg.densify_min_opacity, extent=extent,
            max_gaussians=int(cfg.max_gaussians),
            clone_extent_ratio=cfg.densify_clone_extent_ratio,
            prune_extent_ratio=cfg.densify_prune_extent_ratio,
            topk_fraction=cfg.densify_topk_fraction, generator=self._generator)
        s = {k: int(v) for k, v in dstats._asdict().items()}
        self._cum["cloned"] += s["n_cloned"]
        self._cum["split"] += s["n_split"]
        self._cum["pruned"] += s["n_pruned"]
        self._cum["events"] += 1
        self.logger.log({
            "densify/cloned": s["n_cloned"], "densify/split": s["n_split"],
            "densify/pruned": s["n_pruned"], "densify/n_before": s["n_before"],
            "densify/n_after": s["n_after"], "densify/capped": s["capped"],
            "densify/cumulative_cloned": self._cum["cloned"],
            "densify/cumulative_split": self._cum["split"],
            "densify/cumulative_pruned": self._cum["pruned"],
            "densify/event_idx": self._cum["events"],
        }, step=it)
        return TrainState(gauss=gauss, opt=AdamState(mu=mu, nu=nu, step=state.opt.step),
                          iteration=state.iteration, poses=state.poses, deform=state.deform)

    def _save_final(self, state: TrainState, out: Path, extent: float) -> int:
        if not self._is_main:
            return int(state.gauss.n_alive())
        save_checkpoint(str(out / "final.npz"), state, extra=self._render_meta(extent))
        n = export_state_ply(state.gauss, str(out / "final.ply"))
        log.info("final export: %d gaussians", n)
        self.logger.log_artifact(str(out / "final.npz"), "checkpoint-final")
        self.logger.log_artifact(str(out / "final.ply"), "model-ply")
        return n

    def _check_surfels(self, cfg) -> None:
        """Raise ``NotImplementedError`` for what surfels do not run with
        yet, naming what is missing."""
        from gaussian_splatting_tpu_torch.ops.render import SURFELS_POSE
        from gaussian_splatting_tpu_torch.parallel.sharded_step import SURFELS_ON_MESH

        if self.mesh is not None or cfg.mesh_data * cfg.mesh_tile > 1:
            raise NotImplementedError(SURFELS_ON_MESH)
        if cfg.deform:
            raise NotImplementedError(
                "surfels with deform: the deformation's offsets move 3D gaussians through the "
                "static projection pair; the surfel pair takes none yet")
        if cfg.optimize_poses or cfg.val_pose_align_steps > 0:
            raise NotImplementedError(SURFELS_POSE)
        if cfg.grad_buffer_frac < 1.0:
            raise NotImplementedError(
                "surfels with grad_buffer_frac < 1: the gradient-buffer probe measures the "
                "static kernels' stream only")
        if cfg.rasterize_mode != "classic":
            raise NotImplementedError("surfels render in the classic opacity mode only")

    # ---- main entry --------------------------------------------------------

    def _check_hexplane(self, cfg) -> None:
        """Raise for what the HexPlane field does not run with yet, naming
        what is missing."""
        if cfg.deform_field not in ("mlp", "hexplane"):
            raise ValueError(f"deform_field is 'mlp' or 'hexplane', not {cfg.deform_field!r}")
        if not cfg.deform or cfg.deform_field != "hexplane":
            return
        if self.mesh is not None or cfg.mesh_data * cfg.mesh_tile > 1:
            raise NotImplementedError(hexplane_model.HEXPLANE_ON_MESH)
        if cfg.surfels:
            raise NotImplementedError(hexplane_model.HEXPLANE_SURFELS)
        if cfg.optimize_poses or cfg.val_pose_align_steps > 0:
            raise NotImplementedError(hexplane_model.HEXPLANE_POSE)

    def train(self, dataset: ViewDataset, output_dir: str, points: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None,
              resume_from: Optional[str] = None) -> TrainState:
        cfg = self.config
        self._check_hexplane(cfg)
        if cfg.deform and (self.mesh is not None or cfg.mesh_data * cfg.mesh_tile > 1):
            from gaussian_splatting_tpu_torch.parallel.sharded_step import DEFORM_ON_MESH

            raise NotImplementedError(DEFORM_ON_MESH)
        if cfg.surfels:
            self._check_surfels(cfg)
        if self.mesh is None and cfg.mesh_data * cfg.mesh_tile > 1:
            from gaussian_splatting_tpu_torch.parallel.mesh import make_mesh

            self.mesh = make_mesh(data=cfg.mesh_data, model=cfg.mesh_tile, device=self.device)
            self.device = self.mesh.device
        if self.mesh is not None:
            log.info("training on mesh %s", self.mesh.shape)
            if cfg.batch_size % self.mesh.shape["data"] != 0:
                raise ValueError("batch_size must divide mesh_data")
        dev = self.device
        out = Path(output_dir)
        if not self._is_main:
            self.logger = NullLogger()
        else:
            out.mkdir(parents=True, exist_ok=True)
        if self.logger is None:
            self.logger = MetricsLogger(
                str(out), config=dataclasses.asdict(cfg), wandb_mode=cfg.wandb_mode,
                wandb_project=cfg.wandb_project, wandb_entity=cfg.wandb_entity,
                wandb_run_name=cfg.wandb_run_name, wandb_tags=cfg.wandb_tags)

        width, height = dataset.width, dataset.height
        V = dataset.num_views

        # Scene geometry + outlier filter.
        if points is not None and len(points) > 0:
            extent, in_extent = compute_scene_geometry(points, [dataset.viewmats])
            points_f = np.asarray(points)[in_extent]
            colors_f = (np.asarray(colors)[in_extent]
                        if colors is not None and len(colors) == len(in_extent) else None)
        else:
            extent, points_f, colors_f = 10.0, None, None
        log.info("scene extent: %.3f", extent)

        # --- init or resume ---
        start_iter = 0
        if resume_from:
            state, meta = load_checkpoint(resume_from, device=dev)
            if state.gauss.params.surfels != bool(cfg.surfels):
                held = "surfels" if state.gauss.params.surfels else "3D gaussians"
                raise ValueError(f"{resume_from} holds {held}; resume it with "
                                 f"surfels={state.gauss.params.surfels}")
            start_iter = int(state.iteration)
            extent = float(meta.get("scene_extent", extent))
            log.info("resumed from %s at iteration %d", resume_from, start_iter)
        else:
            if points_f is not None and len(points_f) > 0:
                n_init = int(min(max(len(points_f) * 3, cfg.initial_gaussians),
                                 cfg.max_gaussians // 2))
                gauss = init_from_points(points_f, colors_f, n_init,
                                         init_opacity=cfg.init_opacity, device=dev,
                                         surfels=cfg.surfels)
            else:
                log.warning("no 3D points; random init")
                gauss = init_random(int(cfg.initial_gaussians), device=dev,
                                    surfels=cfg.surfels)
            state = TrainState(gauss=gauss, opt=adam_init(gauss.params),
                               iteration=torch.zeros((), dtype=torch.int32, device=dev))

        # Camera pose refinement: one se(3) delta per dataset view.
        if cfg.optimize_poses and state.poses is None:
            state.poses = pose_state_init(V, dev)
            log.info("pose refinement on: %d views, lr %.1e -> %.1e from iter %d", V,
                     cfg.pose_lr_init, cfg.pose_lr_final, cfg.pose_start_iter)
        hexplane = cfg.deform and cfg.deform_field == "hexplane"
        if cfg.deform and state.deform is not None and (
                isinstance(state.deform, hexplane_model.HexPlaneState) != hexplane):
            raise ValueError(f"{resume_from} holds another deformation than deform_field="
                             f"{cfg.deform_field!r}")
        if hexplane and state.deform is None:
            box = hexplane_model.box_of(
                points_f if points_f is not None and len(points_f) > 0
                else state.gauss.params.means[state.gauss.alive].detach().cpu())
            state.deform = hexplane_model.hexplane_state_init(box, cfg.val_seed, dev)
            log.info("HexPlane field, box %s, warm-up %d iterations", box.tolist(),
                     cfg.deform_warmup)
        elif cfg.deform and state.deform is None:
            state.deform = deform_model.deform_state_init(deform_model.DeformSpec(),
                                                          cfg.val_seed, dev)
            log.info("deformation MLP %s, warm-up %d iterations", state.deform.spec,
                     cfg.deform_warmup)
        if not cfg.deform:
            state.deform = None
        self._view_times = dataset.view_times() if cfg.deform else None
        log.info("capacity %d, alive %d", state.gauss.capacity, int(state.gauss.n_alive()))

        # Adaptive tile-footprint cap from the population's footprints.
        if cfg.auto_max_tiles:
            chosen = self._choose_max_tiles(state, dataset, cfg)
            if chosen != cfg.max_tiles_per_gaussian:
                log.info("auto max_tiles_per_gaussian: %d -> %d",
                         cfg.max_tiles_per_gaussian, chosen)
                cfg = self.config = cfg.replace(max_tiles_per_gaussian=chosen)

        # Compact footprint-class binning on the kernel backend.
        if (self.backend == "cuda" and cfg.binning in ("auto", "compact")
                and cfg.class_budgets is None):
            from gaussian_splatting_tpu_torch.ops.tiling import total_slots

            budgets = self._choose_class_budgets(state, dataset, cfg,
                                                 cfg.max_tiles_per_gaussian)
            log.info("compact binning budgets %s (%d slots vs dense %d)", budgets,
                     total_slots(state.gauss.capacity, cfg.max_tiles_per_gaussian, budgets),
                     state.gauss.capacity * cfg.max_tiles_per_gaussian)
            cfg = self.config = cfg.replace(class_budgets=budgets)

        # ZeRO placement on a mesh: each rank keeps its rows from here on.
        state = self._shard(state)

        if points_f is not None and len(points_f) > 0 and not resume_from and self._is_main:
            try:
                self.debug_reprojection(points_f, dataset.viewmats[0], dataset.Ks[0],
                                        dataset.images[0], str(out / "debug_reproj.png"))
            except Exception as e:  # a debug image must never kill training
                log.warning("debug reprojection failed: %s", e)

        # --- device-resident dataset + train/val split ---
        rng = np.random.RandomState(cfg.val_seed)
        n_val = (0 if V < 4 else
                 min(max(1, int(round(V * cfg.val_fraction))), cfg.val_max_views))
        perm = rng.permutation(V)
        val_idx = np.sort(perm[:n_val])
        train_idx = np.array([i for i in range(V) if i not in set(val_idx.tolist())])

        d_images = torch.as_tensor(dataset.images, device=dev)  # uint8 on the device
        d_viewmats = torch.as_tensor(dataset.viewmats, dtype=torch.float32, device=dev)
        d_Ks = torch.as_tensor(dataset.Ks, dtype=torch.float32, device=dev)
        d_times = (torch.as_tensor(self._view_times, device=dev) if cfg.deform else None)

        def gather_batch(idx) -> ViewBatch:
            if not torch.is_tensor(idx):
                idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=dev)
            return ViewBatch(images=d_images[idx].to(torch.float32) / 255.0,
                             viewmats=d_viewmats[idx], Ks=d_Ks[idx], view_idx=idx)

        # --- step cache over the static configuration ---
        step_cache: Dict = {}

        def get_step(sh_degree: int, capacity: int):
            key = (sh_degree, capacity, cfg.max_tiles_per_gaussian, cfg.class_budgets,
                   cfg.grad_buffer_frac, cfg.sort_buckets, cfg.partition_headroom,
                   cfg.sort_bands)
            if key not in step_cache:
                t0 = time.time()
                step_cache[key] = self._make_step(sh_degree, width, height, extent)
                log.info("built train step for sh=%d cap=%d (%.1fs)", sh_degree, capacity,
                         time.time() - t0)
            return step_cache[key]

        # The batches' view indices, drawn as the JAX trainer draws them (one
        # choice an iteration), uploaded once: no blocking upload a step.
        batch_rng = np.random.default_rng(cfg.val_seed + 1)
        batch_views = torch.as_tensor(np.asarray(
            [train_idx[batch_rng.choice(len(train_idx), cfg.batch_size, replace=True)]
             for _ in range(start_iter, max(cfg.iterations, start_iter))],
            np.int64).reshape(-1, cfg.batch_size), device=dev)
        self._generator = torch.Generator(device=dev).manual_seed(cfg.val_seed)
        # The annealing noise on the views' times (Deformable 3D Gaussians).
        self._time_generator = torch.Generator(device=dev).manual_seed(cfg.val_seed + 2)
        it = start_iter
        t_window = time.time()
        window_iters = 0
        self._cum = {"cloned": 0, "split": 0, "pruned": 0, "events": 0}
        self._overflow_strikes = 0
        self._rebudget_count = 0
        self._last_rebudget_iter = -(10**9)

        while it < cfg.iterations:
            with profiling.annotate("train.batch"):
                batch = gather_batch(batch_views[it - start_iter])
                if cfg.deform and it >= cfg.deform_warmup:
                    batch.times = d_times[batch.view_idx]
                    sd = 0.0 if hexplane else deform_model.time_noise_scale(it, V)
                    if sd > 0.0:
                        batch.times = batch.times + sd * torch.randn(
                            batch.times.shape, generator=self._time_generator, device=dev)
            sh_deg = self._active_sh_degree(it)
            step = get_step(sh_deg, state.gauss.capacity)
            with profiling.annotate("train.step"):
                state, metrics = step(state, batch)
            it += 1
            window_iters += 1
            # The whole state, gathered on a mesh at the first event that
            # reads it this iteration (every rank reaches the same events).
            whole = None

            def full():
                nonlocal whole
                if whole is None:
                    whole = self._full(state)
                return whole

            # Densify / prune, growing the buffers first when nearly full.
            if it > cfg.densify_from_iteration and it % cfg.densify_interval == 0:
                whole = full()
                if (int(whole.gauss.n_alive()) > 0.85 * whole.gauss.capacity
                        and whole.gauss.capacity < cfg.max_gaussians):
                    with profiling.annotate("train.grow"):
                        whole = self._grow(whole, out, extent)
                with profiling.annotate("train.densify"):
                    whole = self._densify(whole, extent, it)
                state = self._shard(whole)

            # Opacity reset (elementwise: on the shards too).
            if it % cfg.opacity_reset_interval == 0 and it > 0:
                state.gauss.params = reset_opacity(state.gauss.params)
                whole = None

            if it % cfg.log_scalar_interval == 0:
                dt = time.time() - t_window
                sps = window_iters / dt if dt > 0 else 0.0
                t_window = time.time()
                window_iters = 0
                with profiling.annotate("train.log"):
                    rec = {
                        "loss": float(metrics["loss"]),
                        "train/l1": float(metrics["l1"]),
                        "train/ssim": float(metrics["ssim"]),
                        "train/psnr": float(metrics["psnr"]),
                        "train/scale_reg": float(metrics["scale_reg"]),
                        "lr/xyz": float(metrics["xyz_lr"]),
                        "n_gaussians": int(full().gauss.n_alive()),
                        "sh_degree": sh_deg,
                        "steps_per_sec": sps,
                    }
                    rec.update({k: float(v) for k, v in metrics.items()
                                if k.startswith("grad_norm/")})
                    # Overflow counters: tile cap, class budgets, grad buffer.
                    rec.update({k: int(v) for k, v in metrics.items()
                                if k.startswith("stats/")})
                    self.logger.log(rec, step=it)
                with profiling.annotate("train.watch_budgets"):
                    cfg = self._watch_budgets(cfg, rec, full(), dataset, it)
                with profiling.annotate("train.watch_tile_cap"):
                    cfg = self._watch_tile_cap(cfg, rec, full(), dataset, it)

            if it % cfg.log_hist_interval == 0:
                with profiling.annotate("train.histograms"):
                    self._log_histograms(full(), it)

            if cfg.log_image_interval and it % cfg.log_image_interval == 0:
                try:
                    b = gather_batch([int(train_idx[0])])
                    img = self._render_view(full(), b.viewmats[0], b.Ks[0], sh_deg, width,
                                            height, int(train_idx[0]))
                    side = np.concatenate([img.cpu().numpy(), b.images[0].cpu().numpy()],
                                          axis=1)
                    self.logger.log_image("train/render_vs_gt", side, step=it)
                except Exception as e:  # logging must never kill training
                    log.warning("train image log failed: %s", e)

            if n_val > 0 and it % cfg.val_interval == 0:
                with profiling.annotate("train.validate"):
                    vm = self.validate(full(), gather_batch, val_idx, sh_deg, width, height)
                if vm:
                    self.logger.log(vm, step=it)

            # Gradient-buffer watchdog: with a shrunk buffer, probe the exact
            # occupancy on one train view and grow the fraction on drops or
            # near-full occupancy.
            if (self.backend == "cuda" and cfg.grad_buffer_frac < 1.0
                    and it % cfg.val_interval == 0):
                with profiling.annotate("train.probe_grad_buffer"):
                    cfg = self._probe_grad_buffer(cfg, full(), gather_batch, train_idx,
                                                  sh_deg, width, height, it)

            if it % cfg.checkpoint_interval == 0:
                with profiling.annotate("train.checkpoint"):
                    whole = full()
                    if self._is_main:
                        ck = out / f"checkpoint_{it}.npz"
                        save_checkpoint(str(ck), whole, extra=self._render_meta(extent))
                        export_state_ply(whole.gauss, str(out / f"checkpoint_{it}.ply"))
                        log.info("checkpoint @%d -> %s", it, ck)

        state = self._full(state)
        self._save_final(state, out, extent)
        if self._is_main:
            try:
                from gaussian_splatting_tpu_torch.utils.plots import draw_graphs

                draw_graphs(self.logger.path, str(out))
            except Exception as e:  # plots are best-effort
                log.warning("summary plots failed: %s", e)
        return state

    # ---- watchdogs -----------------------------------------------------------

    def _watch_budgets(self, cfg, rec, state, dataset, it):
        """Class-budget watchdog: drops above 1 % of the kept intersections
        at 3 scalar logs in a row, 500 iterations after the last rebudget,
        re-measure the budgets with headroom 1.1 x 1.35^k (at most 3)."""
        if cfg.class_budgets is None:
            return cfg
        n_bd = int(rec.get("stats/n_budget_dropped", 0))
        n_is = max(int(rec.get("stats/n_isect", 0)), 1)
        self._overflow_strikes = self._overflow_strikes + 1 if n_bd > 0.01 * n_is else 0
        if self._overflow_strikes >= 3 and it - self._last_rebudget_iter >= 500:
            self._rebudget_count += 1
            headroom = min(1.1 * 1.35 ** self._rebudget_count, 3.0)
            budgets = self._choose_class_budgets(state, dataset, cfg,
                                                 cfg.max_tiles_per_gaussian, headroom=headroom)
            log.warning("class-budget overflow persisted; rebudget (headroom %.2f) %s -> %s",
                        headroom, cfg.class_budgets, budgets)
            cfg = self.config = cfg.replace(class_budgets=budgets)
            self._overflow_strikes = 0
            self._last_rebudget_iter = it
        return cfg

    def _watch_tile_cap(self, cfg, rec, state, dataset, it):
        """Tile-cap watchdog: tile-cap drops above half the kept
        intersections at 3 scalar logs in a row, 500 iterations after the
        last raise, double ``max_tiles_per_gaussian`` (within the sort-entry
        budget and 256) and re-measure the class budgets for the new caps."""
        n_tc = int(rec.get("stats/n_dropped", 0))
        n_is = max(int(rec.get("stats/n_isect", 0)), 1)
        self._tilecap_strikes = self._tilecap_strikes + 1 if n_tc > 0.5 * n_is else 0
        cooled = it - self._last_tilecap_iter >= 500
        sort_budget = max(cfg.max_sort_entries // max(state.gauss.capacity, 1)
                          // max(cfg.sort_bands, 1), 8)
        if (self._tilecap_strikes >= 3 and cooled
                and cfg.max_tiles_per_gaussian * 2 <= min(sort_budget, 256)):
            new_t = cfg.max_tiles_per_gaussian * 2
            log.warning("tile-cap overflow persisted (%d dropped vs %d kept); "
                        "max_tiles_per_gaussian %d -> %d", n_tc, n_is,
                        cfg.max_tiles_per_gaussian, new_t)
            cfg = cfg.replace(max_tiles_per_gaussian=new_t)
            if cfg.class_budgets is not None:
                cfg = cfg.replace(class_budgets=self._choose_class_budgets(
                    state, dataset, cfg, new_t))
            self.config = cfg
            self._tilecap_strikes = 0
            self._last_tilecap_iter = it
        return cfg

    def _probe_grad_buffer(self, cfg, state, gather_batch, train_idx, sh_deg, width, height,
                           it):
        try:
            from gaussian_splatting_tpu_torch.ops.render import render_grad_meta

            b1 = gather_batch(train_idx[:1])
            p = state.gauss.params
            nw, nd, gcap = render_grad_meta(
                p.means, p.quats, p.log_scales, p.masked_opacities(state.gauss.alive),
                p.sh_coeffs, b1.viewmats[0], b1.Ks[0], width, height, sh_degree=sh_deg,
                tile_size=cfg.tile_size, max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
                raster_chunk=cfg.raster_chunk, class_budgets=cfg.class_budgets,
                depth_bits=cfg.sort_depth_bits, grad_buffer_frac=cfg.grad_buffer_frac,
                sort_buckets=cfg.sort_buckets, bucket_headroom=cfg.partition_headroom,
                sort_bands=cfg.sort_bands, rasterize_mode=cfg.rasterize_mode,
                device=self.device)
            self.logger.log({"stats/grad_buf_written": nw, "stats/grad_buf_dropped": nd,
                             "stats/grad_buf_cap": gcap}, step=it)
            if nd > 0 or nw > 0.92 * gcap:
                newf = min(1.0, cfg.grad_buffer_frac * 1.35)
                log.warning("grad buffer near full (%d/%d written, %d dropped); "
                            "grad_buffer_frac %.2f -> %.2f", nw, gcap, nd,
                            cfg.grad_buffer_frac, newf)
                cfg = self.config = cfg.replace(grad_buffer_frac=newf)
        except Exception as e:  # a probe must never kill training
            log.warning("grad-buffer probe failed: %s", e)
        return cfg

    def _log_histograms(self, state, it):
        """Opacity and scale quantiles and parameter histograms of the alive
        gaussians."""
        p = state.gauss.params
        alive = state.gauss.alive.cpu().numpy()
        with torch.no_grad():
            op = opacity_activation(p.logit_opacities)[:, 0].cpu().numpy()[alive]
            sc = scale_activation(p.log_scales).amax(-1).cpu().numpy()[alive]
        if not len(op):
            return
        qs = [10, 50, 90]
        self.logger.log({
            **{f"opacity/q{q}": float(np.percentile(op, q)) for q in qs},
            **{f"scale/q{q}": float(np.percentile(sc, q)) for q in qs},
            "radii2d/max": int(state.gauss.max_radii2d.max()),
        }, step=it)
        self.logger.log_histogram("params/opacity", op, step=it)
        self.logger.log_histogram("params/max_scale", sc, step=it)
        self.logger.log_histogram("params/xyz_grad_accum",
                                  state.gauss.xyz_grad_accum[:, 0].cpu().numpy()[alive], step=it)

    # ---- debug ---------------------------------------------------------------

    @staticmethod
    def debug_reprojection(points_3d, pose, K, frame_rgb, out_path="debug_reproj.png"):
        """Project the point cloud into the first view and mark the points
        red: the init sanity image. Needs PIL."""
        from PIL import Image

        X = np.asarray(points_3d, np.float64)
        img = np.asarray(frame_rgb).copy()
        X = X[np.isfinite(X).all(axis=1)]
        if len(X):
            Xh = np.hstack([X, np.ones((len(X), 1))])
            with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
                Xc = (np.asarray(pose) @ Xh.T).T
            Xc = Xc[(Xc[:, 2] > 1e-3) & np.isfinite(Xc).all(axis=1)]
            if len(Xc):
                with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
                    uvw = (np.asarray(K) @ Xc[:, :3].T).T
                    uv = uvw[:, :2] / uvw[:, 2:3]
                uv = uv[np.isfinite(uv).all(axis=1)].astype(int)
                h, w = img.shape[:2]
                inb = (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
                img[uv[inb, 1], uv[inb, 0]] = (255, 0, 0)
        Image.fromarray(img).save(out_path)
        return img

    # ---- validation ----------------------------------------------------------

    def _render_raw(self, params, masked_op, viewmat, K, sh_degree, width, height,
                    offsets=None):
        cfg = self.config
        return render(params.means, params.quats, params.log_scales, masked_op,
                      params.sh_coeffs, viewmat, K, width, height, sh_degree=sh_degree,
                      backend=self.backend, tile_size=cfg.tile_size,
                      max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
                      raster_chunk=cfg.raster_chunk, class_budgets=cfg.class_budgets,
                      sort_buckets=cfg.sort_buckets, bucket_headroom=cfg.partition_headroom,
                      reduce_slices=cfg.reduce_slices, sort_bands=cfg.sort_bands,
                      rasterize_mode=cfg.rasterize_mode, depth_grad=False,
                      offsets=offsets, device=self.device).render

    def _view_params(self, state, view: Optional[int]):
        """(parameters, offsets) to render dataset view ``view`` with,
        without gradients: the state's parameters and the MLP's offsets at
        the view's time; a HexPlane field's parameters moved by its offsets
        (before the activations) and no offsets; the state's parameters
        alone for a static state, or before the warm-up ends."""
        p = state.gauss.params
        if (self._view_times is None or view is None or state.deform is None
                or int(state.iteration) < self.config.deform_warmup):
            return p, None
        rows = torch.nonzero(state.gauss.alive).reshape(-1)
        t = float(self._view_times[view])
        d = state.deform
        with torch.no_grad():
            if isinstance(d, hexplane_model.HexPlaneState):
                m, q, s = hexplane_model.deformed(
                    p.means, p.quats, p.log_scales,
                    hexplane_model.offsets(d.params, d.box, p.means, rows, t))
                return dataclasses.replace(p, means=m, quats=q, log_scales=s), None
            return p, deform_model.offsets(d.params, d.spec, p.means, rows, t)

    def _render_view(self, state, viewmat, K, sh_degree, width, height, view=None):
        """One view of the state, clipped to [0, 1], without gradients; a
        deforming state at dataset view ``view``'s time."""
        p, offsets = self._view_params(state, view)
        with torch.no_grad():
            img = self._render_raw(p, p.masked_opacities(state.gauss.alive), viewmat, K,
                                   sh_degree, width, height, offsets)
        return torch.clamp(img, 0.0, 1.0)

    def _align_pose(self, state, viewmat, K, gt, sh_degree, width, height, view=None):
        """Test-time pose alignment of one validation view: ``align_pose``
        with the learning rate decaying 30x over ``val_pose_align_steps`` and
        the config's Adam betas (JAX ``trainer.py:845``)."""
        cfg = self.config
        p, offsets = self._view_params(state, view)
        params = GaussianParams(**{k: getattr(p, k).detach() for k in PARAM_KEYS})
        masked_op = params.masked_opacities(state.gauss.alive)
        return align_pose(
            lambda vm: self._render_raw(params, masked_op, vm, K, sh_degree, width, height,
                                        offsets),
            viewmat, gt, cfg.val_pose_align_steps, cfg.val_pose_align_lr, lr_decay=1.0 / 30.0,
            b1=cfg.adam_b1, b2=cfg.adam_b2, eps=cfg.adam_eps)

    def validate(self, state, gather_batch, val_idx, sh_degree, width, height):
        """Mean L1, SSIM and PSNR of the held-out views (and the PSNR after
        test-time pose alignment when ``val_pose_align_steps`` > 0); logs a
        render | ground-truth gallery."""
        if len(val_idx) == 0:
            return None
        cfg = self.config
        l1s, ssims, psnrs, psnrs_aligned, panels = [], [], [], [], []
        for i in val_idx:
            b = gather_batch([int(i)])
            gt = b.images[0]
            img = self._render_view(state, b.viewmats[0], b.Ks[0], sh_degree, width, height,
                                    int(i))
            l1s.append(float(torch.mean(torch.abs(img - gt))))
            ssims.append(float(ssim_fn(img, gt)))
            psnrs.append(float(psnr_fn(img, gt)))
            if cfg.val_pose_align_steps > 0:
                vm = self._align_pose(state, b.viewmats[0], b.Ks[0], gt, sh_degree, width,
                                      height, int(i))
                img = self._render_view(state, vm, b.Ks[0], sh_degree, width, height, int(i))
                psnrs_aligned.append(float(psnr_fn(img, gt)))
            panels.append(np.concatenate([img.cpu().numpy(), gt.cpu().numpy()], axis=1))
        if panels and self.logger is not None:
            try:
                self.logger.log_image("val/render_vs_gt", panels[0], step=int(state.iteration))
                if len(panels) > 1:
                    self.logger.log_image("val/gallery", np.concatenate(panels, axis=0),
                                          step=int(state.iteration))
            except Exception as e:  # logging must never kill training
                log.warning("val image log failed: %s", e)
        out = {"val/l1": float(np.mean(l1s)), "val/ssim": float(np.mean(ssims)),
               "val/psnr": float(np.mean(psnrs)), "val/n_views": len(val_idx)}
        if psnrs_aligned:
            out["val/psnr_aligned"] = float(np.mean(psnrs_aligned))
        return out
