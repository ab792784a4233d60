"""Training configuration: the port's own copy of
``gaussian_splatting_tpu/training/config.py``, every field with the same
name and default, so a configuration means the same in both packages.

``backend`` takes the port's names: ``auto`` (= ``cuda``), ``cuda`` or
``ref``. A
mesh (``mesh_data * mesh_tile > 1``) trains through
``parallel/sharded_step.py``, one process a device. The video fields
(``frame_stride``, ``image_scale``, ``cache_dir``, ``matcher``) are read by
the train CLI and ``eval_num_views`` by the eval CLI. The ``deform*``
fields (Deformable 3D Gaussians, 4D Gaussian Splatting) and the ``surfel*``
fields (2D Gaussian Splatting) are the port's own; the JAX package has
neither."""

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class TrainingConfig:
    # --- video processing (read by the train CLI) ---
    frame_stride: int = 30
    image_scale: float = 1.0
    cache_dir: str = "./cache"
    matcher: str = "sift"          # sift | orb

    # --- gaussians ---
    initial_gaussians: int = 100_000
    # Initial opacity (the reference hardcodes 0.005; the 3DGS paper uses
    # 0.1).
    init_opacity: float = 0.005
    max_gaussians: int = 10_000_000
    densify_interval: int = 100
    densify_from_iteration: int = 5000
    opacity_reset_interval: int = 5000

    # --- densify thresholds ---
    densify_grads_threshold: float = 5e-4
    # > 0: densify the top fraction of alive gaussians by accumulated grad
    # norm each event instead of the absolute threshold.
    densify_topk_fraction: float = 0.0
    densify_min_opacity: float = 0.005
    densify_clone_extent_ratio: float = 0.1
    densify_prune_extent_ratio: float = 2.0
    # --- scale regularizer and ceiling ---
    scale_clamp_ratio: float = 0.2
    scale_reg_max_ratio: float = 10.0
    scale_reg_weight: float = 0.1

    # --- SH warmup ---
    sh_degree_max: int = 3
    sh_increment_interval: int = 1000

    # --- optimization ---
    iterations: int = 300_000
    batch_size: int = 4
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-7
    position_lr_max_steps: int = 300_000
    lr_features_dc: float = 2.5e-3
    lr_features_rest: float = 1.25e-4
    lr_opacity: float = 0.05
    lr_scaling: float = 5e-3
    lr_rotation: float = 1e-3
    adam_eps: float = 1e-15
    adam_b1: float = 0.9
    adam_b2: float = 0.999

    # --- losses ---
    lambda_dssim: float = 0.2
    # "bfloat16" runs the L1/SSIM image math in bf16 with f32 scalars.
    loss_dtype: str = "float32"

    # --- rasterizer execution ---
    tile_size: int = 16
    raster_chunk: int = 256
    # Static cap on tiles covered per gaussian (overflow is counted).
    max_tiles_per_gaussian: int = 16
    # Raise the cap to the p95 of the init population's screen footprint
    # (bounded below by max_tiles_per_gaussian, above by max_sort_entries).
    auto_max_tiles: bool = True
    # Upper bound on N * max_t (sort entries) the auto mode may choose.
    max_sort_entries: int = 32_000_000
    # Compact footprint-class binning: "auto" and "compact" measure the
    # init population's class histogram on the cuda backend and set minimal
    # per-class budgets (class_budgets); overflow is counted every step
    # (stats/n_budget_dropped) and rebudgeted with escalating headroom.
    binning: str = "auto"              # auto | compact | dense
    # b > 0: the flat sort's key is one int32, tile * 2^b + the depth
    # quantized to b bits over the view's real slots (only the blend order
    # of nearly equal depths changes). Ignored by sort_buckets and
    # sort_bands, which keep the exact (tile, depth) order.
    sort_depth_bits: int = 0
    # B > 0 (a power of two): binning through the bucket partition by
    # tile % B, each 512-slot chunk given partition_headroom times its
    # balanced share per bucket; overflow is counted in n_budget_dropped.
    sort_buckets: int = 0
    partition_headroom: float = 1.5
    # K > 1: K horizontal bands of tile rows binned and sorted on their
    # own, each with the full class budgets (the stream holds K times the
    # slots); exclusive with sort_buckets.
    sort_bands: int = 0
    # >1: the gradient reduce sorts K static slices separately and adds the
    # per-slice segment sums.
    reduce_slices: int = 0
    # Per-class gaussian budgets for the caps of tiling.class_caps(max_t);
    # None = the dense N * max_t slot layout.
    class_budgets: Optional[tuple] = None
    # Gradient-buffer capacity as a fraction of the exact bound (the slot
    # count). 1.0 can never drop; below 1 the trainer probes the exact
    # occupancy every val_interval and raises the fraction when a probe
    # shows drops or > 92 % occupancy.
    grad_buffer_frac: float = 1.0
    backend: str = "auto"              # auto | cuda | ref

    # --- camera pose refinement (per-train-view se(3) delta) ---
    optimize_poses: bool = False
    pose_lr_init: float = 1e-3
    pose_lr_final: float = 1e-5
    pose_start_iter: int = 0
    # Test-time pose alignment at validation: > 0 optimizes one se(3)
    # delta per val view (gaussians frozen) and reports val/psnr_aligned.
    val_pose_align_steps: int = 0
    val_pose_align_lr: float = 3e-3
    # "antialiased" multiplies opacity by the covariance compensation factor.
    rasterize_mode: str = "classic"    # classic | antialiased

    # --- Deformable 3D Gaussians (models/deform.py; the port only): a
    # deformation MLP of (gamma(x), gamma(t)) a gaussian and view, offsets
    # of mean, rotation and scale after the activations. Off by default.
    # The network's shape and its rate and noise schedules are the
    # published constants of models/deform.py. ---
    deform: bool = False
    # The deformation's kind: "mlp" (Deformable 3D Gaussians) or "hexplane"
    # (4D Gaussian Splatting, models/hexplane.py: a HexPlane field and a small
    # decoder, offsets before the activations; its widths, regularizer
    # weights and rates are that module's published constants).
    deform_field: str = "mlp"
    # Iterations of static warm-up (4DGS's coarse stage) before the
    # deformation runs.
    deform_warmup: int = 3000

    # --- 2D Gaussian Splatting (surfels, ops/surfel.py; the port only):
    # flat gaussian discs with two scales, rendered by ray-splat
    # intersection, with the depth-distortion and normal-consistency
    # terms. Off by default. The published settings for unbounded scenes;
    # the terms' start iterations are the published constants of
    # training/loss.py. Not on a mesh, with deform or with pose refinement.
    surfels: bool = False
    surfel_lambda_dist: float = 100.0
    surfel_lambda_normal: float = 0.05
    # 0: the surface depth is the expected depth; 1: the median depth.
    surfel_depth_ratio: float = 0.0
    capacity_headroom: float = 1.5     # buffer capacity / population target
    # The JAX step donates its buffers; the port's step updates the state in
    # place either way.
    donate_step_buffers: bool = True

    # --- parallelism: a (mesh_data x mesh_tile) mesh of ranks, views over
    # "data", gaussians and image bands over "model" (parallel/) ---
    mesh_data: int = 1
    mesh_tile: int = 1

    # --- logging / validation ---
    log_scalar_interval: int = 10
    log_image_interval: int = 2000
    log_hist_interval: int = 5000
    val_interval: int = 1000
    val_fraction: float = 0.1
    val_max_views: int = 16
    val_seed: int = 42
    checkpoint_interval: int = 10000

    # --- observability (JSONL always written; wandb off unless asked) ---
    wandb_project: str = "3d-gaussian-splatting-tpu"
    wandb_entity: Optional[str] = None
    wandb_mode: str = "disabled"
    wandb_run_name: Optional[str] = None
    wandb_tags: Optional[List[str]] = None

    # --- eval (read by the eval CLI) ---
    eval_num_views: int = 12

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)
