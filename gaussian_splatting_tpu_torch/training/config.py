"""Training configuration: the port's own copy of the part of
``gaussian_splatting_tpu/training/config.py`` that the port reads, with the
same field names and defaults, so a configuration means the same in both
packages. Every field here is read by ``make_train_step`` (or the optimizer
it calls); fields of the trainer, densification, validation, meshes and
logging come with the slices that read them. The binning modes the port has
not ported yet (compact ``class_budgets``, ``sort_depth_bits``,
``sort_bands``) raise ``NotImplementedError`` where a render reads them. ``backend`` takes the port's names: ``auto`` (=
``cuda``), ``cuda`` or ``ref``."""

import dataclasses
from typing import Optional


@dataclasses.dataclass
class TrainingConfig:
    # --- scale regularizer and ceiling (reference :42-44) ---
    scale_clamp_ratio: float = 0.2
    scale_reg_max_ratio: float = 10.0
    scale_reg_weight: float = 0.1

    # --- optimization (reference :54-60 and trainer.py:331-340) ---
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

    # --- losses (reference :73) ---
    lambda_dssim: float = 0.2
    # "bfloat16" runs the L1/SSIM image math in bf16 with f32 scalars.
    loss_dtype: str = "float32"

    # --- rasterizer execution ---
    tile_size: int = 16
    raster_chunk: int = 256
    # Static cap on tiles covered per gaussian (overflow is counted).
    max_tiles_per_gaussian: int = 16
    # Not ported yet; nonzero raises NotImplementedError.
    sort_depth_bits: int = 0
    # B > 0 (a power of two): binning through the bucket partition by
    # tile % B, each 512-slot chunk given partition_headroom times its
    # balanced share per bucket; overflow is counted in n_budget_dropped.
    sort_buckets: int = 0
    partition_headroom: float = 1.5
    # Not ported yet; nonzero / not None raises NotImplementedError.
    sort_bands: int = 0
    class_budgets: Optional[tuple] = None
    # >1: the gradient reduce sorts K static slices separately and adds the
    # per-slice segment sums.
    reduce_slices: int = 0
    # Gradient-buffer capacity as a fraction of the exact bound (the slot
    # count). 1.0 can never drop; below 1, overflow is dropped and counted.
    grad_buffer_frac: float = 1.0
    backend: str = "auto"              # auto | cuda | ref
    # "antialiased" multiplies opacity by the covariance compensation factor.
    rasterize_mode: str = "classic"    # classic | antialiased

    # --- camera pose refinement (per-train-view se(3) delta) ---
    optimize_poses: bool = False
    pose_lr_init: float = 1e-3
    pose_lr_final: float = 1e-5
    pose_start_iter: int = 0

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)
