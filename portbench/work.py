"""Operation and byte counts of the work a cell's inputs need, and the
peaks of the chip they are held against.

Counts follow the inputs, never a buffer the program sized itself: the
intersections and the (pixel, entry) pairs that carry a weight come from the
reference's binning and blend of the cell's own views, each input byte is
read once and each output byte written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense): float32 outside the tensor cores and
# HBM3 bandwidth, at the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12

# float32 operations per (pixel, entry) pair that carries a weight, in the
# blend forward: dx, dy (2); sigma (9); exp and its negation (2); op * vis
# (1); two gate compares and the clamp (3); 1 - alpha, the running product
# and T_carry * product (3); the stop compare (1); the weight (2); three
# colour multiply-adds, the depth multiply-add and the weight sum (9).
FWD_FLOPS_PER_PAIR = 32
# The backward recomputes the forward's alpha and transmittance (23) and
# then: T_before and w (2); gw, four multiply-adds (8); the prefix (2);
# d_alpha (5); the clamp gate and d_sigma (3); d mean x, y (10); d conic
# (8); d opacity (1); d colour, d depth (4); the sums over pixels (10).
BWD_FLOPS_PER_PAIR = 23 + 53
# Bytes of one intersection's record the forward reads (mean 2, conic 3,
# opacity, colour 3, depth) and the backward reads (the same and the id)
# and writes (the id and ten gradients).
FWD_ENTRY_BYTES = 10 * 4
BWD_ENTRY_BYTES = 11 * 4 + 11 * 4
# Per tile: the segment's start and count.
TILE_BYTES = 2 * 4
# Per pixel: the forward writes r, g, b, depth and the weight sum; the
# backward reads their cotangents and the forward's values.
FWD_PIXEL_BYTES = 5 * 4
BWD_PIXEL_BYTES = 10 * 4

# Projection and SH per gaussian and view, forward: world to camera (18),
# the rotation from the quaternion (31), the 3D covariance (48), the camera
# covariance (90), the clamped Jacobian (14), the 2D covariance and eps
# (26), the conic (6), the radius (12), the pixel mean (6), the activations
# (5), the view direction (12); SH colour: degree 0 (3), 1 (+15), 2 (+41),
# 3 (+77), the offset and clamp (6). The backward counts twice the forward.
PROJ_FLOPS = 268
SH_FLOPS = {0: 9, 1: 24, 2: 65, 3: 142}
# Loss per pixel and channel: L1 (3) and the 3x3-pool SSIM (five pools of
# 9 adds and a scale, and 20 more), forward; the backward counts twice.
LOSS_FLOPS_PER_CHANNEL = 3 + 5 * 10 + 20
# Adam per parameter: both moments (7), the bias corrections (2), sqrt,
# eps, the divide, the rate and the update (5).
ADAM_FLOPS = 14
PARAMS_PER_GAUSSIAN = 3 + 4 + 3 + 1 + 3 + 45


def raster_fwd(n_isect: float, pairs: float, pixels: float, tiles: float):
    """(operations, bytes) of one view's forward blend."""
    return (FWD_FLOPS_PER_PAIR * pairs,
            FWD_ENTRY_BYTES * n_isect + TILE_BYTES * tiles + FWD_PIXEL_BYTES * pixels)


def raster_bwd(n_isect: float, pairs: float, pixels: float, tiles: float):
    """(operations, bytes) of one view's backward blend."""
    return (BWD_FLOPS_PER_PAIR * pairs,
            BWD_ENTRY_BYTES * n_isect + TILE_BYTES * tiles + BWD_PIXEL_BYTES * pixels)


def projection_sh(n_gaussians: float, sh_degree: int, train: bool) -> float:
    f = (PROJ_FLOPS + SH_FLOPS[sh_degree]) * n_gaussians
    return 3 * f if train else f


def loss(pixels: float) -> float:
    """Forward and backward of the photometric loss over ``pixels`` RGB
    pixels."""
    return 3 * LOSS_FLOPS_PER_CHANNEL * 3 * pixels


def adam(n_gaussians: float) -> float:
    return ADAM_FLOPS * PARAMS_PER_GAUSSIAN * n_gaussians


def roofline_share(ops: float, nbytes: float, seconds: float):
    """The least time the chip could take, the larger of ops / peak flop/s
    and bytes / peak bandwidth, over ``seconds``, in percent; None without a
    time."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S) / seconds


def train_step_flops(view: dict, n_gaussians: float, batch: int, sh_degree: int) -> float:
    """Floating-point work of one training step of ``batch`` views, each
    with the per-view counts ``view`` (pairs, pixels)."""
    per_view = (projection_sh(n_gaussians, sh_degree, True)
                + (FWD_FLOPS_PER_PAIR + BWD_FLOPS_PER_PAIR) * view["pairs"]
                + loss(view["pixels"]))
    return batch * per_view + adam(n_gaussians)


def render_frame_flops(view: dict, n_gaussians: float, sh_degree: int) -> float:
    return projection_sh(n_gaussians, sh_degree, False) + FWD_FLOPS_PER_PAIR * view["pairs"]
