"""Operation and byte counts of 2D Gaussian Splatting's kernels and step, a
view or a step, from the cell's inputs: the intersections and the pairs
that carry a weight come from the surfel reference's binning and blend of
the cell's own views (``reference/surfel.py``), the surfels from the
checkpoint's alive rows. Each input byte is read once and each output byte
written once; the peaks are ``work.py``'s.
"""

from __future__ import annotations

from portbench import work

# float32 operations per (pixel, entry) pair that carries a weight, forward:
# the intersection, dx, dy (2), k and l (8), k x l (9), u and v (2), rho3
# (3), rho2 (4), the minimum and its selects (2), exp and its scale (2), o
# e^.. (1), the depth (4), the three gates (3), the clamp (1); the blend: 1
# - alpha, the running product and the stop test (4), T_before and w (3), m
# (3), the distortion (7), colour, normal and depth multiply-adds (14), the
# alpha, M1 and M2 sums (5), the median test (1).
FWD_FLOPS_PER_PAIR = 78
# The backward recomputes the forward's intersection and transmittance (45)
# and then: T_before and w (2), m and the distortion's weight term (9), gw
# (17), the prefix (2), d_alpha (5), the gate and d_rho (4), d depth (9), du,
# dv (8), d(k x l) (7), dk and dl (18), dT_w (12), dc (14), the signs (6), d
# opacity (2), d colour and d normal (6), the sums over pixels (16).
BWD_FLOPS_PER_PAIR = 45 + 137
# Bytes an entry: the forward reads its two records' 19 floats (centre 2,
# T 7, opacity; colour 3, normal 3, the binning conic 3); the backward reads
# those and the id and writes two stream columns of 11 and 7 floats.
FWD_ENTRY_BYTES = 19 * 4
BWD_ENTRY_BYTES = 20 * 4 + 18 * 4
TILE_BYTES = 2 * 4
# Bytes a pixel: the forward writes 12 rows; the backward reads 9
# cotangents and the forward's alpha, M1 and M2.
FWD_PIXEL_BYTES = 12 * 4
BWD_PIXEL_BYTES = 12 * 4

# The projection a surfel, forward: world to camera (18), the rotation (31),
# W t_u, W t_v, W t_w (45), the scales (6), the centre's division and T (16),
# c (4), the camera-facing turn (8), the binning ellipse (62), the opacity
# (4), the view direction (12); SH as work.SH_FLOPS. The backward counts
# twice the forward.
PROJ_FLOPS = 206
# Bytes a surfel: the forward reads mean 3, quaternion 4, scales 2, logit
# and (degree + 1)^2 x 3 SH floats and writes 21 floats; the backward reads
# the same inputs and 16 cotangents and writes the inputs' gradients.
PROJ_IN_FLOATS = 10
PROJ_OUT_FLOATS = 21
PROJ_COT_FLOATS = 16
# The regularizers a pixel: the surface depth (2), the ray and the world
# point (21), central differences (6), the cross product (9), normalize
# (9), the alpha product (3), the rendered normal to the world (15), the dot
# and 1 - (6), the means (2); their backward counts twice.
REG_FLOPS_PER_PIXEL = 73
# Adam a surfel's parameters: 3 + 4 + 2 + 1 + 48.
PARAMS_PER_SURFEL = 3 + 4 + 2 + 1 + 45 + 3


def raster_fwd(n_isect: float, pairs: float, pixels: float, tiles: float):
    """(operations, bytes) of one view's surfel forward blend."""
    return (FWD_FLOPS_PER_PAIR * pairs,
            FWD_ENTRY_BYTES * n_isect + TILE_BYTES * tiles + FWD_PIXEL_BYTES * pixels)


def raster_bwd(n_isect: float, pairs: float, pixels: float, tiles: float):
    """(operations, bytes) of one view's surfel backward blend."""
    return (BWD_FLOPS_PER_PAIR * pairs,
            BWD_ENTRY_BYTES * n_isect + TILE_BYTES * tiles + BWD_PIXEL_BYTES * pixels)


def projection(n_surfels: float, sh_degree: int):
    """(operations, bytes) of one view's surfel projection pair, forward
    and backward."""
    sh = 3 * (sh_degree + 1) ** 2
    f = (PROJ_FLOPS + work.SH_FLOPS[sh_degree]) * n_surfels
    nbytes = 4 * n_surfels * ((PROJ_IN_FLOATS + sh + PROJ_OUT_FLOATS)
                              + (PROJ_IN_FLOATS + sh + PROJ_COT_FLOATS + PROJ_IN_FLOATS + sh))
    return 3 * f, nbytes


def regularizers(pixels: float) -> float:
    """Forward and backward of the normal and distortion terms."""
    return 3 * REG_FLOPS_PER_PIXEL * pixels


def train_step_flops(view: dict, n_surfels: float, batch: int, sh_degree: int) -> float:
    """Floating-point work of one surfel training step of ``batch`` views,
    each with the per-view counts ``view`` (pairs, pixels)."""
    per_view = (projection(n_surfels, sh_degree)[0]
                + (FWD_FLOPS_PER_PAIR + BWD_FLOPS_PER_PAIR) * view["pairs"]
                + work.loss(view["pixels"]) + regularizers(view["pixels"]))
    return batch * per_view + work.ADAM_FLOPS * PARAMS_PER_SURFEL * n_surfels
