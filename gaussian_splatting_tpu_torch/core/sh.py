"""Real spherical harmonics, degrees 0..3 (counterpart of
``gaussian_splatting_tpu/core/sh.py``).

The decoded color is ``max(SH(view_dir, coeffs) + 0.5, 0)``; coefficients
are laid out ``(N, K, 3)`` with ``K = (degree+1)^2`` bases.
"""

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def sh_bases(degree: int, dirs: torch.Tensor) -> list:
    """The real SH bases up to ``degree`` at unit directions ``dirs`` (..., 3),
    in the order of the coefficient rows: basis 0 is the constant ``SH_C0``,
    the others (..., 1) tensors."""
    bases = [SH_C0]
    if degree >= 1:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        bases += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
        if degree >= 2:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            bases += [
                SH_C2[0] * xy,
                SH_C2[1] * yz,
                SH_C2[2] * (2.0 * zz - xx - yy),
                SH_C2[3] * xz,
                SH_C2[4] * (xx - yy),
            ]
            if degree >= 3:
                bases += [
                    SH_C3[0] * y * (3.0 * xx - yy),
                    SH_C3[1] * xy * z,
                    SH_C3[2] * y * (4.0 * zz - xx - yy),
                    SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                    SH_C3[4] * x * (4.0 * zz - xx - yy),
                    SH_C3[5] * z * (xx - yy),
                    SH_C3[6] * x * (xx - 3.0 * yy),
                ]
    return bases


def eval_sh(degree: int, coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate SH at unit directions.

    degree: the *active* degree in [0, 3]; coefficients beyond it are ignored.
    coeffs: (..., K, 3) with K >= (degree+1)^2.
    dirs:   (..., 3) unit vectors (world-frame view directions).
    Returns (..., 3) raw SH colors (no +0.5 shift).
    """
    bases = sh_bases(degree, dirs)
    result = bases[0] * coeffs[..., 0, :]
    for k in range(1, len(bases)):
        result = result + bases[k] * coeffs[..., k, :]
    return result


def sh_to_color(degree: int, coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH -> clamped RGB in [0, inf): max(SH + 0.5, 0)."""
    return torch.clamp_min(eval_sh(degree, coeffs, dirs) + 0.5, 0.0)


def rgb_to_sh0(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0,1] -> DC SH coefficient."""
    return (rgb - 0.5) / SH_C0


def sh0_to_rgb(sh0: torch.Tensor) -> torch.Tensor:
    return sh0 * SH_C0 + 0.5
