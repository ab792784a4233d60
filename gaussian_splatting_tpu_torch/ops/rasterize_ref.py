"""Pure-PyTorch reference rasterizer: the correctness oracle and the
``"ref"`` render backend (counterpart of ``gaussian_splatting_tpu/ops/
rasterize_ref.py``).

Front-to-back alpha blending with alpha clamped at 0.999, the 1/255 alpha
gate and early termination at T <= 1e-4, vectorized: the transmittance
prefix product is ``exp(cumsum(log1p(-alpha)))`` over the globally
depth-sorted gaussians, and the termination mask ``T > 1e-4`` is monotone,
so masking reproduces a sequential break. Termination here is global: a
pixel stops for good. The tiled kernels carry transmittance per chunk
(``ops/rasterize_cuda.py``), which can differ from this oracle on pixels
that saturate mid-chunk. Differentiable through autograd; O(P*N) memory
per row block, meant for small scenes.
"""

from typing import NamedTuple, Optional

import torch

ALPHA_CLAMP = 0.999
ALPHA_SKIP = 1.0 / 255.0
T_EARLY_STOP = 1e-4


class RasterOut(NamedTuple):
    image: torch.Tensor  # (H, W, C) blended colors (+ T_final * bg)
    alpha: torch.Tensor  # (H, W) 1 - T_final
    depth: torch.Tensor  # (H, W) accumulated (w-weighted) depth


def _alpha_matrix(px, py, means2d, conics, opacities):
    """alpha for each (pixel, gaussian) pair: (P,) pixels x (N,) -> (P, N)."""
    dx = px[:, None] - means2d[None, :, 0]
    dy = py[:, None] - means2d[None, :, 1]
    A, B, C = conics[:, 0], conics[:, 1], conics[:, 2]
    sigma = 0.5 * (A[None, :] * dx * dx + C[None, :] * dy * dy) + B[None, :] * dx * dy
    alpha = torch.clamp_max(opacities[None, :] * torch.exp(-sigma), ALPHA_CLAMP)
    return torch.where((sigma < 0.0) | (alpha < ALPHA_SKIP),
                       torch.zeros_like(alpha), alpha)


def blend_weights(alpha: torch.Tensor, t_start: Optional[torch.Tensor] = None):
    """Front-to-back blend weights from depth-sorted alphas (P, K).
    Returns (w (P, K), T_final (P,)). An entry whose blend would push T to
    <= 1e-4 and every entry after it are excluded; the mask is discrete
    (no gradient through the stopping point)."""
    if t_start is None:
        t_start = torch.ones(alpha.shape[:-1], dtype=alpha.dtype, device=alpha.device)
    log1ma = torch.log1p(-alpha)
    S = torch.cumsum(log1ma, dim=-1)
    T_after = t_start[..., None] * torch.exp(S)
    T_before = t_start[..., None] * torch.exp(S - log1ma)
    mask = (T_after > T_EARLY_STOP).detach()
    w = alpha * T_before * mask
    T_final = t_start * torch.exp(
        torch.sum(torch.where(mask, log1ma, torch.zeros_like(log1ma)), dim=-1))
    return w, T_final


def rasterize_reference(
    means2d: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    width: int,
    height: int,
    bg: Optional[torch.Tensor] = None,
    tile_size: Optional[int] = None,
    pixel_chunk_rows: int = 32,
) -> RasterOut:
    """Rasterize N screen-space gaussians over the full image.

    With ``tile_size`` a gaussian reaches a pixel only when the pixel's tile
    intersects the gaussian's radius bounding box, as in tile binning;
    with ``tile_size=None`` every gaussian affects every pixel.
    """
    C = colors.shape[-1]
    dev = means2d.device
    if bg is None:
        bg = torch.zeros((C,), dtype=colors.dtype, device=dev)

    # Global front-to-back order; culled gaussians sink to the back with
    # alpha forced to zero.
    sort_depth = torch.where(radii > 0, depths, torch.full_like(depths, float("inf")))
    order = torch.argsort(sort_depth, stable=True)
    means_s = means2d[order]
    conics_s = conics[order]
    colors_s = colors[order]
    opac_s = torch.where(radii[order] > 0, opacities[order],
                         torch.zeros_like(opacities[order]))
    depth_s = depths[order]
    radii_s = radii[order]

    if tile_size is not None:
        ts = float(tile_size)
        r = radii_s.to(means_s.dtype)
        tx0 = torch.floor((means_s[:, 0] - r) / ts)
        tx1 = torch.ceil((means_s[:, 0] + r) / ts)
        ty0 = torch.floor((means_s[:, 1] - r) / ts)
        ty1 = torch.ceil((means_s[:, 1] + r) / ts)

    xs = torch.arange(width, dtype=torch.int32, device=dev)
    imgs, alphas, depth_rows = [], [], []
    for y0 in range(0, height, pixel_chunk_rows):
        ys = y0 + torch.arange(pixel_chunk_rows, dtype=torch.int32, device=dev)
        py = (ys.to(colors.dtype) + 0.5)[:, None].expand(-1, width).reshape(-1)
        px = (xs.to(colors.dtype) + 0.5)[None, :].expand(pixel_chunk_rows, -1).reshape(-1)
        alpha = _alpha_matrix(px, py, means_s, conics_s, opac_s)  # (P, N)
        if tile_size is not None:
            ptx = torch.floor(px / ts)
            pty = torch.floor(py / ts)
            in_tile = (
                (ptx[:, None] >= tx0[None, :])
                & (ptx[:, None] < tx1[None, :])
                & (pty[:, None] >= ty0[None, :])
                & (pty[:, None] < ty1[None, :])
            )
            alpha = torch.where(in_tile, alpha, torch.zeros_like(alpha))
        w, T_final = blend_weights(alpha)
        imgs.append(w @ colors_s + T_final[:, None] * bg[None, :])
        alphas.append(1.0 - T_final)
        depth_rows.append(w @ depth_s)
    pad_h = len(imgs) * pixel_chunk_rows
    image = torch.cat(imgs).reshape(pad_h, width, C)[:height]
    alpha_img = torch.cat(alphas).reshape(pad_h, width)[:height]
    depth_img = torch.cat(depth_rows).reshape(pad_h, width)[:height]
    return RasterOut(image=image, alpha=alpha_img, depth=depth_img)
