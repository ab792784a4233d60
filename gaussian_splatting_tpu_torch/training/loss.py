"""Losses (counterpart of ``gaussian_splatting_tpu/training/loss.py``): the
L1 + DSSIM photometric objective on a straight-through-clamped render, PSNR,
and the scale-anisotropy hinge regularizer; for surfels (2D Gaussian
Splatting, the port only) the normal-consistency and depth-distortion terms
(``surfel_terms``) and the published iterations they start at."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gaussian_splatting_tpu_torch.core.activations import scale_activation

# The published 2DGS schedule: the distortion term from iteration 3000, the
# normal term from 7000 (of the port's iteration counter, which starts at 0).
SURFEL_DIST_FROM = 3000
SURFEL_NORMAL_FROM = 7000


def stclamp(x: torch.Tensor) -> torch.Tensor:
    """Forward: clamp to [0, 1]; backward: identity (straight-through), so
    colors that drift out of range still receive corrective gradient."""
    return x + (torch.clamp(x, 0.0, 1.0) - x).detach()


def _avg_pool3(img: torch.Tensor) -> torch.Tensor:
    """3x3 average pool, stride 1, zero padding 1, divided by 9 everywhere
    (``count_include_pad=True``). img: (H, W, C)."""
    x = img.permute(2, 0, 1)[None]
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)[0].permute(1, 2, 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """The reference's SSIM variant with 3x3 average-pool local statistics.
    imgs: (H, W, C) in [0, 1]. Returns the scalar mean."""
    return ssim_map(img1, img2).mean()


def ssim_map(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """The (H, W, C) SSIM map of ``ssim``."""
    C1, C2 = 0.01**2, 0.03**2
    mu1 = _avg_pool3(img1)
    mu2 = _avg_pool3(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _avg_pool3(img1 * img1) - mu1_sq
    sigma2_sq = _avg_pool3(img2 * img2) - mu2_sq
    sigma12 = _avg_pool3(img1 * img2) - mu1_mu2
    return ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return torch.where(mse < 1e-10, torch.full_like(mse, 100.0),
                       -10.0 * torch.log10(torch.clamp_min(mse, 1e-10)))


def photometric_loss(rendered: torch.Tensor, gt: torch.Tensor, lambda_dssim: float,
                     dtype: str = "float32"):
    """(1 - lambda) L1 + lambda (1 - SSIM) on the straight-through-clamped
    render. Returns (loss, metrics dict of l1, ssim, psnr).

    ``dtype="bfloat16"`` runs the L1/SSIM image math in bfloat16 with
    float32 scalars; PSNR is a metric and always float32."""
    r = stclamp(rendered)
    if dtype == "bfloat16":
        rb = r.to(torch.bfloat16)
        gb = gt.to(torch.bfloat16)
        l1 = torch.mean(torch.abs(rb - gb).to(torch.float32))
        s = ssim(rb, gb).to(torch.float32)
    elif dtype == "float32":
        l1 = torch.mean(torch.abs(r - gt))
        s = ssim(r, gt)
    else:
        raise ValueError(f"unknown loss dtype {dtype!r}")
    loss = (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - s)
    return loss, {
        "l1": l1,
        "ssim": s,
        "psnr": psnr(torch.clamp(rendered.detach().to(torch.float32), 0.0, 1.0),
                     gt.to(torch.float32)),
    }


def scale_ratio_reg(log_scales: torch.Tensor, alive: torch.Tensor, max_ratio: float,
                    weight: float, n_alive=None) -> torch.Tensor:
    """Anisotropy hinge: penalize a max/min scale ratio above ``max_ratio``,
    averaged over the alive gaussians. ``n_alive`` replaces the count of
    ``alive`` as the divisor: on a shard of the gaussians, the global count
    makes the shards' values add up to the global mean."""
    scales = scale_activation(log_scales)
    ratio = scales.amax(-1) / torch.clamp_min(scales.amin(-1), 1e-8)
    hinge = torch.clamp_min(ratio, max_ratio) - max_ratio
    alive_f = alive.to(log_scales.dtype)
    n = alive_f.sum() if n_alive is None else n_alive
    return weight * (hinge * alive_f).sum() / torch.clamp_min(n, 1.0)


def depth_to_normal(viewmat: torch.Tensor, K: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) world-space normals of a (H, W) depth map (2DGS's
    ``depth_to_normal``): each pixel centre's ray ((x + 0.5 - cx) / fx, (y +
    0.5 - cy) / fy, 1) (K^-1 of the port's zero-skew intrinsics, without a
    matrix inverse, which would wait for the device) times its depth, to the
    world; central differences down the rows and along the columns; their
    cross product normalized; zero on the border."""
    H, W = depth.shape
    dev = depth.device
    xs = (torch.arange(W, device=dev, dtype=torch.float32) + 0.5 - K[0, 2]) / K[0, 0]
    ys = (torch.arange(H, device=dev, dtype=torch.float32) + 0.5 - K[1, 2]) / K[1, 1]
    cam = torch.stack([depth * xs[None, :], depth * ys[:, None], depth], dim=-1)
    pts = (cam - viewmat[:3, 3]) @ viewmat[:3, :3]
    dx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dy = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = F.normalize(torch.cross(dx, dy, dim=-1), dim=-1)
    return F.pad(n.permute(2, 0, 1), (1, 1, 1, 1)).permute(1, 2, 0)


def surfel_terms(maps: torch.Tensor, viewmat: torch.Tensor, K: torch.Tensor,
                 depth_ratio: float = 0.0, median: torch.Tensor = None):
    """(normal consistency, distortion) of one surfel view. ``maps`` (H, W,
    6) holds the view-space normal sum (3), the expected depth sum, the
    alpha and the distortion. The normal term is mean(1 - n . N_s): n the
    rendered normal in world space, N_s the normal of the surface depth
    (expected depth / alpha, blended with ``median`` at ``depth_ratio`` >
    0) times the detached alpha. The distortion term is the map's mean."""
    normal, depth, alpha, dist = maps[..., :3], maps[..., 3], maps[..., 4], maps[..., 5]
    surf = depth / torch.clamp_min(alpha, 1e-10)
    if depth_ratio != 0.0:
        surf = (1.0 - depth_ratio) * surf + depth_ratio * median
    ns = depth_to_normal(viewmat, K, surf) * alpha.detach()[..., None]
    n_world = normal @ viewmat[:3, :3]
    return (1.0 - (n_world * ns).sum(-1)).mean(), dist.mean()
