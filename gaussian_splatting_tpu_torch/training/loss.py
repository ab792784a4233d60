"""Losses (counterpart of ``gaussian_splatting_tpu/training/loss.py``): the
L1 + DSSIM photometric objective on a straight-through-clamped render, PSNR,
and the scale-anisotropy hinge regularizer."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gaussian_splatting_tpu_torch.core.activations import scale_activation


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
    C1, C2 = 0.01**2, 0.03**2
    mu1 = _avg_pool3(img1)
    mu2 = _avg_pool3(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _avg_pool3(img1 * img1) - mu1_sq
    sigma2_sq = _avg_pool3(img2 * img2) - mu2_sq
    sigma12 = _avg_pool3(img1 * img2) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ssim_map.mean()


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
                    weight: float) -> torch.Tensor:
    """Anisotropy hinge: penalize a max/min scale ratio above ``max_ratio``,
    averaged over the alive gaussians."""
    scales = scale_activation(log_scales)
    ratio = scales.amax(-1) / torch.clamp_min(scales.amin(-1), 1e-8)
    hinge = torch.clamp_min(ratio, max_ratio) - max_ratio
    alive_f = alive.to(log_scales.dtype)
    return weight * (hinge * alive_f).sum() / torch.clamp_min(alive_f.sum(), 1.0)
