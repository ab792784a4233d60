"""High-level render: gaussian params + camera -> image (counterpart of
``gaussian_splatting_tpu/ops/render.py``).

Render modes RGB / D / ED / RGB+D / RGB+ED, background color, active SH
degree, classic or antialiased opacity; returns the image, alpha, depth and
the per-gaussian meta (means2d, radii, visibility).

Backends:
- ``"ref"``  the pure-PyTorch oracle (``rasterize_ref``), any device.
- ``"cuda"`` binning + the hand-written CUDA kernels (``rasterize_cuda``);
  on CPU tensors the kernels' plain versions stand in.
- ``"auto"`` resolves to ``"cuda"``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gaussian_splatting_tpu_torch._device import DeviceLike, resolve_device
from gaussian_splatting_tpu_torch.core.activations import opacity_activation, scale_activation
from gaussian_splatting_tpu_torch.core.sh import sh_to_color
from gaussian_splatting_tpu_torch.ops.projection import project_gaussians
from gaussian_splatting_tpu_torch.ops.rasterize_ref import rasterize_reference

BACKENDS = ("auto", "ref", "cuda")


class RenderOut(NamedTuple):
    render: torch.Tensor      # (H, W, C): RGB, depth, or concat per render_mode
    alpha: torch.Tensor       # (H, W)
    depth: torch.Tensor       # (H, W) accumulated depth
    means2d: torch.Tensor     # (N, 2)
    radii: torch.Tensor       # (N,)
    visibility: torch.Tensor  # (N,) bool, radius > 0
    stats: Optional[dict] = None  # overflow counters (cuda backend only)


def resolve_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    return "cuda" if backend == "auto" else backend


def render(
    means,
    quats,
    log_scales,
    logit_opacities,
    sh_coeffs,
    viewmat,
    K,
    width: int,
    height: int,
    sh_degree: int = 3,
    bg=None,
    render_mode: str = "RGB",
    backend: str = "auto",
    tile_size: int = 16,
    max_tiles_per_gaussian: int = 16,
    raster_chunk: int = 256,
    class_budgets=None,
    depth_bits: int = 0,
    sort_buckets: int = 0,
    bucket_headroom: float = 1.5,
    sort_bands: int = 0,
    rasterize_mode: str = "classic",
    with_stats: bool = False,
    grad_buffer_frac: float = 1.0,
    reduce_slices: int = 0,
    depth_grad: bool = True,
    device: DeviceLike = None,
) -> RenderOut:
    """Render one view on ``device`` (CUDA unless given; inputs are moved
    there), differentiable with respect to the parameters and the view.
    Parameters are *raw* (log scales, logit opacities, unnormalized quats);
    sh_coeffs (N, K, 3) with K >= (sh_degree+1)^2.
    ``rasterize_mode="antialiased"`` multiplies opacity by the covariance
    compensation factor. ``grad_buffer_frac``, ``reduce_slices`` and
    ``depth_grad`` (cuda backend) size and shape the backward's gradient
    reduce; ``depth_grad=False`` promises that the depth output is never
    differentiated; ``sort_buckets`` and ``bucket_headroom`` bin through the
    bucket partition (see ``rasterize_cuda.rasterize_tiled``)."""
    backend = resolve_backend(backend)
    dev = resolve_device(device)

    def on_dev(x):  # tensors move; anything else is copied (numpy may be read-only)
        x = x if torch.is_tensor(x) else np.array(x, np.float32)
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    proj, colors, opac = project_and_shade(
        *(on_dev(x) for x in (means, quats, log_scales, logit_opacities, sh_coeffs,
                              viewmat, K)),
        width, height, sh_degree=sh_degree, rasterize_mode=rasterize_mode)

    bg = None if bg is None else on_dev(bg)
    stats = None
    if backend == "ref":
        out = rasterize_reference(
            proj.means2d, proj.conics, colors, opac, proj.depths,
            proj.radii, width, height, bg=bg, tile_size=tile_size)
        image, alpha_img, depth_img = out.image, out.alpha, out.depth
    else:
        from gaussian_splatting_tpu_torch.ops.rasterize_cuda import rasterize_tiled

        res = rasterize_tiled(
            proj.means2d, proj.conics, colors, opac, proj.depths, proj.radii,
            width, height, bg=bg, tile_size=tile_size, chunk=raster_chunk,
            max_tiles_per_gaussian=max_tiles_per_gaussian,
            class_budgets=class_budgets, depth_bits=depth_bits,
            sort_buckets=sort_buckets, bucket_headroom=bucket_headroom,
            sort_bands=sort_bands, with_stats=with_stats, grad_buffer_frac=grad_buffer_frac,
            reduce_slices=reduce_slices, depth_grad=depth_grad)
        if with_stats:
            image, alpha_img, depth_img, stats = res
        else:
            image, alpha_img, depth_img = res

    return RenderOut(
        render=compose_render_mode(render_mode, image, alpha_img, depth_img),
        alpha=alpha_img,
        depth=depth_img,
        means2d=proj.means2d,
        radii=proj.radii,
        visibility=proj.radii > 0,
        stats=stats,
    )


def project_and_shade(means, quats, log_scales, logit_opacities, sh_coeffs,
                      viewmat, K, width: int, height: int, sh_degree: int = 3,
                      rasterize_mode: str = "classic"):
    """The screen-space inputs of the rasterizer for one view: (Projected,
    colors (N, 3), opacities (N,)). Applies the activations, projects with
    opacity-aware radii (the pre-compensation opacity bounds the effective
    one, so the shrunken support stays exact), multiplies opacity by the
    compensation factor in antialiased mode and evaluates SH along the view
    directions from the camera center."""
    scales = scale_activation(log_scales)
    opac = opacity_activation(logit_opacities.reshape(-1))
    proj = project_gaussians(means, quats, scales, viewmat, K, width, height,
                             opacities=opac)
    if rasterize_mode == "antialiased":
        opac = opac * proj.compensations
    elif rasterize_mode != "classic":
        raise ValueError(f"unknown rasterize_mode {rasterize_mode!r}")
    R = viewmat[:3, :3]
    t = viewmat[:3, 3]
    cam_pos = -R.T @ t
    dirs = means - cam_pos[None, :]
    dirs = dirs / torch.clamp_min(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-12)
    return proj, sh_to_color(sh_degree, sh_coeffs, dirs), opac


def render_grad_meta(means, quats, log_scales, logit_opacities, sh_coeffs, viewmat, K,
                     width: int, height: int, sh_degree: int = 3, tile_size: int = 16,
                     max_tiles_per_gaussian: int = 16, raster_chunk: int = 256,
                     class_budgets=None, depth_bits: int = 0,
                     grad_buffer_frac: float = 1.0, sort_buckets: int = 0,
                     bucket_headroom: float = 1.5, sort_bands: int = 0,
                     rasterize_mode: str = "classic",
                     device: DeviceLike = None):
    """Exact gradient-stream occupancy ``(n_written, n_dropped, grad_cap)``
    of one view through the cuda backend: the probe that sizes
    ``grad_buffer_frac`` (``rasterize_cuda.rasterize_grad_meta``)."""
    from gaussian_splatting_tpu_torch.ops.rasterize_cuda import rasterize_grad_meta

    dev = resolve_device(device)

    def on_dev(x):
        x = x if torch.is_tensor(x) else np.array(x, np.float32)
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    with torch.no_grad():
        proj, colors, opac = project_and_shade(
            *(on_dev(x) for x in (means, quats, log_scales, logit_opacities, sh_coeffs,
                                  viewmat, K)),
            width, height, sh_degree=sh_degree, rasterize_mode=rasterize_mode)
    return rasterize_grad_meta(
        proj.means2d, proj.conics, colors, opac, proj.depths, proj.radii, width, height,
        tile_size=tile_size, chunk=raster_chunk,
        max_tiles_per_gaussian=max_tiles_per_gaussian, class_budgets=class_budgets,
        depth_bits=depth_bits, grad_buffer_frac=grad_buffer_frac,
        sort_buckets=sort_buckets, bucket_headroom=bucket_headroom, sort_bands=sort_bands)


def compose_render_mode(render_mode: str, image, alpha, depth) -> torch.Tensor:
    """The (H, W, C) output of a render mode: RGB, D (accumulated depth),
    ED (expected depth = depth / alpha), RGB+D or RGB+ED."""
    if render_mode == "RGB":
        return image
    if render_mode == "D":
        return depth[..., None]
    ed = depth / torch.clamp_min(alpha, 1e-10)
    if render_mode == "ED":
        return ed[..., None]
    if render_mode == "RGB+D":
        return torch.cat([image, depth[..., None]], dim=-1)
    if render_mode == "RGB+ED":
        return torch.cat([image, ed[..., None]], dim=-1)
    raise ValueError(f"unknown render_mode {render_mode!r}")
