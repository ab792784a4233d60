"""High-level render: gaussian params + camera -> image (counterpart of
``gaussian_splatting_tpu/ops/render.py``).

Render modes RGB / D / ED / RGB+D / RGB+ED, background color, active SH
degree, classic or antialiased opacity; returns the image, alpha, depth and
the per-gaussian meta (means2d, radii, visibility).

Backends:
- ``"ref"``  the pure-PyTorch oracle (``rasterize_ref``), any device.
- ``"cuda"`` binning + the hand-written CUDA kernels (``rasterize_cuda``);
  on CPU tensors the kernels' plain versions stand in.
- ``"auto"`` resolves to ``"cuda"``; it is ``render``'s default, where the
  JAX package's is ``"ref"``, so that a bare ``render()`` of CUDA tensors
  runs the kernels (``tests/test_torch_coverage.py`` records the
  difference).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gaussian_splatting_tpu_torch._device import DeviceLike, resolve_device
from gaussian_splatting_tpu_torch.ops.project_sh import project_shade, project_shade_plain
from gaussian_splatting_tpu_torch.ops.rasterize_ref import rasterize_reference
from gaussian_splatting_tpu_torch.utils import profiling

BACKENDS = ("auto", "ref", "cuda")
SURFELS_POSE = (
    "surfels with pose refinement: the surfel projection pair takes no gradient of the "
    "view yet (its backward would also need dT/dW and dc/dt); refine poses on a 3D "
    "gaussian scene")


class RenderOut(NamedTuple):
    render: torch.Tensor      # (H, W, C): RGB, depth, or concat per render_mode
    alpha: torch.Tensor       # (H, W)
    depth: torch.Tensor       # (H, W) accumulated depth
    means2d: torch.Tensor     # (N, 2)
    radii: torch.Tensor       # (N,)
    visibility: torch.Tensor  # (N,) bool, radius > 0
    stats: Optional[dict] = None  # overflow counters (cuda backend only)
    # Surfels (2D Gaussian Splatting, ``ops/surfel.py``) only: the (H, W, 3)
    # view-space normal sum w n, the (H, W) median depth (no gradient) and
    # the (H, W) depth distortion; and the (H, W, 12) map buffer they are
    # views of (``ops/surfel.py``'s rows), which ``training/loss.py::
    # surfel_terms`` reads where it lies.
    normal: Optional[torch.Tensor] = None
    median_depth: Optional[torch.Tensor] = None
    distortion: Optional[torch.Tensor] = None
    maps: Optional[torch.Tensor] = None


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
    offsets=None,
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
    bucket partition (see ``rasterize_cuda.rasterize_tiled``). ``offsets``
    ``(dx, dr, ds)``, tensors on ``device``, deform the gaussians after the
    activations (``project_and_shade``).

    Parameters with two log-scales a row are surfels (2D Gaussian
    Splatting): ``render_surfels`` renders them, and the output also holds
    the normal, median depth and distortion maps."""
    backend = resolve_backend(backend)
    dev = resolve_device(device)

    def on_dev(x):  # tensors move; anything else is copied (numpy may be read-only)
        x = x if torch.is_tensor(x) else np.array(x, np.float32)
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    if np.shape(log_scales)[-1] == 2:
        if offsets is not None or rasterize_mode != "classic":
            raise NotImplementedError(
                "surfels render in the classic mode without deformation offsets")
        return render_surfels(
            *(on_dev(x) for x in (means, quats, log_scales, logit_opacities, sh_coeffs,
                                  viewmat, K)),
            width, height, sh_degree=sh_degree, bg=None if bg is None else on_dev(bg),
            render_mode=render_mode, backend=backend, tile_size=tile_size,
            max_tiles_per_gaussian=max_tiles_per_gaussian, raster_chunk=raster_chunk,
            class_budgets=class_budgets, depth_bits=depth_bits, sort_buckets=sort_buckets,
            bucket_headroom=bucket_headroom, sort_bands=sort_bands, with_stats=with_stats,
            grad_buffer_frac=grad_buffer_frac, reduce_slices=reduce_slices)

    proj, colors, opac = project_and_shade(
        *(on_dev(x) for x in (means, quats, log_scales, logit_opacities, sh_coeffs,
                              viewmat, K)),
        width, height, sh_degree=sh_degree, rasterize_mode=rasterize_mode, offsets=offsets)

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


def render_surfels(means, quats, log_scales, logit_opacities, sh_coeffs, viewmat, K,
                   width: int, height: int, sh_degree: int = 3, bg=None,
                   render_mode: str = "RGB", backend: str = "cuda", tile_size: int = 16,
                   max_tiles_per_gaussian: int = 16, raster_chunk: int = 256,
                   class_budgets=None, depth_bits: int = 0, sort_buckets: int = 0,
                   bucket_headroom: float = 1.5, sort_bands: int = 0,
                   with_stats: bool = False, grad_buffer_frac: float = 1.0,
                   reduce_slices: int = 0) -> RenderOut:
    """One view of surfels (tensors on one device, log_scales (N, 2)):
    ``ops/surfel.py``'s projection pair (span ``render.project_sh`` and its
    backward ``render.project_sh.bwd``) and its binning and raster kernels
    on the ``cuda`` backend, ``models/surfel_ref.py`` on ``ref``. ``means2d``
    of the output is the projected centres."""
    from gaussian_splatting_tpu_torch.ops.surfel import project_surfels, rasterize_surfels

    if torch.is_grad_enabled() and (viewmat.requires_grad or K.requires_grad):
        raise NotImplementedError(SURFELS_POSE)
    if resolve_backend(backend) == "ref":
        from gaussian_splatting_tpu_torch.models import surfel_ref

        p = surfel_ref.project(means, quats, log_scales, logit_opacities, sh_coeffs, viewmat,
                               K, width, height, sh_degree)
        img = surfel_ref.blend(p, width, height, tile_size, raster_chunk)
        centers, radii, stats = p.centers, p.radii, None
        if bg is not None:
            img = torch.cat([img[..., :3] + (1.0 - img[..., 4])[..., None] * bg, img[..., 3:]],
                            dim=-1)
    else:
        with profiling.annotate("render.project_sh"):
            mark = profiling.grad_span("render.project_sh.bwd")
            p = project_surfels(means, quats, mark.input(log_scales), logit_opacities.reshape(-1),
                                sh_coeffs, viewmat, K, width, height, sh_degree)
            centers, tmat, normals, colors, opac = mark.outputs(
                p.centers, p.tmat, p.normals, p.colors, p.opac)
            p = p._replace(centers=centers, tmat=tmat, normals=normals, colors=colors, opac=opac)
        img, stats = rasterize_surfels(
            p, width, height, bg=bg, tile_size=tile_size, chunk=raster_chunk,
            max_tiles_per_gaussian=max_tiles_per_gaussian, class_budgets=class_budgets,
            depth_bits=depth_bits, sort_buckets=sort_buckets, sort_bands=sort_bands,
            grad_buffer_frac=grad_buffer_frac, reduce_slices=reduce_slices,
            bucket_headroom=bucket_headroom)
        centers, radii = p.centers, p.radii
    rgb, depth, alpha = img[..., :3], img[..., 3], img[..., 4]
    return RenderOut(
        render=compose_render_mode(render_mode, rgb, alpha, depth), alpha=alpha, depth=depth,
        means2d=centers, radii=radii, visibility=radii > 0,
        stats=stats if with_stats else None, normal=img[..., 5:8], median_depth=img[..., 9],
        distortion=img[..., 8], maps=img)


def project_and_shade(means, quats, log_scales, logit_opacities, sh_coeffs,
                      viewmat, K, width: int, height: int, sh_degree: int = 3,
                      rasterize_mode: str = "classic", offsets=None):
    """The screen-space inputs of the rasterizer for one view: (Projected,
    colors (N, 3), opacities (N,)). Applies the activations, projects with
    opacity-aware radii (the pre-compensation opacity bounds the effective
    one, so the shrunken support stays exact), multiplies opacity by the
    compensation factor in antialiased mode and evaluates SH along the view
    directions from the camera center. Runs ``ops/project_sh.py``'s
    Function (the CUDA kernel pair, or its plain version on the CPU); where
    the view itself needs a gradient (pose refinement) it runs the plain
    code under autograd instead and counts ``project_sh.autograd``.
    ``offsets`` ``(dx, dr, ds)`` (Deformable 3D Gaussians) move the means,
    scales and rotations after the activations (``ops/project_sh.py``).
    Spans ``render.project_sh`` and, for its backward,
    ``render.project_sh.bwd``."""
    with profiling.annotate("render.project_sh"):
        mark = profiling.grad_span("render.project_sh.bwd")
        args = (means, quats, mark.input(log_scales), logit_opacities.reshape(-1), sh_coeffs,
                viewmat, K, width, height, sh_degree, rasterize_mode, offsets)
        if torch.is_grad_enabled() and (viewmat.requires_grad or K.requires_grad):
            profiling.count("project_sh.autograd")
            proj, colors, opac = project_shade_plain(*args)
        else:
            proj, colors, opac = project_shade(*args)
        means2d, depths, conics, comps, colors, opac = mark.outputs(
            proj.means2d, proj.depths, proj.conics, proj.compensations, colors, opac)
        proj = proj._replace(means2d=means2d, depths=depths, conics=conics,
                             compensations=comps)
    return proj, colors, opac


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
