"""Losses (counterpart of ``gaussian_splatting_tpu/training/loss.py``): the
L1 + DSSIM photometric objective on a straight-through-clamped render, PSNR,
and the scale-anisotropy hinge regularizer; for surfels (2D Gaussian
Splatting, the port only) the normal-consistency and depth-distortion terms
(``surfel_terms``: the kernel pair of ``csrc/surfel_terms.cu`` on CUDA
tensors, ``surfel_terms_plain`` and its hand-derived backward on CPU
tensors) and the published iterations they start at."""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gaussian_splatting_tpu_torch.core.activations import scale_activation
from gaussian_splatting_tpu_torch.ops import _build
from gaussian_splatting_tpu_torch.ops.surfel import (
    OUT_ROWS,
    ROW_ALPHA,
    ROW_DEPTH,
    ROW_DIST,
    ROW_MEDIAN,
    ROW_NORMAL,
)
from gaussian_splatting_tpu_torch.utils import profiling

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


def _pixel_rays(K: torch.Tensor, H: int, W: int, dev):
    """The x of each column's and the y of each row's pixel-centre ray
    ((x + 0.5 - cx) / fx, (y + 0.5 - cy) / fy, 1): K^-1 of the port's
    zero-skew intrinsics, without a matrix inverse, which would wait for the
    device."""
    xs = (torch.arange(W, device=dev, dtype=torch.float32) + 0.5 - K[0, 2]) / K[0, 0]
    ys = (torch.arange(H, device=dev, dtype=torch.float32) + 0.5 - K[1, 2]) / K[1, 1]
    return xs, ys


def _world_points(viewmat: torch.Tensor, K: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) world points of a (H, W) depth map along the pixel rays."""
    xs, ys = _pixel_rays(K, *depth.shape, depth.device)
    cam = torch.stack([depth * xs[None, :], depth * ys[:, None], depth], dim=-1)
    return (cam - viewmat[:3, 3]) @ viewmat[:3, :3]


def _stencil(pts: torch.Tensor):
    """The central differences of the interior pixels: down the rows (dx) and
    along the columns (dy)."""
    return pts[2:, 1:-1] - pts[:-2, 1:-1], pts[1:-1, 2:] - pts[1:-1, :-2]


def depth_to_normal(viewmat: torch.Tensor, K: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) world-space normals of a (H, W) depth map (2DGS's
    ``depth_to_normal``): each pixel's world point (``_world_points``);
    central differences down the rows and along the columns; their cross
    product normalized; zero on the border."""
    dx, dy = _stencil(_world_points(viewmat, K, depth))
    n = F.normalize(torch.cross(dx, dy, dim=-1), dim=-1)
    return F.pad(n.permute(2, 0, 1), (1, 1, 1, 1)).permute(1, 2, 0)


def _surface_depth(depth, alpha, depth_ratio: float, median):
    surf = depth / torch.clamp_min(alpha, 1e-10)
    if depth_ratio != 0.0:
        surf = (1.0 - depth_ratio) * surf + depth_ratio * median
    return surf


def surfel_terms_plain(maps: torch.Tensor, viewmat: torch.Tensor, K: torch.Tensor,
                       depth_ratio: float = 0.0, median: torch.Tensor = None):
    """(normal consistency, distortion) of one surfel view, in plain PyTorch
    (differentiable by autograd). ``maps`` (H, W, 6) holds the view-space
    normal sum (3), the expected depth sum, the alpha and the distortion.
    The normal term is mean(1 - n . N_s): n the rendered normal in world
    space, N_s the normal of the surface depth (expected depth / alpha,
    blended with ``median`` at ``depth_ratio`` > 0) times the detached
    alpha. The distortion term is the map's mean."""
    normal, depth, alpha, dist = maps[..., :3], maps[..., 3], maps[..., 4], maps[..., 5]
    surf = _surface_depth(depth, alpha, depth_ratio, median)
    ns = depth_to_normal(viewmat, K, surf) * alpha.detach()[..., None]
    n_world = normal @ viewmat[:3, :3]
    return (1.0 - (n_world * ns).sum(-1)).mean(), dist.mean()


def surfel_terms_bwd_plain(maps: torch.Tensor, viewmat: torch.Tensor, K: torch.Tensor,
                           depth_ratio: float, median, g_normal, g_dist) -> torch.Tensor:
    """The gradient of ``maps`` (H, W, 6) through ``surfel_terms_plain``,
    given the two means' cotangents ``g_normal`` and ``g_dist`` (0-dim
    tensors, None for zero), derived by hand as ``csrc/surfel_terms.cu``'s
    backward computes it: the rendered normal's and the distortion's
    gradients pixel by pixel; the surface depth's through the stencil's
    adjoint, each pixel gathering the cross products' adjoints of its four
    neighbours; the depth's and (where alpha >= 1e-10, the floor's backward)
    the alpha's through the division. The median takes none."""
    normal, depth, alpha = maps[..., :3], maps[..., 3], maps[..., 4]
    H, W = depth.shape
    R = viewmat[:3, :3]
    zero = torch.zeros((), dtype=maps.dtype, device=maps.device)
    s = -(g_normal / (H * W)) if g_normal is not None else zero
    g_d = g_dist / (H * W) if g_dist is not None else zero
    ca = torch.clamp_min(alpha, 1e-10)
    surf = _surface_depth(depth, alpha, depth_ratio, median)
    dx, dy = _stencil(_world_points(viewmat, K, surf))
    c = torch.cross(dx, dy, dim=-1)
    nrm = torch.linalg.vector_norm(c, dim=-1, keepdim=True)
    den = torch.clamp_min(nrm, 1e-12)
    n = c / den
    nw = normal @ R
    ns = F.pad(n.permute(2, 0, 1), (1, 1, 1, 1)).permute(1, 2, 0) * alpha[..., None]
    d_normal = (s * ns) @ R.T
    # normalize's backward: the division's two operands, the floor, the norm.
    dn = (s * nw[1:-1, 1:-1]) * alpha[1:-1, 1:-1, None]
    dden = (-dn * (n / den)).sum(-1, keepdim=True)
    dc = dn / den + c * torch.where(nrm >= 1e-12, dden / nrm, zero)
    gdx = torch.cross(dy, dc, dim=-1)
    gdy = torch.cross(dc, dx, dim=-1)
    # The world points' gradient: each enters dx of the pixel above with +,
    # of the pixel below with -, dy of the pixel left with +, right with -
    # (summed, as autograd sums them, from the last slice to the first).
    g_pts = torch.zeros((H, W, 3), dtype=maps.dtype, device=maps.device)
    g_pts[1:-1, :-2] -= gdy
    g_pts[1:-1, 2:] += gdy
    g_pts[:-2, 1:-1] -= gdx
    g_pts[2:, 1:-1] += gdx
    g_cam = g_pts @ R.T
    xs, ys = _pixel_rays(K, H, W, maps.device)
    d_surf = g_cam[..., 2] + g_cam[..., 1] * ys[:, None] + g_cam[..., 0] * xs[None, :]
    if depth_ratio != 0.0:
        d_surf = d_surf * (1.0 - depth_ratio)
    d_depth = d_surf / ca
    d_alpha = torch.where(alpha >= 1e-10, -d_surf * ((depth / ca) / ca), zero)
    return torch.cat([d_normal, d_depth[..., None], d_alpha[..., None],
                      (g_d + torch.zeros_like(depth))[..., None]], dim=-1)


def _six_maps(maps: torch.Tensor) -> torch.Tensor:
    """``surfel_terms_plain``'s (H, W, 6) maps of the raster's (H, W, 12)
    buffer."""
    return torch.cat([maps[..., ROW_NORMAL:ROW_NORMAL + 3], maps[..., ROW_DEPTH, None],
                      maps[..., ROW_ALPHA, None], maps[..., ROW_DIST, None]], dim=-1)


# Per device: the forward kernel's block ticket (one unsigned int, zero
# between launches: the launch's last block sets it back).
_TICKETS = {}


def _check_terms_args(maps, viewmat, K):
    if maps.dim() != 3 or maps.shape[2] != OUT_ROWS or maps.shape[0] < 1 or maps.shape[1] < 1:
        raise ValueError(f"surfel_terms: maps must be (H, W, {OUT_ROWS}), got {tuple(maps.shape)}")
    if tuple(viewmat.shape) != (4, 4) or tuple(K.shape) != (3, 3):
        raise ValueError("surfel_terms: viewmat must be (4, 4) and K (3, 3)")
    if maps.device.type == "cuda":
        for name, x in (("maps", maps), ("viewmat", viewmat), ("K", K)):
            if x.dtype != torch.float32 or x.device != maps.device:
                raise ValueError(f"surfel_terms: {name} must be float32 on {maps.device}, got "
                                 f"{x.dtype} on {x.device}")
        if not (viewmat.is_contiguous() and K.is_contiguous()):
            raise ValueError("surfel_terms: viewmat and K must be contiguous")
    elif maps.device.type != "cpu":
        raise ValueError(f"surfel_terms runs on CUDA or CPU tensors, not {maps.device}")


def _terms_fn(which: str):
    fn = getattr(_build.load("surfel_terms"), f"gs_surfel_terms_{which}")
    pointers = 6 if which == "fwd" else 5
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int64] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_double] + [ctypes.c_void_p] * (pointers + 1))
    fn.restype = ctypes.c_int
    return fn


def _maps_args(maps: torch.Tensor, depth_ratio: float):
    H, W, _ = maps.shape
    return (maps.data_ptr(), *maps.stride(), H, W, float(depth_ratio))


def _surfel_terms_fwd_cuda(maps, viewmat, K, depth_ratio):
    dev = maps.device
    lib = _build.load("surfel_terms")
    lib.gs_surfel_terms_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gs_surfel_terms_blocks.restype = ctypes.c_int64
    n_blocks = lib.gs_surfel_terms_blocks(maps.shape[0], maps.shape[1])
    partial = torch.empty((n_blocks, 2), dtype=torch.float64, device=dev)
    ticket = _TICKETS.get(dev)
    if ticket is None:
        ticket = _TICKETS[dev] = torch.zeros((1,), dtype=torch.int32, device=dev)
    l_n = torch.empty((), dtype=torch.float32, device=dev)
    l_d = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _terms_fn("fwd")(*_maps_args(maps, depth_ratio), viewmat.data_ptr(), K.data_ptr(),
                              partial.data_ptr(), ticket.data_ptr(), l_n.data_ptr(),
                              l_d.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"surfel_terms forward kernel launch failed: cudaError {rc}")
    profiling.count("launch.surfel_terms_fwd")
    return l_n, l_d


def _surfel_terms_bwd_cuda(maps, viewmat, K, depth_ratio, g_normal, g_dist):
    grad = torch.empty(maps.shape, dtype=torch.float32, device=maps.device)
    gs = [None if g is None else g.to(torch.float32).contiguous() for g in (g_normal, g_dist)]
    with torch.cuda.device(maps.device):
        rc = _terms_fn("bwd")(*_maps_args(maps, depth_ratio), viewmat.data_ptr(), K.data_ptr(),
                              *(0 if g is None else g.data_ptr() for g in gs), grad.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"surfel_terms backward kernel launch failed: cudaError {rc}")
    profiling.count("launch.surfel_terms_bwd")
    return grad


class _SurfelTerms(torch.autograd.Function):
    """``surfel_terms_plain`` of the raster's map buffer: the kernel pair of
    ``csrc/surfel_terms.cu`` on CUDA tensors, the plain forward and
    ``surfel_terms_bwd_plain`` on CPU tensors. Saves the buffer (a view)."""

    @staticmethod
    def forward(ctx, maps, viewmat, K, depth_ratio):
        if maps.device.type == "cuda":
            l_n, l_d = _surfel_terms_fwd_cuda(maps, viewmat, K, depth_ratio)
        else:
            l_n, l_d = surfel_terms_plain(_six_maps(maps), viewmat, K, depth_ratio,
                                          maps[..., ROW_MEDIAN])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(maps, viewmat, K)
        ctx.depth_ratio = depth_ratio
        return l_n, l_d

    @staticmethod
    def backward(ctx, g_normal, g_dist):
        maps, viewmat, K = ctx.saved_tensors
        if maps.device.type == "cuda":
            grad = _surfel_terms_bwd_cuda(maps, viewmat, K, ctx.depth_ratio, g_normal, g_dist)
        else:
            d6 = surfel_terms_bwd_plain(_six_maps(maps), viewmat, K, ctx.depth_ratio,
                                        maps[..., ROW_MEDIAN], g_normal, g_dist)
            grad = torch.zeros(maps.shape, dtype=maps.dtype, device=maps.device)
            grad[..., ROW_NORMAL:ROW_NORMAL + 3] = d6[..., :3]
            grad[..., ROW_DEPTH] = d6[..., 3]
            grad[..., ROW_ALPHA] = d6[..., 4]
            grad[..., ROW_DIST] = d6[..., 5]
        return grad, None, None, None


def surfel_terms(maps: torch.Tensor, viewmat: torch.Tensor, K: torch.Tensor,
                 depth_ratio: float = 0.0):
    """(normal consistency, distortion) of one surfel view, as
    ``surfel_terms_plain`` computes them, from the raster's (H, W, 12) map
    buffer (``RenderOut.maps``, read where it lies, any strides) with its
    median depth row for ``depth_ratio`` > 0. Differentiable with respect to
    ``maps``: one (H, W, 12) gradient, zero in the rows the terms do not
    read (the median included); the view takes none. CUDA tensors launch
    ``csrc/surfel_terms.cu`` (float32 only; counters
    ``launch.surfel_terms_fwd`` / ``_bwd``, one a call), reading the view
    from device memory; CPU tensors take the plain forward and the
    hand-derived ``surfel_terms_bwd_plain``."""
    _check_terms_args(maps, viewmat, K)
    return _SurfelTerms.apply(maps, viewmat, K, float(depth_ratio))
