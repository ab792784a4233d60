"""Tiled rasterization on the GPU: binning + the hand-written forward
kernel (counterpart of ``gaussian_splatting_tpu/ops/rasterize_pallas.py``,
forward half; the ``"cuda"`` render backend).

``rasterize_tiled`` bins the gaussians (``ops/tiling.py``, with CUDA kernel
1, ``pack_soa``) and runs CUDA kernel 2 (``csrc/rasterize_fwd.cu``) over the
(16, M) SoA: one block per 16x16 tile, one thread per pixel. The stop rule
is the TPU kernel's, chunk by chunk (see ``fwd_tiles_plain``), so the chunk
length is part of the result. The backward kernel belongs to the training
slice: differentiating the result raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gaussian_splatting_tpu_torch.ops import _build
from gaussian_splatting_tpu_torch.ops.tiling import (
    cdiv,
    check_binning_mode,
    isect_and_sort,
    total_slots,
)

ALPHA_CLAMP = 0.999
ALPHA_SKIP = 1.0 / 255.0
T_EARLY_STOP = 1e-4
# Tiles per step of the plain forward: bounds its (tiles, 256, chunk)
# temporaries to ~270 MB each at chunk 256.
_PLAIN_TILE_BATCH = 1024


def _cumprod_sequential(x: torch.Tensor) -> torch.Tensor:
    """Inclusive product along the last axis, multiplied strictly left to
    right. ``torch.cumprod`` does this on the CPU but scans in tree order on
    CUDA; fixing the order keeps the stop decisions (T > 1e-4) bit-identical
    to the kernel's, which walks each chunk sequentially."""
    out = torch.empty_like(x)
    p = x[..., 0]
    out[..., 0] = p
    for k in range(1, x.shape[-1]):
        p = p * x[..., k]
        out[..., k] = p
    return out


def fwd_tiles_plain(tile_starts: torch.Tensor, counts: torch.Tensor,
                    soa: torch.Tensor, tile_size: int, ntx: int, chunk: int):
    """Plain PyTorch version of the forward kernel. Returns ``(out, pairs)``:
    ``out`` (T, 8, P) rows [r, g, b, depth, sum_w, 0, 0, 0] and ``pairs``,
    the number of (pixel, entry) pairs the kernel evaluates on these inputs
    (the entries that count plus the one that stops each pixel's chunk).

    A per-chunk loop vectorized over a batch of tiles, with the TPU kernel's
    chunk-carried stop rule (``rasterize_pallas.py:171-190``): inside a chunk
    an entry counts while ``tcar * prod_incl > 1e-4``; the carry
    ``tcar`` becomes the transmittance after the chunk's last counted entry.
    A pixel stopped in one chunk can therefore take entries of the next."""
    T = counts.shape[0]
    ts = tile_size
    P = ts * ts
    dev = soa.device
    out = torch.zeros((T, 8, P), dtype=torch.float32, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    pidx = torch.arange(P, device=dev)
    kk = torch.arange(chunk, device=dev)
    for t0 in range(0, T, _PLAIN_TILE_BATCH):
        t1 = min(T, t0 + _PLAIN_TILE_BATCH)
        tiles = torch.arange(t0, t1, device=dev)
        cnt = counts[t0:t1].long()
        st = tile_starts[t0:t1].long()
        px = (((tiles % ntx) * ts)[:, None] + pidx % ts).to(torch.float32)[:, :, None] + 0.5
        py = (((tiles // ntx) * ts)[:, None] + pidx // ts).to(torch.float32)[:, :, None] + 0.5
        tcar = torch.ones((t1 - t0, P, 1), dtype=torch.float32, device=dev)
        n_chunks = int(cdiv(int(cnt.max()), chunk)) if t1 > t0 else 0
        for ci in range(n_chunks):
            pos = ci * chunk + kk                                  # (K,)
            valid = pos[None, :] < cnt[:, None]                    # (B, K)
            idx = torch.where(valid, st[:, None] + pos[None, :], 0)
            data = soa[:10][:, idx]                                # (10, B, K)
            mx, my, ca, cb, cc, op = (data[i][:, None, :] for i in range(6))
            dx = px - mx
            dy = py - my
            sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
            araw = op * torch.exp(-sigma)
            contrib = (sigma >= 0.0) & (araw >= ALPHA_SKIP) & valid[:, None, :]
            alpha = torch.where(contrib, torch.clamp_max(araw, ALPHA_CLAMP), 0.0)
            prod_incl = _cumprod_sequential(1.0 - alpha)
            prod_excl = torch.cat([torch.ones_like(prod_incl[..., :1]),
                                   prod_incl[..., :-1]], dim=-1)
            mask = tcar * prod_incl > T_EARLY_STOP
            w = torch.where(mask, alpha * tcar * prod_excl, 0.0)  # (B, P, K)
            for row in range(4):                                   # r, g, b, depth
                out[t0:t1, row] += (w * data[6 + row][:, None, :]).sum(-1)
            out[t0:t1, 4] += w.sum(-1)
            tcar = tcar * torch.where(mask, prod_incl, 1.0).amin(-1, keepdim=True)
            n_valid = valid.sum(-1)[:, None]
            pairs += torch.minimum(mask.sum(-1) + 1, n_valid).sum()
    return out, pairs


def _check_fwd_args(tile_starts, counts, soa, tile_size, chunk):
    T = counts.shape[0]
    if tile_starts.dtype != torch.int32 or tuple(tile_starts.shape) != (T + 1,):
        raise ValueError(f"tile_starts must be ({T + 1},) int32")
    if counts.dtype != torch.int32 or counts.dim() != 1:
        raise ValueError("counts must be (T,) int32")
    if soa.dtype != torch.float32 or soa.dim() != 2 or soa.shape[0] != 16:
        raise ValueError(f"soa must be (16, M) float32, got {tuple(soa.shape)} {soa.dtype}")
    if not (tile_starts.device == counts.device == soa.device):
        raise ValueError("tile_starts, counts and soa must be on one device")
    if not (tile_starts.is_contiguous() and counts.is_contiguous() and soa.is_contiguous()):
        raise ValueError("tile_starts, counts and soa must be contiguous")
    if tile_size * tile_size not in (64, 256, 1024):
        raise ValueError("tile_size must be 8, 16 or 32")
    if not 1 <= chunk <= 1024:
        raise ValueError("chunk must be in [1, 1024] (shared memory holds 10 rows of it)")


def fwd_tiles(tile_starts: torch.Tensor, counts: torch.Tensor, soa: torch.Tensor,
              tile_size: int, ntx: int, chunk: int) -> torch.Tensor:
    """Forward blend of every tile's segment: (T, 8, tile_size^2) rows
    [r, g, b, depth, sum_w, 0, 0, 0]. CUDA tensors run the kernel
    (``csrc/rasterize_fwd.cu``), CPU tensors the plain version."""
    _check_fwd_args(tile_starts, counts, soa, tile_size, chunk)
    if soa.device.type == "cpu":
        return fwd_tiles_plain(tile_starts, counts, soa, tile_size, ntx, chunk)[0]
    if soa.device.type != "cuda":
        raise ValueError(f"fwd_tiles runs on CUDA or CPU tensors, not {soa.device}")
    lib = _build.load("rasterize_fwd")
    fn = lib.gs_rasterize_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    T = counts.shape[0]
    P = tile_size * tile_size
    out = torch.empty((T, 8, P), dtype=torch.float32, device=soa.device)
    with torch.cuda.device(soa.device):
        rc = fn(tile_starts.data_ptr(), counts.data_ptr(), soa.data_ptr(),
                soa.shape[1], out.data_ptr(), T, tile_size, ntx, chunk,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rasterize_fwd kernel launch failed: cudaError {rc}")
    fwd_tiles.launches += 1
    return out


fwd_tiles.launches = 0


def grad_cap(n_gaussians: int, max_t: int, chunk: int) -> int:
    """Capacity of the backward kernel's gradient stream
    (``rasterize_pallas.py:823-828``: dense layout, ``grad_cap_mult`` 8,
    ``grad_buffer_frac`` 1). The forward only needs it for the
    ``n_grad_dropped`` bound in the stats; the training slice adds the
    fraction."""
    bound = max(chunk, min(total_slots(n_gaussians, max_t, None), 8 * n_gaussians))
    return cdiv(bound, chunk) * chunk + chunk


class _RasterizeTiled(torch.autograd.Function):
    """Binning + forward kernel. The backward kernel is the training slice's
    work; until it lands, differentiating raises instead of returning a
    result that silently has no gradient."""

    @staticmethod
    def forward(ctx, means2d, conics, colors, opacities, depths, radii, cfg):
        width, height, ts, chunk, max_t, gcap = cfg
        b = isect_and_sort(means2d, conics, colors, opacities, depths, radii,
                           width, height, ts, chunk, max_t)
        out = fwd_tiles(b.tile_starts, b.counts, b.sorted_soa, ts,
                        cdiv(width, ts), chunk)
        n_grad_dropped = torch.clamp_min(b.n_isect + chunk - gcap, 0)
        ctx.mark_non_differentiable(b.n_isect, b.n_dropped, b.n_budget_dropped,
                                    n_grad_dropped)
        return out, b.n_isect, b.n_dropped, b.n_budget_dropped, n_grad_dropped

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "backward kernel: ROADMAP queue 2 item 3 (_bwd_kernel, training slice)")


def rasterize_tiled(
    means2d,
    conics,
    colors,
    opacities,
    depths,
    radii,
    width,
    height,
    bg: Optional[torch.Tensor] = None,
    tile_size: int = 16,
    chunk: int = 256,
    max_tiles_per_gaussian: int = 16,
    class_budgets=None,
    depth_bits: int = 0,
    sort_buckets: int = 0,
    sort_bands: int = 0,
    with_stats: bool = False,
):
    """Tiled rasterization: binning + CUDA kernels (plain versions for CPU
    tensors). Returns (image (H, W, 3), alpha (H, W), depth (H, W)), plus a
    stats dict (n_isect, n_dropped, n_budget_dropped, n_grad_dropped) with
    ``with_stats``. ``class_budgets``, ``depth_bits``, ``sort_buckets`` and
    ``sort_bands`` are not ported yet and raise ``NotImplementedError``."""
    ts = tile_size
    if ts * ts not in (64, 256, 1024):
        raise ValueError("tile_size must be 8, 16, or 32")
    check_binning_mode(class_budgets, depth_bits, sort_buckets, sort_bands)
    ntx = cdiv(width, ts)
    nty = cdiv(height, ts)
    gcap = grad_cap(means2d.shape[0], max_tiles_per_gaussian, chunk)
    cfg = (width, height, ts, chunk, max_tiles_per_gaussian, gcap)
    out, n_isect, n_dropped, n_budget_dropped, n_grad_dropped = _RasterizeTiled.apply(
        means2d, conics, colors, opacities, depths, radii, cfg)

    img = out.reshape(nty, ntx, 8, ts, ts).permute(0, 3, 1, 4, 2)
    img = img.reshape(nty * ts, ntx * ts, 8)[:height, :width]
    rgb = img[..., 0:3]
    depth_img = img[..., 3]
    alpha_img = img[..., 4]
    if bg is not None:
        rgb = rgb + (1.0 - alpha_img)[..., None] * bg[None, None, :]
    if with_stats:
        return rgb, alpha_img, depth_img, {
            "n_isect": n_isect,
            "n_dropped": n_dropped,
            "n_budget_dropped": n_budget_dropped,
            "n_grad_dropped": n_grad_dropped,
        }
    return rgb, alpha_img, depth_img
