"""Tiled rasterization on the GPU with analytic gradients: binning + the
hand-written forward and backward kernels (counterpart of
``gaussian_splatting_tpu/ops/rasterize_pallas.py``; the ``"cuda"`` render
backend).

``rasterize_tiled`` bins the gaussians (``ops/tiling.py``, with CUDA kernel
1, ``pack_soa``) and runs CUDA kernel 2 (``csrc/rasterize_fwd.cu``) over the
(16, M) SoA: one block per 16x16 tile, one thread per pixel. The stop rule
is the TPU kernel's, chunk by chunk (see ``fwd_tiles_plain``), so the chunk
length is part of the result. Its backward runs CUDA kernel 3
(``csrc/rasterize_bwd.cu``), which recomputes the forward's alphas and
appends per-entry gradients tagged with the gaussian id to one stream, then
reduces the stream per gaussian (``tiling.reduce_padded_grads``: id sort,
CUDA kernels 5 ``pack_rows`` and 4 ``segsum``).

``queue=True`` runs the same two sweeps on the flat chunk queue
(``tiling.chunk_queue``): CUDA kernels 6 (``csrc/rasterize_fwd_q.cu``) and
7 (``csrc/rasterize_bwd_q.cu``), persistent blocks that each walk one
tile's work items, with the loop kernels' per-chunk bodies; the forward is
the loop forward's bit for bit. ``sort_buckets`` bins through the bucket
partition (``tiling._bucket_binned``, CUDA kernel 8).

Inside a tile, each warp of the four sweep kernels covers an 8x4 pixel block
and skips the entries that reach none of its pixels, by an exact
ellipse-rectangle test that leaves the output unchanged
(``csrc/raster_tiles.cuh``); ``warp_cull_plain`` mirrors the test.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from gaussian_splatting_tpu_torch.ops import _build
from gaussian_splatting_tpu_torch.ops.tiling import (
    cdiv,
    chunk_queue,
    isect_and_sort,
    reduce_padded_grads,
    total_slots,
)
from gaussian_splatting_tpu_torch.utils import profiling

ALPHA_CLAMP = 0.999
ALPHA_SKIP = 1.0 / 255.0
T_EARLY_STOP = 1e-4
# Tiles and (tile, pixel, entry) elements per step of the plain sweeps: at
# most 1024 tiles, and (tiles, P, K) temporaries of at most 2^26 floats
# (~270 MB each, 1024 tiles of 256 pixels at chunk 256).
_PLAIN_TILE_BATCH = 1024
_PLAIN_ELEMS = 1 << 26
# The longest chunk the kernels take (a power of two above 1024 is staged in
# pieces of 256, csrc/raster_tiles.cuh); the JAX package takes any power of
# two.
_MAX_CHUNK = 1 << 30
# The warp cull's slack against float32 rounding, relative to the largest
# magnitude of the quadratic form's terms (csrc/raster_tiles.cuh), and the
# entries per step of its plain mirror's (warps, 32, entries) temporaries.
_CULL_SLACK = 1e-5
_CULL_BATCH = 1 << 15


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


def _plain_batches(counts: torch.Tensor, chunk: int, P: int):
    """The tile batches of the plain sweeps: ``(tiles, longest)`` with the
    tiles in descending order of their counts, so that a batch holds tiles
    of like length, and each batch's (tiles, P, K) temporaries within
    ``_PLAIN_ELEMS``, K its longest count cut to the chunk. A chunk's
    entries past every count of the batch carry nothing (alpha 0, the
    products unchanged), so the sweeps take K = min(chunk, what is left of
    the longest count) entries of each chunk."""
    order = torch.argsort(counts, descending=True, stable=True)
    cnt = counts[order].tolist()
    i = 0
    while i < len(cnt):
        k = max(1, min(chunk, cnt[i]))
        n = max(1, min(_PLAIN_TILE_BATCH, _PLAIN_ELEMS // (P * k)))
        yield order[i:i + n], cnt[i]
        i += n


def _pixel_centres(tiles: torch.Tensor, ts: int, ntx: int):
    """(B, P, 1) float32 x and y of the pixel centres of ``tiles``, pixels in
    row-major order."""
    pidx = torch.arange(ts * ts, device=tiles.device)
    px = (((tiles % ntx) * ts)[:, None] + pidx % ts).to(torch.float32)[:, :, None] + 0.5
    py = (((tiles // ntx) * ts)[:, None] + pidx // ts).to(torch.float32)[:, :, None] + 0.5
    return px, py


def fwd_tiles_plain(tile_starts: torch.Tensor, counts: torch.Tensor,
                    soa: torch.Tensor, tile_size: int, ntx: int, chunk: int):
    """Plain PyTorch version of the forward kernel. Returns ``(out, pairs)``:
    ``out`` (T, 8, P) rows [r, g, b, depth, sum_w, 0, 0, 0] and ``pairs``,
    the number of (pixel, entry) pairs the kernel evaluates on these inputs
    (the entries that count plus the one that stops each pixel's chunk).

    A per-chunk loop vectorized over a batch of tiles (``_plain_batches``),
    with the TPU kernel's chunk-carried stop rule
    (``rasterize_pallas.py:171-190``): inside a chunk an entry counts while
    ``tcar * prod_incl > 1e-4``; the carry ``tcar`` becomes the
    transmittance after the chunk's last counted entry. A pixel stopped in
    one chunk can therefore take entries of the next."""
    T = counts.shape[0]
    P = tile_size * tile_size
    dev = soa.device
    out = torch.zeros((T, 8, P), dtype=torch.float32, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    for tiles, longest in _plain_batches(counts, chunk, P):
        cnt = counts[tiles].long()
        st = tile_starts[tiles].long()
        px, py = _pixel_centres(tiles, tile_size, ntx)
        acc = torch.zeros((tiles.shape[0], 5, P), dtype=torch.float32, device=dev)
        tcar = torch.ones((tiles.shape[0], P, 1), dtype=torch.float32, device=dev)
        for c0 in range(0, longest, chunk):
            pos = c0 + torch.arange(min(chunk, longest - c0), device=dev)  # (K,)
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
                acc[:, row] += (w * data[6 + row][:, None, :]).sum(-1)
            acc[:, 4] += w.sum(-1)
            tcar = tcar * torch.where(mask, prod_incl, 1.0).amin(-1, keepdim=True)
            n_valid = valid.sum(-1)[:, None]
            pairs += torch.minimum(mask.sum(-1) + 1, n_valid).sum()
        out[tiles, :5] = acc
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
    if not (1 <= chunk <= 1024 or (chunk & (chunk - 1) == 0 and chunk <= _MAX_CHUNK)):
        raise ValueError(f"chunk must be in [1, 1024] or a power of two up to {_MAX_CHUNK} "
                         f"(the kernels stage a longer chunk 256 entries at a time)")


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
    profiling.count("launch.rasterize_fwd")
    return out


def bwd_tiles_plain(tile_starts: torch.Tensor, counts: torch.Tensor, soa: torch.Tensor,
                    gout: torch.Tensor, fout: torch.Tensor, tile_size: int, ntx: int,
                    chunk: int, n_gaussians: int, grad_cap: int):
    """Plain PyTorch version of the backward kernel. Returns ``(grad,
    meta, active)``: ``grad`` and ``meta`` as ``bwd_tiles`` returns them,
    with the stream's columns in the TPU kernel's order: tile by tile,
    entry by entry, each tile's entries appended right after the previous
    tile's (entry k of tile t at ``excl_prefix(counts)[t] + k``, whatever
    the gaps between segments in the SoA), and ``active``, the number of
    (pixel, entry) pairs that count and pass the alpha gate, for which the
    kernel computes gradient terms.

    A per-chunk loop vectorized over a batch of tiles (``_plain_batches``).
    It recomputes the forward of ``fwd_tiles_plain`` (same float32
    operations, the sequential product, so the same stop mask) and the
    per-entry gradients of ``rasterize_pallas.py:338-390`` with the prefix
    sum of gw * w carried across chunks, summed over each tile's pixels."""
    ts = tile_size
    P = ts * ts
    dev = soa.device
    grad = torch.empty((16, grad_cap), dtype=torch.float32, device=dev)
    excl = torch.cumsum(counts.long(), 0) - counts.long()  # stream start of each tile
    total = int(counts.sum())
    n_chunks_total = cdiv(total, chunk)
    kept = min(n_chunks_total, grad_cap // chunk) * chunk
    grad[:, :kept] = 0.0
    grad[0, :kept] = float(n_gaussians)
    active = torch.zeros((), dtype=torch.int64, device=dev)
    for tiles, longest in _plain_batches(counts, chunk, P):
        cnt = counts[tiles].long()
        st = tile_starts[tiles].long()
        px, py = _pixel_centres(tiles, ts, ntx)
        g = gout[tiles]                                             # (B, 8, P)
        q = (g * fout[tiles]).sum(1)[:, :, None]                    # (B, P, 1)
        gc = [g[:, c, :, None] for c in range(5)]                   # (B, P, 1) each
        tcar = torch.ones((tiles.shape[0], P, 1), dtype=torch.float32, device=dev)
        pcar = torch.zeros((tiles.shape[0], P, 1), dtype=torch.float32, device=dev)
        for c0 in range(0, longest, chunk):
            pos = c0 + torch.arange(min(chunk, longest - c0), device=dev)  # (K,)
            valid = pos[None, :] < cnt[:, None]                    # (B, K)
            col = torch.where(valid, st[:, None] + pos[None, :], 0)
            data = soa[:12][:, col]                                # (12, B, K)
            mx, my, ca, cb, cc, op = (data[i][:, None, :] for i in range(6))
            dx = px - mx
            dy = py - my
            sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
            vis = torch.exp(-sigma)
            araw = op * vis
            contrib = (sigma >= 0.0) & (araw >= ALPHA_SKIP) & valid[:, None, :]
            alpha = torch.where(contrib, torch.clamp_max(araw, ALPHA_CLAMP), 0.0)
            prod_incl = _cumprod_sequential(1.0 - alpha)
            prod_excl = torch.cat([torch.ones_like(prod_incl[..., :1]),
                                   prod_incl[..., :-1]], dim=-1)
            mask = tcar * prod_incl > T_EARLY_STOP
            t_before = tcar * prod_excl
            w = torch.where(mask, alpha * t_before, 0.0)          # (B, P, K)
            gw = sum(gc[c] * data[6 + c][:, None, :] for c in range(4)) + gc[4]
            gww = gw * w
            prefix = pcar + torch.cumsum(gww, dim=-1)
            d_alpha = torch.where(mask & contrib,
                                  gw * t_before - (q - prefix) / (1.0 - alpha), 0.0)
            active += (mask & contrib).sum()
            gate = contrib & (araw <= ALPHA_CLAMP)
            d_sigma = torch.where(gate, -d_alpha * araw, 0.0)
            rows = (
                (-(ca * dx + cb * dy) * d_sigma).sum(1),
                (-(cc * dy + cb * dx) * d_sigma).sum(1),
                (0.5 * dx * dx * d_sigma).sum(1),
                (dx * dy * d_sigma).sum(1),
                (0.5 * dy * dy * d_sigma).sum(1),
                torch.where(gate, d_alpha * vis, 0.0).sum(1),
                *((w * gc[c]).sum(1) for c in range(4)),
            )                                                      # 10 x (B, K)
            dest = (excl[tiles, None] + pos[None, :])[valid]
            keep = dest < kept
            dest = dest[keep]
            grad[0, dest] = data[11][valid][keep]
            for r, v in enumerate(rows):
                grad[1 + r, dest] = v[valid][keep]
            tcar = tcar * torch.where(mask, prod_incl, 1.0).amin(-1, keepdim=True)
            pcar = pcar + gww.sum(-1, keepdim=True)
    meta = torch.tensor([kept, n_chunks_total * chunk - kept], dtype=torch.int32,
                        device=dev)
    return grad, meta, active


def warp_pixel_map(tile_size: int) -> torch.Tensor:
    """(n_warps, 32) int64: the tile pixel (row-major) of each lane of each
    warp in the raster kernels (``csrc/raster_tiles.cuh::tile_pixel``).
    Warp w covers the 8x4 block (w % (ts / 8), w // (ts / 8)) of its tile,
    lane l the block's pixel (l % 8, l // 8)."""
    ts = tile_size
    w = torch.arange(ts * ts // 32)[:, None]
    lane = torch.arange(32)[None, :]
    return ((w // (ts // 8)) * 4 + lane // 8) * ts + (w % (ts // 8)) * 8 + lane % 8


def _cull_gate(e: torch.Tensor) -> torch.Tensor:
    """``raster_tiles.cuh::cull_gate`` of entries ``e`` (10, E): the gate
    threshold Q = 2 (ln(255 op) + 1e-3), or +inf where the entry is never
    skipped (op < 1/255, a conic that is not positive definite, a value
    that is not finite)."""
    ca, cb, cc, op = e[2], e[3], e[4], e[5]
    det = ca * cc - cb * cb
    ok = torch.isfinite(e).all(0) & (op >= ALPHA_SKIP) & (ca > 0) & (cc > 0) & (det > 0)
    return torch.where(ok, 2.0 * (torch.log(255.0 * op) + 1e-3), float("inf"))


def _quad(ca, cb, cc, qx, qy):
    return ca * qx * qx + 2.0 * cb * qx * qy + cc * qy * qy


def _warp_may_hit(xl, xh, yl, yh, mx, my, ca, cb, cc, gate):
    """``raster_tiles.cuh::warp_may_hit``, the same float32 operations in the
    same order: False only if the minimum of the quadratic form over the
    rectangle of pixel centres [xl, xh] x [yl, yh] exceeds the gate by more
    than the rounding slack."""
    dxl, dxh, dyl, dyh = xl - mx, xh - mx, yl - my, yh - my
    inside = (dxl <= 0) & (dxh >= 0) & (dyl <= 0) & (dyh >= 0)

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    q_min = torch.minimum(
        torch.minimum(_quad(ca, cb, cc, dxl, clip(-cb * dxl / cc, dyl, dyh)),
                      _quad(ca, cb, cc, dxh, clip(-cb * dxh / cc, dyl, dyh))),
        torch.minimum(_quad(ca, cb, cc, clip(-cb * dyl / ca, dxl, dxh), dyl),
                      _quad(ca, cb, cc, clip(-cb * dyh / ca, dxl, dxh), dyh)))
    scale = _quad(ca, cb.abs(), cc, torch.maximum(dxl.abs(), dxh.abs()),
                  torch.maximum(dyl.abs(), dyh.abs()))
    return inside | ~(q_min > gate + _CULL_SLACK * scale)


def warp_cull_plain(tile_starts: torch.Tensor, counts: torch.Tensor, soa: torch.Tensor,
                    tile_size: int, ntx: int):
    """Plain mirror of the raster kernels' warp cull. Returns ``(keep,
    touched)``, both (n_warps, E) bool over the E = counts.sum() entries in
    tile order (entry k of tile t at ``excl_prefix(counts)[t] + k``):
    ``keep`` is the kernels' ballot bit (False: warp w of the entry's tile
    skips it), ``touched`` whether the plain forward's ``contrib`` (sigma >=
    0 and op e^-sigma >= 1/255) holds at any pixel of warp w's 8x4 block.
    The cull is exact when ``keep`` holds wherever ``touched`` does."""
    ts = tile_size
    dev = soa.device
    T = counts.shape[0]
    cnt = counts.long()
    tile = torch.repeat_interleave(torch.arange(T, device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    col = tile_starts[tile].long() + torch.arange(tile.shape[0], device=dev) - first[tile]
    e = soa[:10, col]                                                    # (10, E)
    gate = _cull_gate(e)
    pix = warp_pixel_map(ts).to(dev)                                     # (W, 32)
    bx = (pix[:, 0] % ts)[:, None]                                       # (W, 1)
    by = (pix[:, 0] // ts)[:, None]
    x0 = ((tile % ntx) * ts)[None, :] + bx                               # (W, E)
    y0 = ((tile // ntx) * ts)[None, :] + by
    mx, my, ca, cb, cc, op = e[:6]
    keep = _warp_may_hit(x0.float() + 0.5, (x0 + 7).float() + 0.5, y0.float() + 0.5,
                         (y0 + 3).float() + 0.5, mx, my, ca, cb, cc, gate)
    touched = torch.zeros_like(keep)
    lx = (pix % ts - bx)[:, :, None]                                     # (W, 32, 1)
    ly = (pix // ts - by)[:, :, None]
    for s in range(0, tile.shape[0], _CULL_BATCH):
        sl = slice(s, s + _CULL_BATCH)
        px = (x0[:, None, sl] + lx).float() + 0.5                        # (W, 32, B)
        py = (y0[:, None, sl] + ly).float() + 0.5
        dx = px - mx[sl]
        dy = py - my[sl]
        sigma = 0.5 * (ca[sl] * dx * dx + cc[sl] * dy * dy) + cb[sl] * dx * dy
        araw = op[sl] * torch.exp(-sigma)
        touched[:, sl] = ((sigma >= 0.0) & (araw >= ALPHA_SKIP)).any(1)
    return keep, touched


def _check_bwd_args(tile_starts, counts, soa, gout, fout, tile_size, chunk, grad_cap):
    _check_fwd_args(tile_starts, counts, soa, tile_size, chunk)
    shape = (counts.shape[0], 8, tile_size * tile_size)
    for name, x in (("gout", gout), ("fout", fout)):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape} float32, got {tuple(x.shape)} {x.dtype}")
        if x.device != soa.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous and on the SoA's device")
    if grad_cap < chunk or grad_cap % chunk:
        raise ValueError("grad_cap must be a positive multiple of chunk")


def bwd_tiles(tile_starts: torch.Tensor, counts: torch.Tensor, soa: torch.Tensor,
              gout: torch.Tensor, fout: torch.Tensor, tile_size: int, ntx: int,
              chunk: int, n_gaussians: int, grad_cap: int):
    """Backward sweep of every tile's segment. ``gout`` is the cotangent of
    the forward output ``fout`` (both (T, 8, P)). Returns ``(grad, meta)``:
    the (16, grad_cap) stream, one column per entry [gaussian id, dmx, dmy,
    dA, dB, dC, dop, dr, dg, db, ddepth, 0 x 5], and meta (2,) int32
    [n_written, n_dropped], both counted in whole chunks as the TPU kernel
    counts them; columns in [entries, n_written) are sentinels (id N, zero
    payload), columns past n_written are unset. CUDA tensors run the kernel
    (``csrc/rasterize_bwd.cu``; its column order changes from run to run),
    CPU tensors the plain version."""
    _check_bwd_args(tile_starts, counts, soa, gout, fout, tile_size, chunk, grad_cap)
    if soa.device.type == "cpu":
        return bwd_tiles_plain(tile_starts, counts, soa, gout, fout, tile_size, ntx,
                               chunk, n_gaussians, grad_cap)[:2]
    if soa.device.type != "cuda":
        raise ValueError(f"bwd_tiles runs on CUDA or CPU tensors, not {soa.device}")
    fn = _build.load("rasterize_bwd").gs_rasterize_bwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    grad = torch.empty((16, grad_cap), dtype=torch.float32, device=soa.device)
    meta = torch.empty((3,), dtype=torch.int32, device=soa.device)
    with torch.cuda.device(soa.device):
        rc = fn(tile_starts.data_ptr(), counts.data_ptr(), soa.data_ptr(), soa.shape[1],
                gout.data_ptr(), fout.data_ptr(), grad.data_ptr(), grad_cap,
                meta.data_ptr(), counts.shape[0], tile_size, ntx, chunk,
                float(n_gaussians), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rasterize_bwd kernel launch failed: cudaError {rc}")
    profiling.count("launch.rasterize_bwd")
    return grad, meta[:2]


def _check_queue_args(wtile, cum, n_work, counts):
    T = counts.shape[0]
    if wtile.dtype != torch.int32 or wtile.dim() != 1:
        raise ValueError("wtile must be (w_cap,) int32")
    if cum.dtype != torch.int32 or tuple(cum.shape) != (T + 1,):
        raise ValueError(f"cum must be ({T + 1},) int32")
    if n_work.dtype != torch.int32 or n_work.numel() != 1:
        raise ValueError("n_work must be a one-element int32 tensor")
    if not (wtile.device == cum.device == n_work.device == counts.device):
        raise ValueError("the queue tables must be on the tiles' device")
    if not (wtile.is_contiguous() and cum.is_contiguous()):
        raise ValueError("wtile and cum must be contiguous")


def check_queue(wtile, cum, n_work, counts, chunk):
    """The plain versions' reading of the chunk queue: raise ``ValueError``
    unless work item w < n_work is chunk ``ci = w - cum[wtile[w]]`` of tile
    ``wtile[w]``, the items of each tile form one run of ``cdiv(count,
    chunk)`` items in tile order, and wtile holds all n_work items. Then the
    queue sweeps exactly the chunks of the per-tile loop."""
    T = counts.shape[0]
    nw = int(n_work.reshape(()))
    chunks = (cum[1:] - cum[:-1]).long()
    want = torch.repeat_interleave(torch.arange(T, device=counts.device), chunks)
    ok = (int(cum[0]) == 0 and int(cum[T]) == nw and wtile.shape[0] >= nw
          and torch.equal(chunks, cdiv(counts.long(), chunk)))
    if ok:
        t = wtile[:nw].long()
        ci = torch.arange(nw, device=counts.device) - cum[t].long()
        ok = torch.equal(t, want) and bool(((ci >= 0) & (ci < chunks[t])).all())
    if not ok:
        raise ValueError("the chunk queue does not describe these tiles' chunks")


def fwd_tiles_q(wtile: torch.Tensor, cum: torch.Tensor, tile_starts: torch.Tensor,
                counts: torch.Tensor, n_work: torch.Tensor, soa: torch.Tensor,
                tile_size: int, ntx: int, chunk: int) -> torch.Tensor:
    """``fwd_tiles`` driven by the chunk queue ``(wtile, cum, n_work)`` of
    ``tiling.chunk_queue`` (the order of ``rasterize_pallas.py:945``).
    Tiles with no work get zero blocks, as in ``fwd_tiles``. CUDA tensors
    run the kernel (``csrc/rasterize_fwd_q.cu``; its output is
    ``fwd_tiles``' bit for bit), CPU tensors the plain version: the queue
    checked by ``check_queue``, then ``fwd_tiles_plain``."""
    _check_fwd_args(tile_starts, counts, soa, tile_size, chunk)
    _check_queue_args(wtile, cum, n_work, counts)
    if soa.device.type == "cpu":
        check_queue(wtile, cum, n_work, counts, chunk)
        return fwd_tiles_plain(tile_starts, counts, soa, tile_size, ntx, chunk)[0]
    if soa.device.type != "cuda":
        raise ValueError(f"fwd_tiles_q runs on CUDA or CPU tensors, not {soa.device}")
    fn = _build.load("rasterize_fwd_q").gs_rasterize_fwd_q
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    T = counts.shape[0]
    out = torch.empty((T, 8, tile_size * tile_size), dtype=torch.float32, device=soa.device)
    next_tile = torch.empty((1,), dtype=torch.int32, device=soa.device)
    with torch.cuda.device(soa.device):
        rc = fn(wtile.data_ptr(), cum.data_ptr(), tile_starts.data_ptr(), counts.data_ptr(),
                n_work.data_ptr(), wtile.shape[0], soa.data_ptr(), soa.shape[1], out.data_ptr(),
                next_tile.data_ptr(), T, tile_size, ntx, chunk,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rasterize_fwd_q kernel launch failed: cudaError {rc}")
    profiling.count("launch.rasterize_fwd_q")
    return out


def bwd_tiles_q(wtile: torch.Tensor, cum: torch.Tensor, tile_starts: torch.Tensor,
                counts: torch.Tensor, n_work: torch.Tensor, soa: torch.Tensor,
                gout: torch.Tensor, fout: torch.Tensor, tile_size: int, ntx: int,
                chunk: int, n_gaussians: int, grad_cap: int):
    """``bwd_tiles`` driven by the chunk queue ``(wtile, cum, n_work)``.
    Returns ``(grad, meta)`` as ``bwd_tiles`` does. CUDA tensors run the
    kernel (``csrc/rasterize_bwd_q.cu``; its column order changes from run
    to run), CPU tensors the plain version: the queue checked by
    ``check_queue``, then ``bwd_tiles_plain``."""
    _check_bwd_args(tile_starts, counts, soa, gout, fout, tile_size, chunk, grad_cap)
    _check_queue_args(wtile, cum, n_work, counts)
    if soa.device.type == "cpu":
        check_queue(wtile, cum, n_work, counts, chunk)
        return bwd_tiles_plain(tile_starts, counts, soa, gout, fout, tile_size, ntx,
                               chunk, n_gaussians, grad_cap)[:2]
    if soa.device.type != "cuda":
        raise ValueError(f"bwd_tiles_q runs on CUDA or CPU tensors, not {soa.device}")
    fn = _build.load("rasterize_bwd_q").gs_rasterize_bwd_q
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64] + [
        ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    grad = torch.empty((16, grad_cap), dtype=torch.float32, device=soa.device)
    meta = torch.empty((3,), dtype=torch.int32, device=soa.device)
    next_tile = torch.empty((1,), dtype=torch.int32, device=soa.device)
    with torch.cuda.device(soa.device):
        rc = fn(wtile.data_ptr(), cum.data_ptr(), tile_starts.data_ptr(), counts.data_ptr(),
                n_work.data_ptr(), wtile.shape[0], soa.data_ptr(), soa.shape[1], gout.data_ptr(),
                fout.data_ptr(), grad.data_ptr(), grad_cap, meta.data_ptr(),
                next_tile.data_ptr(), counts.shape[0], tile_size, ntx, chunk,
                float(n_gaussians), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rasterize_bwd_q kernel launch failed: cudaError {rc}")
    profiling.count("launch.rasterize_bwd_q")
    return grad, meta[:2]


def n_sort_slots(n_gaussians: int, max_t: int, class_budgets=None, sort_bands: int = 0) -> int:
    """The binning's stream length (``rasterize_pallas.py:805-807``): the
    slots of one layout, times K with ``sort_bands = K > 1`` (each band
    enumerates ``total_slots`` slots under the shared budgets)."""
    return total_slots(n_gaussians, max_t, class_budgets) * max(int(sort_bands), 1)


def grad_cap(n_gaussians: int, max_t: int, chunk: int,
             grad_buffer_frac: float = 1.0, class_budgets=None, sort_bands: int = 0) -> int:
    """Capacity of the backward kernel's gradient stream
    (``rasterize_pallas.py:823-828``, ``grad_cap_mult`` 8): the bound, the
    stream length (``n_sort_slots``) on the compact layout
    (``class_budgets``) and min(stream length, 8N) on the dense one, scaled
    by ``grad_buffer_frac``, rounded up to a chunk, plus one chunk for the
    final sentinel pad."""
    n_slots = n_sort_slots(n_gaussians, max_t, class_budgets, sort_bands)
    bound = n_slots if class_budgets is not None else min(n_slots, 8 * n_gaussians)
    bound = max(chunk, int(bound * float(grad_buffer_frac)))
    return cdiv(bound, chunk) * chunk + chunk


class _Config(NamedTuple):
    width: int
    height: int
    ts: int
    chunk: int
    max_t: int
    grad_cap: int
    depth_grad: bool
    reduce_slices: int
    queue: bool
    w_cap: int
    sort_buckets: int
    bucket_headroom: float
    class_budgets: Optional[tuple]
    depth_bits: int
    sort_bands: int


def _config(N, width, height, ts, chunk, max_t, grad_buffer_frac, depth_grad=True,
            reduce_slices=0, queue=False, sort_buckets=0, bucket_headroom=1.5,
            class_budgets=None, depth_bits=0, sort_bands=0):
    """The static sizes of one rasterizer configuration
    (``rasterize_pallas.py:800-828``): the gradient stream's capacity and
    the chunk queue's, ``w_cap = n_slots // chunk + T`` (at most one
    partial chunk per tile beyond the full ones), n_slots the binning's
    stream length (``n_sort_slots``: the compact layout's slots when
    ``class_budgets`` is given, K times them with ``sort_bands = K``)."""
    T = cdiv(width, ts) * cdiv(height, ts)
    budgets = None if class_budgets is None else tuple(int(b) for b in class_budgets)
    return _Config(width, height, ts, chunk, max_t,
                   grad_cap(N, max_t, chunk, grad_buffer_frac, budgets, sort_bands),
                   bool(depth_grad), int(reduce_slices), bool(queue),
                   n_sort_slots(N, max_t, budgets, sort_bands) // chunk + T,
                   int(sort_buckets), float(bucket_headroom), budgets, int(depth_bits),
                   int(sort_bands))


def _binned(cfg: _Config, means2d, conics, colors, opacities, depths, radii):
    return isect_and_sort(means2d, conics, colors, opacities, depths, radii, cfg.width,
                          cfg.height, cfg.ts, cfg.chunk, cfg.max_t,
                          class_budgets=cfg.class_budgets, depth_bits=cfg.depth_bits,
                          sort_buckets=cfg.sort_buckets, sort_bands=cfg.sort_bands,
                          bucket_headroom=cfg.bucket_headroom)


def _run_fwd(cfg: _Config, b):
    """The forward sweep, on the loop kernel or the chunk queue
    (``rasterize_pallas.py:942-949``; the queue kernel writes the empty
    tiles' zero blocks itself, which the JAX caller does with a ``where``)."""
    ntx = cdiv(cfg.width, cfg.ts)
    if not cfg.queue:
        return fwd_tiles(b.tile_starts, b.counts, b.sorted_soa, cfg.ts, ntx, cfg.chunk)
    wtile, cum, n_work = chunk_queue(b.counts, cfg.chunk, cfg.w_cap)
    return fwd_tiles_q(wtile, cum, b.tile_starts, b.counts, n_work.reshape(1), b.sorted_soa,
                       cfg.ts, ntx, cfg.chunk)


def _run_bwd(cfg: _Config, tile_starts, counts, soa, gout, fout, n_gaussians):
    """The backward sweep, on the loop kernel or the chunk queue
    (``rasterize_pallas.py:951-958``)."""
    ntx = cdiv(cfg.width, cfg.ts)
    if not cfg.queue:
        return bwd_tiles(tile_starts, counts, soa, gout, fout, cfg.ts, ntx, cfg.chunk,
                         n_gaussians, cfg.grad_cap)
    wtile, cum, n_work = chunk_queue(counts, cfg.chunk, cfg.w_cap)
    return bwd_tiles_q(wtile, cum, tile_starts, counts, n_work.reshape(1), soa, gout, fout,
                       cfg.ts, ntx, cfg.chunk, n_gaussians, cfg.grad_cap)


class _RasterizeTiled(torch.autograd.Function):
    """Binning + forward kernel; the backward runs the backward kernel and
    the per-gaussian reduce (``rasterize_pallas.py:985-1004``)."""

    @staticmethod
    def forward(ctx, means2d, conics, colors, opacities, depths, radii, cfg):
        with profiling.annotate("render.binning"):
            b = _binned(cfg, means2d, conics, colors, opacities, depths, radii)
        with profiling.annotate("render.raster_fwd"):
            out = _run_fwd(cfg, b)
        n_grad_dropped = torch.clamp_min(b.n_isect + cfg.chunk - cfg.grad_cap, 0)
        n_budget_dropped = b.n_budget_dropped + b.n_bucket_dropped
        ctx.mark_non_differentiable(b.n_isect, b.n_dropped, n_budget_dropped,
                                    n_grad_dropped)
        ctx.save_for_backward(b.sorted_soa, b.tile_starts, b.counts, out)
        ctx.cfg = cfg
        ctx.n_gaussians = means2d.shape[0]
        return out, b.n_isect, b.n_dropped, n_budget_dropped, n_grad_dropped

    @staticmethod
    def backward(ctx, g_out, *_):
        cfg = ctx.cfg
        soa, tile_starts, counts, out = ctx.saved_tensors
        N = ctx.n_gaussians
        g = torch.zeros_like(out) if g_out is None else g_out.contiguous()
        with profiling.annotate("render.raster_bwd"):
            grad, meta = _run_bwd(cfg, tile_starts, counts, soa, g, out, N)
        with profiling.annotate("render.reduce"):
            gr = reduce_padded_grads(grad, N, meta[0], with_depth=cfg.depth_grad,
                                     sort_slices=cfg.reduce_slices)
            d_means2d = torch.stack([gr["dmx"], gr["dmy"]], dim=-1)
            d_conics = torch.stack([gr["dca"], gr["dcb"], gr["dcc"]], dim=-1)
            d_colors = torch.stack([gr["dr"], gr["dg"], gr["db"]], dim=-1)
        return d_means2d, d_conics, d_colors, gr["dop"], gr["ddepth"], None, None


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
    grad_buffer_frac: float = 1.0,
    reduce_slices: int = 0,
    depth_grad: bool = True,
    queue: bool = False,
    bucket_headroom: float = 1.5,
):
    """Tiled rasterization: binning + CUDA kernels (plain versions for CPU
    tensors). Returns (image (H, W, 3), alpha (H, W), depth (H, W)), plus a
    stats dict (n_isect, n_dropped, n_budget_dropped, n_grad_dropped) with
    ``with_stats``; differentiable with respect to means2d, conics, colors,
    opacities and depths through the backward kernel.

    ``grad_buffer_frac`` sizes the gradient stream (``grad_cap``);
    ``n_grad_dropped`` is the forward's conservative bound on what it
    drops. ``reduce_slices = K > 1`` reduces the stream in K sorted slices.
    ``depth_grad=False`` declares that the depth output is never
    differentiated: d_depths comes back zero and the reduce carries one
    payload row less. ``queue=True`` runs both sweeps on the flat chunk
    queue (CUDA kernels 6 and 7): the same image bit for bit, the same
    gradients up to summation order. ``sort_buckets = B`` bins through the
    bucket partition with ``bucket_headroom`` (``tiling.isect_and_sort``);
    its overflow is folded into ``n_budget_dropped``, as the JAX package
    does. ``class_budgets`` bins on the compact footprint-class layout
    (``tiling.compact_slots``; the gradient stream is then bounded by its
    slot count). ``depth_bits`` sorts on quantized depth keys and
    ``sort_bands = K`` bins K bands of tile rows on their own
    (``tiling.isect_and_sort``); the gradient stream and the chunk queue
    then bound K times the slot count."""
    ts = tile_size
    if ts * ts not in (64, 256, 1024):
        raise ValueError("tile_size must be 8, 16, or 32")
    ntx = cdiv(width, ts)
    nty = cdiv(height, ts)
    cfg = _config(means2d.shape[0], width, height, ts, chunk, max_tiles_per_gaussian,
                  grad_buffer_frac, depth_grad, reduce_slices, queue, sort_buckets,
                  bucket_headroom, class_budgets, depth_bits, sort_bands)
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


def rasterize_grad_meta(means2d, conics, colors, opacities, depths, radii, width,
                        height, tile_size: int = 16, chunk: int = 256,
                        max_tiles_per_gaussian: int = 16, class_budgets=None,
                        depth_bits: int = 0, grad_buffer_frac: float = 1.0,
                        sort_buckets: int = 0, bucket_headroom: float = 1.5,
                        sort_bands: int = 0, queue: bool = False):
    """Exact gradient-stream occupancy of one render: ``(n_written,
    n_dropped, grad_cap)`` as Python ints, from binning, the forward and one
    backward sweep with unit cotangents (occupancy depends on the segments,
    not on the cotangent values). Counterpart of ``rasterize_pallas.py:1120``;
    it sizes ``grad_buffer_frac``."""
    N = means2d.shape[0]
    cfg = _config(N, width, height, tile_size, chunk, max_tiles_per_gaussian,
                  grad_buffer_frac, queue=queue, sort_buckets=sort_buckets,
                  bucket_headroom=bucket_headroom, class_budgets=class_budgets,
                  depth_bits=depth_bits, sort_bands=sort_bands)
    with torch.no_grad():
        b = _binned(cfg, means2d, conics, colors, opacities, depths, radii)
        out = _run_fwd(cfg, b)
        _, meta = _run_bwd(cfg, b.tile_starts, b.counts, b.sorted_soa,
                           torch.ones_like(out), out, N)
    n_written, n_dropped = (int(x) for x in meta.tolist())
    return n_written, n_dropped, cfg.grad_cap
