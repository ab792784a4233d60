"""Tile binning for the CUDA rasterizer (counterpart of
``gaussian_splatting_tpu/ops/tiling.py``: the dense slot layout, sorted
flat or through the bucket partition).

Pipeline, for N screen-space gaussians and ``max_t`` slots each:

1. ``_tile_rects`` + ``_slot_tiles``: every gaussian owns ``max_t`` slots
   laid out (max_t, N); slot s holds the s-th tile of the gaussian's
   sheared window, or the sentinel T when the tile cap, the window or the
   exact ellipse/tile cull (the 1/255 alpha gate) rules it out. Gaussians
   with opacity below 1/255 are culled exactly.
2. One stable ``torch.sort`` of the int64 key ``(tile << 32) | depth bits``
   (depth bits in float total order, so ties resolve as ``lax.sort`` over
   the same (max_t, N) layout resolves them); sentinel slots sink to the end.
3. ``searchsorted`` gives the per-tile segment starts and counts.
4. ``pack_soa`` (CUDA kernel 1) builds the kernel-ready (16, >= M + pad)
   SoA by gathering the per-gaussian quantities through the sorted slot ->
   gaussian index.

``sort_buckets = B`` replaces step 2 (``_bucket_binned``): ``pack_rows``
(CUDA kernel 5) lays the slots out as (16, M) rows [tile, depth, mx, ...,
gid], the bucket partition (``ops/partition.py``, CUDA kernel 8) splits
them by ``tile % B`` into a (16, B, cap) layout with pad columns, and one
stable ``torch.sort(dim=1)`` of the same int64 key sorts every bucket.
Segments then have pad columns between them and ``tile_starts[T]`` is
``B * cap``, not a total: counts come per bucket, never as differences of
neighbouring starts. The pad columns of the SoA hold gaussian 0's rows
(``pack_soa`` gathers through their gid, 0) where the JAX package's hold
zeros; the kernels read no column outside a segment.

``chunk_queue`` builds the flat chunk work queue of the ``queue=True``
rasterizer kernels.

SoA row layout (16, M):
   0 mean_x | 1 mean_y | 2 conic_a | 3 conic_b | 4 conic_c | 5 opacity |
   6 r | 7 g | 8 b | 9 depth | 10 const-one | 11 gauss_id (exact f32) |
   12..15 zero

The gradient reduce of the backward pass lives here too
(``reduce_padded_grads``): one stable ``torch.sort`` of the masked gaussian
id key per slice of the backward kernel's stream, ``pack_rows`` (CUDA
kernel 5) gathering the payload rows through that sort's permutation, and
``segment_sum_sorted`` (``ops/segsum.py``, CUDA kernel 4).

Only the dense slot layout is ported; the compact footprint-class layout,
quantized depth keys and band-split sorts raise ``NotImplementedError``
naming their ROADMAP item.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gaussian_splatting_tpu_torch.ops import _build

# A gaussian with opacity below the per-pixel contribution gate can never
# contribute: alpha = op * exp(-sigma) <= op. Culling it in binning is exact.
OPACITY_CULL = 1.0 / 255.0

# Half-pixel slack (px) on sheared-window bounds: dwarfs float32 rounding
# differences between the window formulas and the per-tile cull test.
_WINDOW_EPS = 0.5

_PACK_C = 8192  # SoA width granule, as in the JAX pack kernel's blocks


def cdiv(a, b):
    return -(-a // b)


class TileBinning(NamedTuple):
    sorted_soa: torch.Tensor        # (16, >= M + 2*chunk) kernel-ready SoA
    tile_starts: torch.Tensor       # (T + 1,) int32 segment starts
    counts: torch.Tensor            # (T,) int32 real intersections per tile
    n_isect: torch.Tensor           # () total real intersections
    n_dropped: torch.Tensor         # () tiles lost to the max_t cap
    n_budget_dropped: torch.Tensor  # () tiles lost to class budgets (0 dense)
    n_bucket_dropped: torch.Tensor  # () tiles lost to bucket overflow (0 flat)


def class_caps(max_t: int) -> Tuple[int, ...]:
    """Footprint class caps 1,2,3,4,6,8,12,16,24,32,... up to max_t."""
    if max_t < 1 or (max_t & (max_t - 1)) != 0:
        raise ValueError("max_t must be a power of 2")
    caps = [c for c in (1, 2, 3, 4, 6) if c <= max_t]
    c = caps[-1]
    while c < max_t:
        c = c * 4 // 3 if c % 3 == 0 else c * 3 // 2
        caps.append(c)
    return tuple(caps)


def total_slots(n: int, max_t: int,
                class_budgets: Optional[Tuple[int, ...]]) -> int:
    """Static sort size M for a given binning mode."""
    if class_budgets is None:
        return n * max_t
    caps = class_caps(max_t)
    if len(class_budgets) != len(caps):
        raise ValueError(f"need {len(caps)} class budgets for max_t={max_t}, "
                         f"got {len(class_budgets)}")
    return int(sum(b * c for b, c in zip(class_budgets, caps)))


def exact_tile_counts(means2d, radii, width, height, ts,
                      conics=None, opacities=None,
                      row_lo: int = 0, row_hi: Optional[int] = None):
    """Host-side (numpy) per-gaussian slot counts: the exact footprint
    ``_tile_rects`` produces, for budget and cap measurement. With conics +
    opacities this mirrors the sheared-window count (ny * wt); without, the
    radius-bbox count. ``row_lo/row_hi`` clip to a band of tile rows."""
    m = np.asarray(means2d, np.float64)
    r = np.asarray(radii, np.float64)
    ntx = cdiv(width, ts)
    nty = cdiv(height, ts)
    lo = row_lo
    hi = nty if row_hi is None else row_hi
    if conics is None:
        tx0 = np.clip(np.floor((m[:, 0] - r) / ts), 0, ntx)
        tx1 = np.clip(np.ceil((m[:, 0] + r) / ts), 0, ntx)
        ty0 = np.clip(np.floor((m[:, 1] - r) / ts), lo, hi)
        ty1 = np.clip(np.ceil((m[:, 1] + r) / ts), lo, hi)
        nt = np.maximum(tx1 - tx0, 0) * np.maximum(ty1 - ty0, 0)
        return np.where(r > 0, nt, 0).astype(np.int64)
    c = np.asarray(conics, np.float64)
    op = np.asarray(opacities, np.float64)
    ca, cb, cc = c[:, 0], c[:, 1], c[:, 2]
    ca_s = np.maximum(ca, 1e-12)
    det_s = np.maximum(ca * cc - cb * cb, 1e-20)
    Q = 2.0 * (np.log(255.0 * np.maximum(op, 1e-12)) + 1e-3)
    xe = np.minimum(r, np.sqrt(np.maximum(Q, 0) * np.maximum(cc, 1e-12) / det_s)
                    + _WINDOW_EPS)
    ye = np.minimum(r, np.sqrt(np.maximum(Q, 0) * ca_s / det_s) + _WINDOW_EPS)
    tx0 = np.clip(np.floor((m[:, 0] - xe) / ts), 0, ntx)
    tx1 = np.clip(np.ceil((m[:, 0] + xe) / ts), 0, ntx)
    ty0 = np.clip(np.floor((m[:, 1] - ye) / ts), lo, hi)
    ty1 = np.clip(np.ceil((m[:, 1] + ye) / ts), lo, hi)
    nx = np.maximum(tx1 - tx0, 0)
    ny = np.maximum(ty1 - ty0, 0)
    w_px = (np.abs(cb) * ts + 2.0 * np.sqrt(np.maximum(Q, 0) * ca_s)) / ca_s \
        + 2.0 * _WINDOW_EPS
    wt = np.minimum(np.ceil(w_px / ts) + 1, nx)
    nt = ny * wt
    return np.where((r > 0) & (op >= OPACITY_CULL), nt, 0).astype(np.int64)


def _clip(x, lo, hi):
    """``jnp.clip`` semantics: min(hi, max(lo, x)), also when hi < lo."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _gate_q(opacities):
    """Contribution-gate Mahalanobis threshold: alpha = op*exp(-q/2) crosses
    1/255 at q = 2*ln(255*op) (+ the cull's float32 slack), clamped at 0."""
    return torch.clamp_min(
        2.0 * (torch.log(255.0 * torch.clamp_min(opacities, 1e-12)) + 1e-3), 0.0)


def _tile_rects(means2d, conics, opacities, radii, width, height, ts, max_t):
    """Sheared-window tile geometry per gaussian: ny rows of a constant-width
    window following the ellipse axis, inside the exact gate-ellipse AABB
    intersected with the radius bbox. Returns
    (ntx, nty, tx0, ty0, nx, wt, n_tiles, n_capped)."""
    ntx = cdiv(width, ts)
    nty = cdiv(height, ts)
    valid = (radii > 0) & (opacities >= OPACITY_CULL)
    r = radii.to(torch.float32)
    mx, my = means2d[:, 0], means2d[:, 1]
    ca, cb, cc = conics[:, 0], conics[:, 1], conics[:, 2]
    ca_s = torch.clamp_min(ca, 1e-12)
    det_s = torch.clamp_min(ca * cc - cb * cb, 1e-20)
    Q = _gate_q(opacities)
    xe = torch.minimum(r, torch.sqrt(Q * torch.clamp_min(cc, 1e-12) / det_s) + _WINDOW_EPS)
    ye = torch.minimum(r, torch.sqrt(Q * ca_s / det_s) + _WINDOW_EPS)
    tx0 = torch.clamp(torch.floor((mx - xe) / ts), 0, ntx).to(torch.int32)
    tx1 = torch.clamp(torch.ceil((mx + xe) / ts), 0, ntx).to(torch.int32)
    ty0 = torch.clamp(torch.floor((my - ye) / ts), 0, nty).to(torch.int32)
    ty1 = torch.clamp(torch.ceil((my + ye) / ts), 0, nty).to(torch.int32)
    zero = torch.zeros_like(tx0)
    nx = torch.where(valid, torch.clamp_min(tx1 - tx0, 0), zero)
    ny = torch.where(valid, torch.clamp_min(ty1 - ty0, 0), zero)
    w_px = (torch.abs(cb) * ts + 2.0 * torch.sqrt(Q * ca_s)) / ca_s + 2.0 * _WINDOW_EPS
    # min in float BEFORE the int cast: w_px can be huge for near-singular
    # conics.
    wt = torch.minimum(torch.ceil(w_px / ts) + 1.0, nx.to(torch.float32)).to(torch.int32)
    n_tiles = ny * wt
    n_capped = torch.clamp_max(n_tiles, max_t)
    return ntx, nty, tx0, ty0, nx, wt, n_tiles, n_capped


def _slot_tiles(tx0, ty0, nx, wt, n_capped, s, ntx, ts, sentinel, ellipse):
    """Tile id of slot ``s`` per gaussian (broadcasting), or ``sentinel``.

    Slot s -> (row r, column c) of the gaussian's ny x wt window; the row's
    base column is a conservative lower bound on the leftmost tile the gate
    ellipse touches in that row. A slot whose tile rect provably stays below
    the 1/255 gate is sentineled out: the exact minimum of the quadratic
    form over the rect (0 if the mean is inside, else the min over the four
    edges) is compared with the gate threshold. ``ellipse=(mx, my, ca, cb,
    cc, op)``."""
    mx, my, ca, cb, cc, op = ellipse
    fts = float(ts)
    wt_safe = torch.clamp_min(wt, 1)
    r = torch.div(s, wt_safe, rounding_mode="floor")
    c = s - r * wt_safe

    ca_s = torch.clamp_min(ca, 1e-12)
    cc_s = torch.clamp_min(cc, 1e-12)
    det = ca * cc - cb * cb
    Q = _gate_q(op)

    # Conservative leftmost kept x in the row band [dyl, dyl + ts].
    dyl = (ty0 + r).to(torch.float32) * fts - my
    dyc = dyl + 0.5 * fts
    dym = _clip(torch.zeros_like(dyl), dyl, dyl + fts)
    half_chord = torch.sqrt(torch.clamp_min(ca * Q - det * dym * dym, 0.0)) / ca_s
    dxlo = (-cb * dyc - 0.5 * torch.abs(cb) * fts) / ca_s - half_chord - _WINDOW_EPS
    txlo = torch.floor((mx + dxlo) / fts).to(torch.int32)
    base = _clip(txlo, tx0, tx0 + nx - wt_safe)

    tx = base + c
    ty = ty0 + r
    tid = ty * ntx + tx
    keep = s < n_capped

    # Exact conservative ellipse-tile cull over the slot's pixel rect.
    dxl_t = tx.to(torch.float32) * fts - mx
    dxh_t = dxl_t + fts
    dyl_t = ty.to(torch.float32) * fts - my
    dyh_t = dyl_t + fts

    def q(qx, qy):
        return ca * qx * qx + 2.0 * cb * qx * qy + cc * qy * qy

    def edge_x(qx):  # dx fixed at an x-edge; optimal dy clamped to the rect
        return q(qx, _clip(-cb * qx / cc_s, dyl_t, dyh_t))

    def edge_y(qy):
        return q(_clip(-cb * qy / ca_s, dxl_t, dxh_t), qy)

    q_min = torch.minimum(torch.minimum(edge_x(dxl_t), edge_x(dxh_t)),
                          torch.minimum(edge_y(dyl_t), edge_y(dyh_t)))
    inside = (dxl_t <= 0) & (dxh_t >= 0) & (dyl_t <= 0) & (dyh_t >= 0)
    q_min = torch.where(inside, torch.zeros_like(q_min), q_min)
    keep = keep & ~(q_min > Q)
    return torch.where(keep, tid, torch.full_like(tid, sentinel))


def _float_order_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [0, 2^32) whose integer order is the float total
    order (-0 < +0), the order ``lax.sort`` uses for float keys."""
    b = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    return torch.where(b >= 0, b + (1 << 31), (~b) & 0xFFFFFFFF)


def pack_soa_plain(table: torch.Tensor, gid: torch.Tensor, pad: int) -> torch.Tensor:
    """Plain PyTorch version of the ``pack_soa`` kernel: gather the (10, N)
    quantity rows through ``gid``, stack with the const-one and id rows and
    zero-pad to ``cdiv(M + pad, 8192) * 8192`` columns."""
    M = gid.shape[0]
    m_out = cdiv(M + pad, _PACK_C) * _PACK_C
    out = torch.zeros((16, m_out), dtype=torch.float32, device=table.device)
    out[:10, :M] = table[:, gid.long()]
    out[10, :M] = 1.0
    out[11, :M] = gid.to(torch.float32)
    return out


def _check_pack_args(table, gid):
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[0] != 10:
        raise ValueError(f"table must be (10, N) float32, got {tuple(table.shape)} {table.dtype}")
    if gid.dtype != torch.int32 or gid.dim() != 1:
        raise ValueError(f"gid must be (M,) int32, got {tuple(gid.shape)} {gid.dtype}")
    if table.device != gid.device:
        raise ValueError("table and gid must be on the same device")
    if not (table.is_contiguous() and gid.is_contiguous()):
        raise ValueError("table and gid must be contiguous")
    if table.shape[1] >= (1 << 24):
        raise ValueError("gaussian ids must be exact in float32 (N < 2^24)")


def pack_soa(table: torch.Tensor, gid: torch.Tensor, pad: int) -> torch.Tensor:
    """Kernel-ready (16, cdiv(M + pad, 8192) * 8192) SoA from the (10, N)
    per-gaussian rows [mx, my, ca, cb, cc, op, r, g, b, depth] and the
    depth-sorted slot -> gaussian index ``gid`` (M,) int32 in [0, N).
    Columns [0, M) equal the JAX ``pack_soa`` of the sorted rows; the pad is
    zero. CUDA tensors run the kernel (``csrc/pack_soa.cu``), CPU tensors
    the plain version."""
    _check_pack_args(table, gid)
    if table.device.type == "cpu":
        return pack_soa_plain(table, gid, pad)
    if table.device.type != "cuda":
        raise ValueError(f"pack_soa runs on CUDA or CPU tensors, not {table.device}")
    lib = _build.load("pack_soa")
    fn = lib.gs_pack_soa
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    N, M = table.shape[1], gid.shape[0]
    m_out = cdiv(M + pad, _PACK_C) * _PACK_C
    out = torch.empty((16, m_out), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        rc = fn(table.data_ptr(), gid.data_ptr(), out.data_ptr(), N, M, m_out,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pack_soa kernel launch failed: cudaError {rc}")
    pack_soa.launches += 1
    return out


pack_soa.launches = 0


def check_binning_mode(class_budgets=None, depth_bits: int = 0,
                       sort_buckets: int = 0, sort_bands: int = 0) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item of a binning
    mode the port does not have yet (the dense layout, sorted flat or
    through ``sort_buckets``, is ported)."""
    if class_budgets is not None:
        raise NotImplementedError(
            "compact class_budgets binning: ROADMAP queue 1, item 3")
    if depth_bits:
        raise NotImplementedError("depth_bits sort keys: ROADMAP queue 1, item 9")
    if sort_bands:
        raise NotImplementedError("sort_bands binning: ROADMAP queue 1, item 9")


def slot_tiles(means2d, conics, opacities, radii, width: int, height: int, tile_size: int,
               max_tiles_per_gaussian: int):
    """The dense slots' tiles: ``(tile_key (M,) int32, n_dropped, T)`` with
    slots laid out (max_t, N) (slot s * N + g is slot s of gaussian g), T
    on a sentinel slot, and the tiles lost to the max_t cap."""
    ts = tile_size
    ntx, nty, tx0, ty0, nx, wt, n_tiles, n_capped = _tile_rects(
        means2d, conics, opacities, radii, width, height, ts, max_tiles_per_gaussian)
    T = ntx * nty
    s = torch.arange(max_tiles_per_gaussian, dtype=torch.int32, device=means2d.device)[:, None]
    ell = (means2d[None, :, 0], means2d[None, :, 1], conics[None, :, 0],
           conics[None, :, 1], conics[None, :, 2], opacities[None, :])
    tile_key = _slot_tiles(
        tx0[None, :], ty0[None, :], nx[None, :], wt[None, :],
        n_capped[None, :], s, ntx, ts, T, ellipse=ell).reshape(-1)
    return tile_key, torch.sum(n_tiles - n_capped), T


def isect_and_sort(
    means2d: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    width: int,
    height: int,
    tile_size: int,
    chunk: int,
    max_tiles_per_gaussian: int = 16,
    class_budgets: Optional[Tuple[int, ...]] = None,
    depth_bits: int = 0,
    sort_buckets: int = 0,
    sort_bands: int = 0,
    bucket_headroom: float = 1.5,
) -> TileBinning:
    """Bin and depth-sort N screen-space gaussians into the kernel-ready
    SoA and per-tile segment tables (dense (max_t, N) slot layout). Not
    differentiable by itself.

    ``sort_buckets = B > 0`` (a power of two) sorts through the bucket
    partition by ``tile % B`` with ``bucket_headroom`` times the balanced
    share of each 512-slot chunk per bucket (``_bucket_binned``); bucket
    overflow is counted in ``n_bucket_dropped`` and left out of
    ``n_isect``."""
    check_binning_mode(class_budgets, depth_bits, sort_buckets, sort_bands)
    N = means2d.shape[0]
    if N >= (1 << 24):
        raise ValueError("gaussian ids must be exact in float32 (N < 2^24)")
    max_t = max_tiles_per_gaussian
    dev = means2d.device

    tile_key, n_dropped, T = slot_tiles(means2d, conics, opacities, radii, width, height,
                                        tile_size, max_t)
    n_isect = torch.sum(tile_key < T)
    zero = torch.zeros((), dtype=n_isect.dtype, device=dev)
    table = torch.stack([
        means2d[:, 0], means2d[:, 1], conics[:, 0], conics[:, 1], conics[:, 2],
        opacities, colors[:, 0], colors[:, 1], colors[:, 2], depths,
    ]).to(torch.float32).contiguous()
    if sort_buckets:
        return _bucket_binned(tile_key, table, T, chunk, int(sort_buckets),
                              float(bucket_headroom), n_isect,
                              n_dropped.to(n_isect.dtype), zero)

    depth_key = _float_order_bits(depths).expand(max_t, N).reshape(-1)
    key = (tile_key.to(torch.int64) << 32) | depth_key
    key_sorted, order = torch.sort(key, stable=True)
    tile_sorted = key_sorted >> 32
    query = torch.arange(T + 1, dtype=torch.int64, device=dev)
    tile_starts = torch.searchsorted(tile_sorted, query).to(torch.int32)
    counts = tile_starts[1:] - tile_starts[:-1]

    gid = torch.remainder(order, N).to(torch.int32)
    soa = pack_soa(table, gid, pad=2 * chunk)
    return TileBinning(sorted_soa=soa, tile_starts=tile_starts, counts=counts,
                       n_isect=n_isect, n_dropped=n_dropped.to(n_isect.dtype),
                       n_budget_dropped=zero, n_bucket_dropped=zero)


BUCKET_C = 512  # slots per partition chunk, as in the JAX bucket binning


def bucket_partition_input(tile_key: torch.Tensor, table: torch.Tensor, T: int) -> torch.Tensor:
    """The bucket partition's (16, M') input, gathered by ``pack_rows``
    from a (16, N) per-gaussian table through slot -> gaussian: row 0 each
    slot's tile (``slot_tiles``; exact float, T on every pad column), rows
    1-11 depth, mx, my, ca, cb, cc, op, r, g, b, gid, rows 12-15 zero.
    ``table`` is the (10, N) quantity table [mx, my, ca, cb, cc, op, r, g,
    b, depth]."""
    dev = tile_key.device
    N = table.shape[1]
    src = torch.zeros((16, N), dtype=torch.float32, device=dev)
    src[1] = table[9]
    src[2:11] = table[:9]
    src[11] = torch.arange(N, dtype=torch.float32, device=dev)
    perm = torch.remainder(torch.arange(tile_key.shape[0], device=dev), N)
    n_valid = torch.full((1,), N, dtype=torch.int32, device=dev)
    return pack_rows(src, perm, tile_key.to(torch.int32), n_valid, 0, 12, float(T),
                     perm_bound=N)


def _bucket_binned(tile_key, table, T, chunk, B, headroom, n_isect, n_dropped, zero):
    """Partition-then-batched-sort binning (``tiling.py:787-859`` of the
    JAX package). The partition discards sentinel slots (``drop_key_above
    = T``) and keeps each bucket stable in slot order, so one stable sort
    per bucket of the dense path's int64 key gives each tile the dense
    path's order; tile t = j B + k is segment j of bucket k."""
    from gaussian_splatting_tpu_torch.ops.partition import partition_soa, quantum_for

    dev = tile_key.device
    packed = bucket_partition_input(tile_key, table, T)
    q = quantum_for(BUCKET_C, B, headroom)
    cap = (packed.shape[1] // BUCKET_C) * q
    out, _, drops = partition_soa(packed, B, q, key_row=0, sentinel=float(T),
                                  C=BUCKET_C, drop_key_above=float(T))
    del packed

    key = (out[0].to(torch.int64) << 32) | _float_order_bits(out[1])     # (B, cap)
    key_sorted, order = torch.sort(key, dim=1, stable=True)
    gid = torch.gather(out[11], 1, order).to(torch.int32).reshape(-1)
    del out, key, order

    # Per-bucket segments: bucket k holds tiles k, k + B, ...; the last
    # query, T, lands at the bucket's pad run.
    Tq = cdiv(T, B)
    karr = torch.arange(B, device=dev)[:, None]
    queries = torch.clamp_max(karr + torch.arange(Tq + 1, device=dev)[None, :] * B, T)
    ss = torch.searchsorted(key_sorted >> 32, queries.contiguous())       # (B, Tq + 1)
    starts_g = ss[:, :-1] + karr * cap
    counts_g = ss[:, 1:] - ss[:, :-1]
    tile_starts = torch.cat([starts_g.T.reshape(-1)[:T],
                             torch.full((1,), B * cap, device=dev, dtype=ss.dtype)])
    counts = counts_g.T.reshape(-1)[:T]
    soa = pack_soa(table, gid, pad=2 * chunk)
    n_bucket_dropped = drops.sum().to(n_isect.dtype)
    return TileBinning(sorted_soa=soa, tile_starts=tile_starts.to(torch.int32),
                       counts=counts.to(torch.int32), n_isect=n_isect - n_bucket_dropped,
                       n_dropped=n_dropped, n_budget_dropped=zero,
                       n_bucket_dropped=n_bucket_dropped)


def chunk_queue(counts: torch.Tensor, chunk: int, w_cap: int):
    """The flat chunk work queue of the ``queue=True`` kernels
    (``tiling.py:862-890`` of the JAX package). Returns ``(wtile (w_cap,)
    int32, cum (T+1,) int32, n_work () int32)``: work item w < n_work is
    chunk ``w - cum[wtile[w]]`` of tile ``wtile[w]``, tile-major; ``cum``
    is the exclusive prefix of the per-tile chunk counts; the pad tail past
    ``n_work`` clamps to T - 1. ``w_cap`` must bound the total chunks.
    Empty tiles never enter the queue."""
    T = counts.shape[0]
    dev = counts.device
    chunks_per_tile = torch.div(counts + (chunk - 1), chunk, rounding_mode="floor")
    cum = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                     torch.cumsum(chunks_per_tile, 0).to(torch.int32)])
    w = torch.arange(w_cap, dtype=torch.int32, device=dev)
    wtile = torch.searchsorted(cum[1:], w, right=True).to(torch.int32)
    return torch.clamp_max(wtile, T - 1), cum, cum[T]


def pack_rows_plain(src: torch.Tensor, perm: torch.Tensor, key_sorted: torch.Tensor,
                    n_valid: torch.Tensor, col0: int, n_rows: int,
                    sentinel: float) -> torch.Tensor:
    """Plain PyTorch version of the ``pack_rows`` kernel (arguments as
    there)."""
    M = perm.shape[0]
    m_out = cdiv(M, _PACK_C) * _PACK_C
    out = torch.zeros((16, m_out), dtype=torch.float32, device=src.device)
    out[0] = sentinel
    out[0, :M] = key_sorted.to(torch.float32)
    cols = col0 + perm
    ok = cols < n_valid.reshape(())
    out[1:n_rows, :M] = torch.where(ok, src[1:n_rows, cols], 0.0)
    return out


def _check_pack_rows_args(src, perm, key_sorted, n_valid, col0, n_rows, perm_bound):
    if src.dtype != torch.float32 or src.dim() != 2 or src.shape[0] != 16:
        raise ValueError(f"src must be (16, C) float32, got {tuple(src.shape)} {src.dtype}")
    M = perm.shape[0]
    if perm.dtype != torch.int64 or perm.dim() != 1:
        raise ValueError("perm must be (M,) int64")
    if key_sorted.dtype != torch.int32 or tuple(key_sorted.shape) != (M,):
        raise ValueError(f"key_sorted must be ({M},) int32")
    if n_valid.dtype != torch.int32 or n_valid.numel() != 1:
        raise ValueError("n_valid must be a one-element int32 tensor")
    if not (src.device == perm.device == key_sorted.device == n_valid.device):
        raise ValueError("src, perm, key_sorted and n_valid must be on one device")
    if not (src.is_contiguous() and perm.is_contiguous() and key_sorted.is_contiguous()):
        raise ValueError("src, perm and key_sorted must be contiguous")
    if not 1 <= n_rows <= 16:
        raise ValueError("n_rows must be in [1, 16]")
    bound = M if perm_bound is None else perm_bound
    if not 0 <= col0 <= src.shape[1] - bound:
        raise ValueError("the columns [col0, col0 + perm_bound) must lie inside src")


def pack_rows(src: torch.Tensor, perm: torch.Tensor, key_sorted: torch.Tensor,
              n_valid: torch.Tensor, col0: int, n_rows: int,
              sentinel: float, perm_bound: Optional[int] = None) -> torch.Tensor:
    """The segsum-ready (16, cdiv(M, 8192) * 8192) buffer of the slice
    [col0, col0 + M) of a (16, C) stream in key order: row 0 the ascending
    int32 ``key_sorted`` as exact floats (``sentinel`` past M), rows
    1..n_rows-1 the stream's rows gathered through ``perm`` (the sort's
    permutation, slice-local) where ``col0 + perm < n_valid`` and 0
    elsewhere, rows n_rows..15 zero. Equal to the JAX ``pack_rows`` of the
    permuted, masked rows. ``perm``'s values lie in [0, ``perm_bound``)
    (default M, a permutation of the slice). The bucket binning passes a
    gather instead: M slots from N < M gaussian columns, row 0 the slots'
    tiles in slot order (not ascending there). CUDA tensors run the kernel
    (``csrc/pack_rows.cu``), CPU tensors the plain version."""
    _check_pack_rows_args(src, perm, key_sorted, n_valid, col0, n_rows, perm_bound)
    if src.device.type == "cpu":
        return pack_rows_plain(src, perm, key_sorted, n_valid, col0, n_rows, sentinel)
    if src.device.type != "cuda":
        raise ValueError(f"pack_rows runs on CUDA or CPU tensors, not {src.device}")
    fn = _build.load("pack_rows").gs_pack_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    M = perm.shape[0]
    m_out = cdiv(M, _PACK_C) * _PACK_C
    out = torch.empty((16, m_out), dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), src.shape[1], perm.data_ptr(), key_sorted.data_ptr(),
                n_valid.data_ptr(), col0, M, m_out, n_rows, sentinel, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pack_rows kernel launch failed: cudaError {rc}")
    pack_rows.launches += 1
    return out


pack_rows.launches = 0

def sorted_gid_key(grad_soa: torch.Tensor, n_gaussians: int, n_valid: torch.Tensor,
                   col0: int, m: int):
    """The reduce's sort of the stream slice [col0, col0 + m): the int32 key
    ``where(pos < n_valid, gaussian id, n_gaussians)``, stably sorted, and
    its slice-local permutation (int64)."""
    pos = torch.arange(col0, col0 + m, device=grad_soa.device)
    key = torch.where(pos < n_valid.reshape(1), grad_soa[0, col0:col0 + m].to(torch.int32),
                      torch.full_like(pos, n_gaussians, dtype=torch.int32))
    return torch.sort(key, stable=True)


GRAD_KEYS = ("dmx", "dmy", "dca", "dcb", "dcc", "dop", "dr", "dg", "db", "ddepth")


def reduce_padded_grads(grad_soa: torch.Tensor, n_gaussians: int,
                        n_written: torch.Tensor, with_depth: bool = True,
                        sort_slices: int = 0) -> dict:
    """Per-gaussian sums of the backward kernel's gradient stream
    (``tiling.py:893-951`` of the JAX package).

    ``grad_soa`` (16, pcap): row 0 the gaussian id of each entry (exact
    float), rows 1..10 [dmx, dmy, dA, dB, dC, dop, dr, dg, db, ddepth];
    entries at or past ``n_written`` (a one-element int32 tensor) are not
    read. Returns a dict of (N,) float32 tensors keyed ``GRAD_KEYS``.

    Each of K = ``max(sort_slices, 1)`` contiguous slices (one when pcap is
    not divisible by K) is reduced on its own and the K (16, N) sums added:
    one stable ``torch.sort`` of the int32 key ``where(pos < n_written, id,
    N)``, ``pack_rows`` through its permutation, ``segment_sum_sorted``.
    ``with_depth=False`` leaves the ddepth payload out and returns zero
    ddepth (valid when the depth output has no cotangent)."""
    from gaussian_splatting_tpu_torch.ops.segsum import segment_sum_sorted

    N = n_gaussians
    pcap = grad_soa.shape[1]
    n_rows = 11 if with_depth else 10
    K = max(int(sort_slices), 1)
    if pcap % K != 0:
        K = 1
    m = pcap // K
    n_valid = n_written.reshape(1).to(torch.int32)
    sums = None
    for i in range(K):
        key_sorted, perm = sorted_gid_key(grad_soa, N, n_valid, i * m, m)
        stacked = pack_rows(grad_soa, perm, key_sorted, n_valid, i * m, n_rows, float(N))
        part = segment_sum_sorted(stacked, N)
        sums = part if sums is None else sums + part
    out = {k: sums[1 + j] for j, k in enumerate(GRAD_KEYS[:9])}
    out["ddepth"] = (sums[10] if with_depth
                     else torch.zeros((N,), dtype=torch.float32, device=grad_soa.device))
    return out
