"""Tile binning for the CUDA rasterizer (counterpart of
``gaussian_splatting_tpu/ops/tiling.py``: the dense and the compact slot
layouts, sorted flat or through the bucket partition).

Pipeline, for N screen-space gaussians and ``max_t`` slots each:

1. ``_tile_rects`` + ``_slot_tiles``: slot s of a gaussian holds the s-th
   tile of its sheared window, or the sentinel T when the tile cap, the
   window or the exact ellipse/tile cull (the 1/255 alpha gate) rules it
   out. Gaussians with opacity below 1/255 are culled exactly. Two slot
   layouts (``binning_slots``, the plain version of ``bin_slots``):
   - dense: every gaussian owns ``max_t`` slots laid out (max_t, N), slot
     ``s * N + g`` holding slot s of gaussian g;
   - compact (``class_budgets``, ``compact_slots``): gaussians are grouped
     into footprint classes (caps 1, 2, 3, 4, 6, ... ``max_t``,
     ``class_caps``) by one stable N-sized sort, and class c expands its
     first ``class_budgets[c]`` gaussians into a (cap_c, budget_c) block, so
     the sort holds ``total_slots`` slots instead of N * max_t. The tiles
     of gaussians past their class's budget are counted in
     ``n_budget_dropped``. Each slot's gaussian is kept in an (M,) array.
   On CUDA tensors ``bin_slots`` runs the kernel pair of
   ``csrc/bin_slots.cu`` instead, one pass over the gaussians and one over
   the slots, and writes each slot's sort key (and on the compact layout
   its gaussian) straight out, bit for bit the plain code's.
2. One stable ``torch.sort`` of the int64 key ``(tile << 32) | depth bits``
   (depth bits in float total order, so ties resolve as ``lax.sort`` over
   the same slot layout resolves them); sentinel slots sink to the end.
   ``depth_bits = b > 0`` sorts the int32 key ``tile * 2^b + quantized
   depth`` instead (``slot_sort_key``): depths quantized to 2^b - 1 levels
   over the real slots' range, so only the blend order of nearly equal
   depths changes.
3. ``searchsorted`` gives the per-tile segment starts and counts.
4. ``pack_soa`` (CUDA kernel 1) builds the kernel-ready (16, >= M + pad)
   SoA by gathering the (N, 10) per-gaussian records through the sorted
   slot -> gaussian index. The sentinel slots sort past ``tile_starts[T] =
   n_isect`` and no kernel reads them, so the dense SoA is zero from column
   ``n_isect`` on (``pack_soa(n_live=tile_starts[T:])``).

``sort_buckets = B`` replaces step 2 (``_bucket_binned``): the bucket
partition (``ops/partition.bucket_partition``, CUDA kernel 8) reads the
slots' tiles (and on the compact layout their gaussians) and the depths,
splits the slots by ``tile % B`` into a (B,
cap) layout with pad columns and writes each column's int64 key and
gaussian id, and one stable ``torch.sort(dim=1)`` of that key sorts every
bucket.
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

``sort_bands = K > 1`` (``_band_binned``) enumerates and sorts K
horizontal bands of tile rows on their own and concatenates the K sorted
streams: each band's sentinel slots sit at its tail, inside the stream,
and ``tile_starts[T]`` is the stream length. The dense SoA's zeroing past
n_isect does not apply there; no kernel reads a column outside a segment.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gaussian_splatting_tpu_torch.ops import _build
from gaussian_splatting_tpu_torch.utils import profiling

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


def squeeze_budgets_under_pow2(budgets, hard_min, caps, align: int = 128,
                               max_trim: float = 0.10) -> Tuple[int, ...]:
    """If trimming at most ``max_trim`` of the total slot count gets the
    sort under the next-lower power of two, trim the headroom (never below
    ``hard_min``, the measured per-class population), largest classes
    first, an alignment step at a time; otherwise return the budgets
    unchanged (``tiling.py:99-136`` of the JAX package)."""
    budgets = [int(b) for b in budgets]
    hard_min = [int(h) for h in hard_min]
    s = sum(b * int(c) for b, c in zip(budgets, caps))
    if s <= 0:
        return tuple(budgets)
    p2lo = 1 << (s.bit_length() - 1)
    if s == p2lo:
        return tuple(budgets)
    s_hard = sum(h * int(c) for h, c in zip(hard_min, caps))
    if s_hard > p2lo or s - p2lo > max_trim * s:
        return tuple(budgets)
    f = p2lo / s
    out = [min(max(h, int(b * f) // align * align), b) for b, h in zip(budgets, hard_min)]
    total = sum(t * int(c) for t, c in zip(out, caps))
    order = sorted(range(len(out)), key=lambda i: -out[i] * int(caps[i]))
    gi = 0
    while total > p2lo and gi < 10 * len(out):
        i = order[gi % len(out)]
        if out[i] - align >= hard_min[i]:
            out[i] -= align
            total -= align * int(caps[i])
        gi += 1
    if total > p2lo:
        return tuple(budgets)
    return tuple(out)


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


def _tile_rects(means2d, conics, opacities, radii, width, height, ts, max_t,
                row_lo: int = 0, row_hi: Optional[int] = None):
    """Sheared-window tile geometry per gaussian: ny rows of a constant-width
    window following the ellipse axis, inside the exact gate-ellipse AABB
    intersected with the radius bbox, its rows clipped to the band
    [row_lo, row_hi) (the whole grid by default). Returns
    (ntx, nty, tx0, ty0, nx, wt, n_tiles, n_capped)."""
    ntx = cdiv(width, ts)
    nty = cdiv(height, ts)
    row_hi = nty if row_hi is None else row_hi
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
    ty0 = torch.clamp(torch.floor((my - ye) / ts), row_lo, row_hi).to(torch.int32)
    ty1 = torch.clamp(torch.ceil((my + ye) / ts), row_lo, row_hi).to(torch.int32)
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


def quantity_records(means2d, conics, colors, opacities, depths) -> torch.Tensor:
    """The (N, 10) float32 record table ``pack_soa`` gathers: one row per
    gaussian, [mx, my, ca, cb, cc, op, r, g, b, depth]."""
    return torch.stack([
        means2d[:, 0], means2d[:, 1], conics[:, 0], conics[:, 1], conics[:, 2],
        opacities, colors[:, 0], colors[:, 1], colors[:, 2], depths,
    ], dim=1).to(torch.float32).contiguous()


def pack_soa_plain(records: torch.Tensor, gid: torch.Tensor, pad: int,
                   n_live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the ``pack_soa`` kernel: gather the (N, 10)
    records through ``gid``, stack with the const-one and id rows, zero-pad
    to ``cdiv(M + pad, 8192) * 8192`` columns and zero the columns from
    ``n_live`` on (a mask, no host read)."""
    M = gid.shape[0]
    m_out = cdiv(M + pad, _PACK_C) * _PACK_C
    out = torch.zeros((16, m_out), dtype=torch.float32, device=records.device)
    out[:10, :M] = records[gid.long()].T
    out[10, :M] = 1.0
    out[11, :M] = gid.to(torch.float32)
    if n_live is not None:
        live = torch.arange(m_out, device=out.device) < n_live.reshape(1)
        out = torch.where(live, out, 0.0)
    return out


def _check_pack_args(records, gid, n_live):
    if records.dtype != torch.float32 or records.dim() != 2 or records.shape[1] != 10:
        raise ValueError(f"records must be (N, 10) float32, got {tuple(records.shape)} "
                         f"{records.dtype}")
    if gid.dtype != torch.int32 or gid.dim() != 1:
        raise ValueError(f"gid must be (M,) int32, got {tuple(gid.shape)} {gid.dtype}")
    if records.device != gid.device:
        raise ValueError("records and gid must be on the same device")
    if not (records.is_contiguous() and gid.is_contiguous()):
        raise ValueError("records and gid must be contiguous")
    if records.shape[0] >= (1 << 24):
        raise ValueError("gaussian ids must be exact in float32 (N < 2^24)")
    if n_live is not None and (n_live.dtype != torch.int32 or n_live.numel() != 1
                               or n_live.device != gid.device):
        raise ValueError("n_live must be a one-element int32 tensor on gid's device")


def pack_soa(records: torch.Tensor, gid: torch.Tensor, pad: int,
             n_live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel-ready (16, cdiv(M + pad, 8192) * 8192) SoA from the (N, 10)
    per-gaussian records [mx, my, ca, cb, cc, op, r, g, b, depth]
    (``quantity_records``) and the depth-sorted slot -> gaussian index
    ``gid`` (M,) int32 in [0, N). Columns [0, M) equal the JAX ``pack_soa``
    of the sorted rows; the pad is zero. ``n_live``, a one-element int32
    tensor on the device, zeroes the columns from it on as well, and the
    kernel reads no id there. CUDA tensors run the kernel
    (``csrc/pack_soa.cu``), CPU tensors the plain version."""
    _check_pack_args(records, gid, n_live)
    if records.device.type == "cpu":
        return pack_soa_plain(records, gid, pad, n_live)
    if records.device.type != "cuda":
        raise ValueError(f"pack_soa runs on CUDA or CPU tensors, not {records.device}")
    if records.data_ptr() % 8:
        raise ValueError("records must be 8-byte aligned (the kernel loads float2)")
    fn = _build.load("pack_soa").gs_pack_soa
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    M = gid.shape[0]
    m_out = cdiv(M + pad, _PACK_C) * _PACK_C
    out = torch.empty((16, m_out), dtype=torch.float32, device=records.device)
    with torch.cuda.device(records.device):
        rc = fn(records.data_ptr(), gid.data_ptr(),
                None if n_live is None else n_live.data_ptr(), out.data_ptr(), M, m_out,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pack_soa kernel launch failed: cudaError {rc}")
    profiling.count("launch.pack_soa")
    return out



@functools.lru_cache(maxsize=4)
def _compact_layout(budgets: Tuple[int, ...], max_t: int, device: torch.device):
    """The static part of the compact layout, on ``device``, built once per
    (budgets, max_t): the class caps, the budgets with a 0 for the virtual
    class L, and per slot p of the concatenated (cap_c, budget_c) blocks its
    class, its slot s in [0, cap_c) and its rank j in [0, budget_c)."""
    caps = class_caps(max_t)
    parts = [(np.full(cap * nc, c), np.repeat(np.arange(cap), nc), np.tile(np.arange(nc), cap))
             for c, (cap, nc) in enumerate(zip(caps, budgets)) if nc > 0]
    if parts:
        cls, slot, rank = (np.concatenate(a) for a in zip(*parts))
    else:
        cls = slot = rank = np.zeros(0, np.int64)
    return (torch.tensor(caps, dtype=torch.int32, device=device),
            torch.tensor(budgets + (0,), dtype=torch.int64, device=device),
            torch.as_tensor(cls, dtype=torch.int64, device=device),
            torch.as_tensor(slot, dtype=torch.int32, device=device),
            torch.as_tensor(rank, dtype=torch.int64, device=device))


def compact_slots(tx0, ty0, nx, wt, n_capped, ellipse, ntx: int, ts: int, T: int,
                  max_t: int, class_budgets):
    """The compact footprint-class slots (``tiling.py:608-699`` of the JAX
    package) of the per-gaussian window geometry of ``_tile_rects``.

    Class c holds the gaussians whose capped tile count is at most
    ``class_caps(max_t)[c]`` and above the previous cap; empty gaussians
    fall in a virtual class L that gets no slots. One stable sort by class
    (the order ``lax.sort`` gives, which decides who falls over a budget),
    then class c expands the first ``class_budgets[c]`` of its gaussians
    into a (cap_c, budget_c) block, the blocks concatenated in class order:
    slot ``offset_c + s * budget_c + j`` holds slot s of the class's j-th
    gaussian. The per-class starts stay on the device, and the slots are
    enumerated in one pass over the static layout (``_compact_layout``), so
    a binning reads nothing back to the host. Returns ``(tile_key (M,)
    int32, slot_gid (M,) int32, n_budget_dropped)`` with M =
    ``total_slots``; ``n_budget_dropped`` counts the capped tiles of the
    gaussians past their class's budget."""
    caps = class_caps(max_t)
    L = len(caps)
    budgets = tuple(int(b) for b in class_budgets)
    if len(budgets) != L:
        raise ValueError(f"need {L} class budgets for max_t={max_t}, got {len(budgets)}")
    if min(budgets) < 0:
        raise ValueError("class budgets must be non-negative")
    dev = n_capped.device
    N = n_capped.shape[0]
    caps_t, budgets_t, p_cls, p_slot, p_rank = _compact_layout(budgets, max_t, dev)
    cls = torch.sum(n_capped[:, None] > caps_t[None, :], dim=1)
    cls = torch.where(n_capped > 0, cls, torch.full_like(cls, L))
    cls_s, perm = torch.sort(cls, stable=True)
    # Class populations by an integer scatter (a CUDA bincount reads its
    # input's maximum back to the host).
    counts = torch.zeros((L + 1,), dtype=torch.int64, device=dev).index_add_(
        0, cls, torch.ones_like(cls))
    starts = torch.cumsum(counts, 0) - counts

    # Gaussians past their class's budget lose their (capped) tiles.
    rank = torch.arange(N, device=dev) - starts[cls_s]
    over = (rank >= budgets_t[cls_s]) & (cls_s < L)
    ncap_s = n_capped[perm]
    n_budget_dropped = torch.sum(torch.where(over, ncap_s, torch.zeros_like(ncap_s)))

    # Ranks past N (a class's window running off the end) read gaussian 0
    # and, being outside the class, get no tile, as the JAX package's zero
    # padding does.
    perm_p = torch.cat([perm, perm.new_zeros(max(max(budgets), 1))])
    g = perm_p[starts[p_cls] + p_rank]
    in_class = p_rank < torch.minimum(counts, budgets_t)[p_cls]
    ncap = torch.where(in_class, n_capped[g], torch.zeros_like(p_slot))
    tile_key = _slot_tiles(tx0[g], ty0[g], nx[g], wt[g], ncap, p_slot, ntx, ts, T,
                           ellipse=tuple(e[g] for e in ellipse))
    return tile_key, g.to(torch.int32), n_budget_dropped


def binning_slots(means2d, conics, opacities, radii, width: int, height: int, tile_size: int,
                  max_tiles_per_gaussian: int, class_budgets=None, row_lo: int = 0,
                  row_hi: Optional[int] = None):
    """The slots' tiles: ``(tile_key (M,) int32, slot_gid, n_dropped,
    n_budget_dropped, T)``, T on a sentinel slot, with the tiles lost to the
    max_t cap and to the class budgets. Dense layout (``class_budgets``
    None): slots laid out (max_t, N), slot s * N + g being slot s of
    gaussian g, ``slot_gid`` None (the gaussian is the slot mod N) and no
    budget drop. Compact layout: ``compact_slots``, ``slot_gid`` the (M,)
    int32 gaussian of each slot. ``row_lo/row_hi`` enumerate only the
    footprints' tile rows in [row_lo, row_hi) (one band of ``sort_bands``,
    ``tiling.py:569-581`` of the JAX package); the counters then count
    that band."""
    ts = tile_size
    max_t = max_tiles_per_gaussian
    ntx, nty, tx0, ty0, nx, wt, n_tiles, n_capped = _tile_rects(
        means2d, conics, opacities, radii, width, height, ts, max_t, row_lo, row_hi)
    T = ntx * nty
    n_dropped = torch.sum(n_tiles - n_capped)
    ell = (means2d[:, 0], means2d[:, 1], conics[:, 0], conics[:, 1], conics[:, 2], opacities)
    if class_budgets is not None:
        tile_key, slot_gid, n_budget_dropped = compact_slots(
            tx0, ty0, nx, wt, n_capped, ell, ntx, ts, T, max_t, class_budgets)
        return tile_key, slot_gid, n_dropped, n_budget_dropped, T
    s = torch.arange(max_t, dtype=torch.int32, device=means2d.device)[:, None]
    tile_key = _slot_tiles(
        tx0[None, :], ty0[None, :], nx[None, :], wt[None, :],
        n_capped[None, :], s, ntx, ts, T, ellipse=tuple(e[None, :] for e in ell)).reshape(-1)
    return tile_key, None, n_dropped, torch.zeros_like(n_dropped), T


class Slots(NamedTuple):
    """The binning's slots (``bin_slots``)."""
    key: torch.Tensor                 # (M,) int64 exact sort key, or int32 tile (T: sentinel)
    slot_gid: Optional[torch.Tensor]  # (M,) int32 gaussian of each slot; None dense (slot % N)
    n_isect: torch.Tensor             # () int64 slots with a tile
    n_dropped: torch.Tensor           # () int64 tiles lost to the max_t cap
    n_budget_dropped: torch.Tensor    # () int64 tiles lost to the class budgets (0 dense)
    T: int


def bin_slots_plain(means2d, conics, opacities, radii, depths, width: int, height: int,
                    tile_size: int, max_t: int, class_budgets=None, row_lo: int = 0,
                    row_hi: Optional[int] = None, depth_bits: Optional[int] = None) -> Slots:
    """Plain PyTorch version of the ``bin_slots`` kernel pair (arguments as
    there): ``binning_slots``, the real slots counted, and the exact key of
    ``slot_sort_key`` unless ``depth_bits`` asks for the int32 tile."""
    tile_key, slot_gid, n_dropped, n_budget_dropped, T = binning_slots(
        means2d, conics, opacities, radii, width, height, tile_size, max_t, class_budgets,
        row_lo, row_hi)
    n_isect = torch.sum(tile_key < T)
    key = tile_key if depth_bits is not None else slot_sort_key(tile_key, depths, T,
                                                                slot_gid)[0]
    return Slots(key, slot_gid, n_isect, n_dropped.to(n_isect.dtype),
                 n_budget_dropped.to(n_isect.dtype), T)


def _check_bin_slots_args(means2d, conics, opacities, radii, depths, T, max_t,
                          class_budgets, depth_bits):
    n = means2d.shape[0]
    for name, x, shape, dtype in (("means2d", means2d, (n, 2), torch.float32),
                                  ("conics", conics, (n, 3), torch.float32),
                                  ("opacities", opacities, (n,), torch.float32),
                                  ("radii", radii, (n,), torch.int32),
                                  ("depths", depths, (n,), torch.float32)):
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(x.shape)} {x.dtype}")
        if x.device != means2d.device:
            raise ValueError(f"{name} is on {x.device}, means2d on {means2d.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n >= (1 << 24):
        raise ValueError("gaussian ids must be exact in float32 (N < 2^24)")
    if class_budgets is not None:
        total_slots(n, max_t, class_budgets)
        if min(int(b) for b in class_budgets) < 0:
            raise ValueError("class budgets must be non-negative")
    if depth_bits is not None and not (T + 1) < (1 << (31 - int(depth_bits))):
        raise ValueError(f"tile grid of {T} tiles too large for a {depth_bits}-bit depth in "
                         f"an int32 sort key")


def bin_slots(means2d, conics, opacities, radii, depths, width: int, height: int,
              tile_size: int, max_t: int, class_budgets=None, row_lo: int = 0,
              row_hi: Optional[int] = None, depth_bits: Optional[int] = None) -> Slots:
    """The binning's slots with their sort key, on the layout and in the
    band ``binning_slots`` takes: ``Slots(key, slot_gid, n_isect,
    n_dropped, n_budget_dropped, T)``. ``depth_bits`` None writes the flat
    path's exact int64 key ``(tile << 32) | order_bits(depth)``; an int b
    writes each slot's int32 tile, for the bucket partition (b = 0) or the
    b-bit quantized key (``slot_sort_key``), and needs (T + 1) < 2^(31 - b).
    means2d (N, 2), conics (N, 3), opacities, depths (N,) float32 and
    radii (N,) int32, contiguous, on one device. CUDA tensors run the
    kernel pair (``csrc/bin_slots.cu``), bit for bit the plain version's
    outputs; CPU tensors the plain version."""
    ntx, nty = cdiv(width, tile_size), cdiv(height, tile_size)
    _check_bin_slots_args(means2d, conics, opacities, radii, depths, ntx * nty, max_t,
                          class_budgets, depth_bits)
    args = (means2d, conics, opacities, radii, depths, width, height, tile_size, max_t,
            class_budgets, row_lo, row_hi, depth_bits)
    if means2d.device.type == "cpu":
        return bin_slots_plain(*args)
    if means2d.device.type != "cuda":
        raise ValueError(f"bin_slots runs on CUDA or CPU tensors, not {means2d.device}")
    return _bin_slots_cuda(*args)


def _bin_slots_cuda(means2d, conics, opacities, radii, depths, width, height, ts, max_t,
                    class_budgets, row_lo, row_hi, depth_bits) -> Slots:
    """``bin_slots`` on the card: ``gs_bin_rects``, on the compact layout
    the stable class order (one ``torch.sort`` of the (N,) uint8 classes),
    then ``gs_bin_slots``; the three counters are views of the kernels'
    int64 stats."""
    lib = _build.load("bin_slots")
    lib.gs_bin_rects.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_void_p] * 4 + [ctypes.c_void_p])
    lib.gs_bin_slots.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4)
    lib.gs_bin_rects.restype = lib.gs_bin_slots.restype = ctypes.c_int
    dev = means2d.device
    N = means2d.shape[0]
    ntx, nty = cdiv(width, ts), cdiv(height, ts)
    T = ntx * nty
    row_hi = nty if row_hi is None else row_hi
    caps = () if class_budgets is None else class_caps(max_t)
    budgets = () if class_budgets is None else tuple(int(b) for b in class_budgets)
    L = len(caps)
    if L > 32:
        raise ValueError(f"the kernel takes at most 32 footprint classes, max_t={max_t} has {L}")
    caps_c = (ctypes.c_int * max(L, 1))(*caps)
    budgets_c = (ctypes.c_longlong * max(L, 1))(*budgets)
    stats = torch.empty((4 + L,), dtype=torch.int64, device=dev)
    rect = torch.empty((N, 12), dtype=torch.int32, device=dev)
    cls = torch.empty((N,), dtype=torch.uint8, device=dev) if L else None
    M = total_slots(N, max_t, class_budgets)
    key = torch.empty((M,), dtype=torch.int64 if depth_bits is None else torch.int32,
                      device=dev)
    slot_gid = torch.empty((M,), dtype=torch.int32, device=dev) if L else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gs_bin_rects(N, means2d.data_ptr(), conics.data_ptr(), opacities.data_ptr(),
                              radii.data_ptr(), depths.data_ptr(), ntx, ts, row_lo, row_hi,
                              max_t, L, caps_c, rect.data_ptr(),
                              None if cls is None else cls.data_ptr(), stats.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"bin_slots gaussian pass launch failed: cudaError {rc}")
        profiling.count("launch.bin_slots")
        perm = torch.sort(cls, stable=True)[1] if L else None
        rc = lib.gs_bin_slots(N, rect.data_ptr(), None if perm is None else perm.data_ptr(),
                              max_t, L, caps_c, budgets_c, ntx, ts, T,
                              int(depth_bits is None), key.data_ptr(),
                              None if slot_gid is None else slot_gid.data_ptr(),
                              stats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"bin_slots slot pass launch failed: cudaError {rc}")
    profiling.count("launch.bin_slots")
    return Slots(key, slot_gid, stats[1], stats[0], stats[2], T)


def slot_sort_key(tile_key: torch.Tensor, depths: torch.Tensor, T: int,
                  slot_gid: Optional[torch.Tensor] = None, depth_bits: int = 0):
    """The binning's sort key of the slots (``binning_slots``) and the key
    of tile t's first possible entry divided by t: the int64 ``(tile << 32)
    | depth bits`` (depth bits in float total order) and 2^32, or with
    ``depth_bits = b > 0`` the int32 ``tile * 2^b + qd`` and 2^b
    (``tiling.py:522-535`` of the JAX package): qd the depth quantized to
    2^b - 1 levels between the real slots' smallest and largest depth, 0 on
    a sentinel slot. A slot's gaussian is ``slot_gid[s]`` (compact layout)
    or, with ``slot_gid`` None, ``s % N`` (the dense (max_t, N) layout)."""
    N = depths.shape[0]
    if slot_gid is None:
        def per_slot(x):
            return x.expand(tile_key.shape[0] // N, N).reshape(-1)
    else:
        sg = slot_gid.long()

        def per_slot(x):
            return x[sg]
    if not depth_bits:
        return (tile_key.to(torch.int64) << 32) | per_slot(_float_order_bits(depths)), 1 << 32
    if not (T + 1) < (1 << (31 - depth_bits)):
        raise ValueError(f"tile grid of {T} tiles too large for a {depth_bits}-bit depth in "
                         f"an int32 sort key")
    levels = (1 << depth_bits) - 1
    depth = per_slot(depths.to(torch.float32))
    real = tile_key < T
    inf = torch.tensor(float("inf"), device=tile_key.device)
    dmin = torch.amin(torch.where(real, depth, inf))
    dmax = torch.amax(torch.where(real, depth, -inf))
    # float32 in the JAX order: subtract, then multiply by the scale. With
    # no real slot the scale is finite and every qd clamps to 0.
    scale = levels / torch.clamp_min(dmax - dmin, 1e-20)
    qd = torch.clamp((depth - dmin) * scale, 0, levels).to(torch.int32)
    return tile_key * (1 << depth_bits) + torch.where(real, qd, 0), 1 << depth_bits


def sort_keys(key: torch.Tensor, unit: int, T: int, n: int,
              slot_gid: Optional[torch.Tensor] = None,
              tiles: Optional[Tuple[int, int]] = None):
    """The binning's sort of the slots' keys (``slot_sort_key``, or
    ``bin_slots``' exact key with unit 2^32): one stable ``torch.sort``.
    Returns ``(tile_starts, gid (M,) int32)``: the segment starts of the
    tiles in ``tiles = (t0, t1)`` and of t1, ``(t1 - t0 + 1,)`` int32 (all T
    tiles and ``tile_starts[T]`` = n_isect by default), and the gaussian of
    each sorted slot, ``slot_gid`` of it or, with ``slot_gid`` None, the
    slot mod ``n``."""
    t0, t1 = (0, T) if tiles is None else tiles
    key_sorted, order = torch.sort(key, stable=True)
    # A key is >= t * unit exactly when its tile is >= t: no pass over the
    # keys to extract their tiles.
    query = torch.arange(t0, t1 + 1, dtype=key.dtype, device=key.device) * unit
    tile_starts = torch.searchsorted(key_sorted, query).to(torch.int32)
    gid = torch.remainder(order, n) if slot_gid is None else slot_gid[order]
    return tile_starts, gid.to(torch.int32)


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
    records: Optional[torch.Tensor] = None,
) -> TileBinning:
    """Bin and depth-sort N screen-space gaussians into the kernel-ready
    SoA and per-tile segment tables. Not differentiable by itself.

    ``records`` replaces the (N, 10) ``quantity_records`` the SoA gathers
    (surfels pack their own, ``ops/surfel.py``); the binning reads only
    ``means2d``, ``conics``, ``opacities``, ``radii`` and ``depths``.

    ``class_budgets=None`` selects the dense (max_t, N) slot layout; a
    tuple of per-class gaussian budgets (one per ``class_caps(max_t)``)
    the compact layout of ``total_slots(N, max_t, class_budgets)`` slots,
    whose overflow is counted in ``n_budget_dropped``.

    ``depth_bits = b > 0`` sorts one int32 key with the depth quantized to
    b bits (``slot_sort_key``); the exact (tile, depth) order stays on the
    bucket and band paths, which ignore it, as the JAX package does.

    ``sort_buckets = B > 0`` (a power of two) sorts through the bucket
    partition by ``tile % B`` with ``bucket_headroom`` times the balanced
    share of each 512-slot chunk per bucket (``_bucket_binned``); bucket
    overflow is counted in ``n_bucket_dropped`` and left out of
    ``n_isect``.

    ``sort_bands = K > 1`` bins K bands of tile rows on their own
    (``_band_binned``); exclusive with ``sort_buckets``."""
    N = means2d.shape[0]
    if N >= (1 << 24):
        raise ValueError("gaussian ids must be exact in float32 (N < 2^24)")
    max_t = max_tiles_per_gaussian
    if records is None:
        records = quantity_records(means2d, conics, colors, opacities, depths)
    geometry = tuple(x.contiguous() for x in (means2d, conics, opacities, radii, depths))
    if sort_bands > 1:
        if sort_buckets:
            raise ValueError("sort_bands and sort_buckets are exclusive")
        return _band_binned(geometry, records, width, height, tile_size, chunk, max_t,
                            class_budgets, int(sort_bands))

    # The exact int64 key on the flat path; the int32 tile for the bucket
    # partition and for the depth_bits key.
    key_bits = 0 if sort_buckets else (int(depth_bits) or None)
    sl = bin_slots(*geometry, width, height, tile_size, max_t, class_budgets,
                   depth_bits=key_bits)
    T = sl.T
    if sort_buckets:
        return _bucket_binned(sl.key, sl.slot_gid, depths, records, T, chunk,
                              int(sort_buckets), float(bucket_headroom), sl.n_isect,
                              sl.n_dropped, sl.n_budget_dropped)

    key, unit = ((sl.key, 1 << 32) if key_bits is None
                 else slot_sort_key(sl.key, depths, T, sl.slot_gid, key_bits))
    tile_starts, gid = sort_keys(key, unit, T, N, sl.slot_gid)
    counts = tile_starts[1:] - tile_starts[:-1]
    soa = pack_soa(records, gid, pad=2 * chunk, n_live=tile_starts[T:])
    return TileBinning(sorted_soa=soa, tile_starts=tile_starts, counts=counts,
                       n_isect=sl.n_isect, n_dropped=sl.n_dropped,
                       n_budget_dropped=sl.n_budget_dropped,
                       n_bucket_dropped=torch.zeros_like(sl.n_isect))


def _band_binned(geometry, records, width, height, ts, chunk, max_t, class_budgets, K):
    """Band-split binning (``tiling.py:704-784`` of the JAX package): K
    bands of ``cdiv(nty, K)`` tile rows, each enumerated (footprints
    clipped to its rows, the tile cap and the shared class budgets applied
    per band) and sorted on its own with the flat path's exact key, the K
    sorted streams concatenated in band order. Band k holds the tiles
    [lo ntx, hi ntx), so the concatenation is in global tile order; each
    band's sentinel slots sink to its tail, inside the stream, and
    ``tile_starts[T]`` is the stream length K M. Counts come per band, the
    counters are summed over the bands, and ``pack_soa`` runs once over the
    concatenated gid with no ``n_live``. A band past the last tile row
    (K > nty, or K not dividing nty) holds no tile: its M slots are all
    sentinels and are neither enumerated nor sorted. ``geometry`` is
    ``bin_slots``' (means2d, conics, opacities, radii, depths)."""
    ntx, nty = cdiv(width, ts), cdiv(height, ts)
    T = ntx * nty
    N = geometry[0].shape[0]
    dev = geometry[0].device
    M = total_slots(N, max_t, class_budgets)
    if K * M >= (1 << 31):
        raise ValueError(f"{K} bands of {M} slots overflow the int32 segment starts")
    band_h = cdiv(nty, K)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    n_isect, n_dropped, n_budget_dropped = zero, zero, zero
    starts, counts, gids = [], [], []
    for k in range(K):
        lo, hi = min(k * band_h, nty), min((k + 1) * band_h, nty)
        if lo == hi:
            gids.append(torch.zeros((M,), dtype=torch.int32, device=dev))
            continue
        sl = bin_slots(*geometry, width, height, ts, max_t, class_budgets, row_lo=lo,
                       row_hi=hi)
        n_isect = n_isect + sl.n_isect
        n_dropped = n_dropped + sl.n_dropped
        n_budget_dropped = n_budget_dropped + sl.n_budget_dropped
        ss, gid = sort_keys(sl.key, 1 << 32, T, N, sl.slot_gid, tiles=(lo * ntx, hi * ntx))
        del sl
        starts.append(ss[:-1] + k * M)
        counts.append(ss[1:] - ss[:-1])
        gids.append(gid)
    tile_starts = torch.cat(starts + [torch.full((1,), K * M, dtype=torch.int32, device=dev)])
    gid = torch.cat(gids)
    del gids
    soa = pack_soa(records, gid, pad=2 * chunk)
    return TileBinning(sorted_soa=soa, tile_starts=tile_starts, counts=torch.cat(counts),
                       n_isect=n_isect, n_dropped=n_dropped,
                       n_budget_dropped=n_budget_dropped,
                       n_bucket_dropped=torch.zeros_like(n_isect))


BUCKET_C = 512  # slots per partition chunk, as in the JAX bucket binning


def _bucket_binned(tile_key, slot_gid, depths, records, T, chunk, B, headroom, n_isect,
                   n_dropped, n_budget_dropped):
    """Partition-then-batched-sort binning (``tiling.py:787-859`` of the
    JAX package). The partition (``bucket_partition``) discards sentinel
    slots and keeps each bucket stable in slot order, so one stable sort
    per bucket of the flat path's int64 key, which it writes with each
    column's gaussian (``slot_gid`` on the compact layout), gives each tile
    the flat path's order; tile t = j B + k is segment j of bucket k."""
    from gaussian_splatting_tpu_torch.ops.partition import bucket_partition, quantum_for

    dev = tile_key.device
    q = quantum_for(BUCKET_C, B, headroom)
    key, gid, _, drops = bucket_partition(tile_key, depths.to(torch.float32).contiguous(), T,
                                          B, q, C=BUCKET_C, slot_gid=slot_gid)
    cap = key.shape[1]
    key_sorted, order = torch.sort(key, dim=1, stable=True)
    gid = torch.gather(gid, 1, order).reshape(-1)
    del key, order

    # Per-bucket segments: bucket k holds tiles k, k + B, ...; the last
    # query, T, lands at the bucket's pad run.
    Tq = cdiv(T, B)
    karr = torch.arange(B, device=dev)[:, None]
    queries = torch.clamp_max(karr + torch.arange(Tq + 1, device=dev)[None, :] * B, T)
    # key >= t << 32 exactly when its tile is >= t: no shift pass over the keys.
    ss = torch.searchsorted(key_sorted, (queries << 32).contiguous())     # (B, Tq + 1)
    starts_g = ss[:, :-1] + karr * cap
    counts_g = ss[:, 1:] - ss[:, :-1]
    tile_starts = torch.cat([starts_g.T.reshape(-1)[:T],
                             torch.full((1,), B * cap, device=dev, dtype=ss.dtype)])
    counts = counts_g.T.reshape(-1)[:T]
    soa = pack_soa(records, gid, pad=2 * chunk)
    n_bucket_dropped = drops.sum().to(n_isect.dtype)
    return TileBinning(sorted_soa=soa, tile_starts=tile_starts.to(torch.int32),
                       counts=counts.to(torch.int32), n_isect=n_isect - n_bucket_dropped,
                       n_dropped=n_dropped, n_budget_dropped=n_budget_dropped,
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


def _check_pack_rows_args(src, perm, key_sorted, n_valid, col0, n_rows):
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
    if not 0 <= col0 <= src.shape[1] - M:
        raise ValueError("the slice [col0, col0 + M) must lie inside src")


def pack_rows(src: torch.Tensor, perm: torch.Tensor, key_sorted: torch.Tensor,
              n_valid: torch.Tensor, col0: int, n_rows: int,
              sentinel: float) -> torch.Tensor:
    """The segsum-ready (16, cdiv(M, 8192) * 8192) buffer of the slice
    [col0, col0 + M) of a (16, C) stream in key order: row 0 the ascending
    int32 ``key_sorted`` as exact floats (``sentinel`` past M), rows
    1..n_rows-1 the stream's rows gathered through ``perm`` (the sort's
    permutation, slice-local) where ``col0 + perm < n_valid`` and 0
    elsewhere, rows n_rows..15 zero. Equal to the JAX ``pack_rows`` of the
    permuted, masked rows. CUDA tensors run the kernel
    (``csrc/pack_rows.cu``), CPU tensors the plain version."""
    _check_pack_rows_args(src, perm, key_sorted, n_valid, col0, n_rows)
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
    profiling.count("launch.pack_rows")
    return out


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
    N)``, ``pack_rows`` through its permutation, ``segment_sum_sorted`` of
    the rows ``pack_rows`` filled.
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
        part = segment_sum_sorted(stacked, N, n_rows)
        sums = part if sums is None else sums + part
    out = {k: sums[1 + j] for j, k in enumerate(GRAD_KEYS[:9])}
    out["ddepth"] = (sums[10] if with_depth
                     else torch.zeros((N,), dtype=torch.float32, device=grad_soa.device))
    return out
