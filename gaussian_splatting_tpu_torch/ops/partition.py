"""Stable B-way bucket partition (counterpart of
``gaussian_splatting_tpu/ops/partition.py``; CUDA kernel 8,
``csrc/partition.cu``).

The rule, for columns with a bucket id: every C-column input chunk owns
``quantum`` (q) output columns per bucket; the chunk's kept columns of
bucket b go to ``[g*q, g*q + q)`` of that bucket in input order, a column
ranked q or later in its chunk and bucket is dropped and counted, and the
rest of each window is pad.

``bucket_partition`` is the bucket binning's partition
(``tiling.isect_and_sort(sort_buckets=B)``), fused with its input: it
takes the slots' tiles (``tiling.binning_slots``), their gaussians on the
compact layout, and the depths and
writes, per output column, the int64 sort key ``(tile << 32) | depth
bits`` and the gaussian id, so that one batched (B, cap) sort replaces the
flat one. CUDA tensors run the kernel, CPU tensors the plain version.

``partition_soa`` is the JAX package's general contract on a (16, M) SoA
(column j's bucket is ``(int(x[key_row, j]) >> bucket_shift) & (B - 1)``,
pads carry the bucket's sentinel on the key row and zero payload, row 15
of the output is the validity mask, ``n_valid`` discards every column past
a prefix and ``drop_key_above`` every column whose key is at or above it;
discarded columns get no bucket and no count). The port keeps it as plain
PyTorch, the reference the tests hold against the JAX package; it runs on
CPU tensors only.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from gaussian_splatting_tpu_torch.ops import _build
from gaussian_splatting_tpu_torch.ops.tiling import _PACK_C, _float_order_bits, cdiv
from gaussian_splatting_tpu_torch.utils import profiling


def quantum_for(C: int, B: int, headroom: float) -> int:
    """Smallest quantum q, a multiple of 128 / gcd(B, 128), with
    B * q >= headroom * C (the JAX package's lane alignment of B * q)."""
    q_min = headroom * C / B
    step = 128 // math.gcd(B, 128)
    return max(int(-(-q_min // step)) * step, step)


def _bucket_ids(key: torch.Tensor, bucket_shift: int, B: int) -> torch.Tensor:
    """``(int(key) >> bucket_shift) & (B - 1)``, the shift logical as in
    the JAX kernel."""
    k = key.to(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return (k >> bucket_shift) & (B - 1)


def _ranks(kept_cols: torch.Tensor, bid: torch.Tensor, C: int, B: int, q: int,
           n_chunks: int):
    """The partition's placement of the kept columns ``kept_cols``
    (ascending) with buckets ``bid``: ``(ok, dst_c, counts, drops)``, ``ok``
    marking the columns inside their window and ``dst_c`` their output
    column in the bucket. The ranks come from one stable sort of the kept
    columns by (chunk, bucket)."""
    gb = (kept_cols // C) * B + bid                      # (chunk, bucket) group
    gb_sorted, order = torch.sort(gb, stable=True)
    starts = torch.searchsorted(gb_sorted, gb_sorted)
    rank = torch.empty_like(gb)
    rank[order] = torch.arange(gb.shape[0], device=gb.device) - starts
    fill = torch.bincount(gb, minlength=n_chunks * B).reshape(n_chunks, B)
    kept_n = torch.clamp_max(fill, q)
    counts = kept_n.sum(0).to(torch.int32)
    drops = (fill - kept_n).sum(0).to(torch.int32)
    ok = rank < q
    return ok, (kept_cols[ok] // C) * q + rank[ok], counts, drops


def bucket_partition_plain(tile_key: torch.Tensor, depths: torch.Tensor, T: int,
                           n_buckets: int, quantum: int, C: int = 512,
                           slot_gid: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the bucket partition kernel (arguments
    checked as ``bucket_partition`` checks them)."""
    B, q = n_buckets, quantum
    N = depths.shape[0]
    n_chunks = cdiv(tile_key.shape[0], _PACK_C) * _PACK_C // C
    cap = n_chunks * q
    dev = tile_key.device
    tile = tile_key.to(torch.int64)
    kept_cols = torch.nonzero(tile < T).reshape(-1)
    bid = tile[kept_cols] & (B - 1)
    ok, dst_c, counts, drops = _ranks(kept_cols, bid, C, B, q, n_chunks)
    src = kept_cols[ok]
    g = torch.remainder(src, N) if slot_gid is None else slot_gid[src].to(torch.int64)
    key = torch.full((B, cap), T << 32, dtype=torch.int64, device=dev)
    gid = torch.zeros((B, cap), dtype=torch.int32, device=dev)
    key[bid[ok], dst_c] = (tile[src] << 32) | _float_order_bits(depths[g])
    gid[bid[ok], dst_c] = g.to(torch.int32)
    return key, gid, counts, drops


# Shared memory a block may opt into on the H100 (hopper-kernels guide, §1).
_SMEM_OPT_IN = 232_448


def _partition_smem(B: int, q: int) -> int:
    """Shared memory of one block of the partition kernel
    (``csrc/partition.cu``): eight warps' (B, q) stages of (tile, gid), and
    B counts a warp plus the block's (2, B) sums, 4 bytes each."""
    return 4 * (16 * B * q + 10 * B)


def _check_bucket_args(tile_key, depths, T, B, q, C, slot_gid):
    if tile_key.dtype != torch.int32 or tile_key.dim() != 1:
        raise ValueError(f"tile_key must be (M,) int32, got {tuple(tile_key.shape)} "
                         f"{tile_key.dtype}")
    if slot_gid is not None and (slot_gid.dtype != torch.int32
                                 or tuple(slot_gid.shape) != tuple(tile_key.shape)
                                 or slot_gid.device != tile_key.device
                                 or not slot_gid.is_contiguous()):
        raise ValueError("slot_gid must be a contiguous (M,) int32 tensor on tile_key's device")
    if depths.dtype != torch.float32 or depths.dim() != 1 or depths.shape[0] < 1:
        raise ValueError(f"depths must be (N,) float32, N >= 1, got {tuple(depths.shape)} "
                         f"{depths.dtype}")
    if tile_key.device != depths.device:
        raise ValueError("tile_key and depths must be on one device")
    if not (tile_key.is_contiguous() and depths.is_contiguous()):
        raise ValueError("tile_key and depths must be contiguous")
    if not 0 < T < (1 << 31):
        raise ValueError("T must be in (0, 2^31)")
    if B < 2 or B & (B - 1):
        raise ValueError("n_buckets must be a power of two >= 2")
    if not (32 <= C <= 1024 and C % 32 == 0 and _PACK_C % C == 0):
        raise ValueError(f"C must be a multiple of 32 in [32, 1024] dividing {_PACK_C}")
    if q < 1 or (B * q) % 128:
        raise ValueError("B * quantum must be lane-aligned (a positive multiple of 128)")
    if B * q > 4 * C:
        raise ValueError("headroom B * quantum / C > 4 is never worth the sort")
    if _partition_smem(B, q) > _SMEM_OPT_IN:
        raise ValueError(f"B = {B}, quantum = {q} needs {_partition_smem(B, q)} bytes of shared "
                         f"memory a block, above {_SMEM_OPT_IN} (the kernel stages each chunk's "
                         f"window there)")


def bucket_partition(tile_key: torch.Tensor, depths: torch.Tensor, T: int, n_buckets: int,
                     quantum: int, C: int = 512, slot_gid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bucket binning's partition of the slots by ``tile % B``.

    ``tile_key`` (M,) int32 is each slot's tile, T on a sentinel slot;
    slot s holds gaussian ``slot_gid[s]`` (the compact layout, an (M,)
    int32 tensor) or, with ``slot_gid`` None, ``s % N`` (the dense layout)
    of ``depths`` (N,) float32, and is kept when its tile is below T. The slots are padded to M' = M rounded up to
    8192 (the JAX width; the pad is discarded), so cap = (M' / C) *
    quantum. Returns ``(key (B, cap) int64, gid (B, cap) int32, counts
    (B,) int32, drops (B,) int32)``: a kept column holds ``(tile << 32) |
    order_bits(depth)`` (``tiling._float_order_bits``) and its gaussian, a
    pad column ``T << 32`` and 0, so pads sort to each bucket's tail. Equal
    to the JAX ``partition_soa`` of the bucket binning's (16, M') input
    (key row 0, sentinel and ``drop_key_above`` T) on the key, depth and
    gid rows. CUDA tensors run the kernel (``csrc/partition.cu``), CPU
    tensors the plain version."""
    B, q, T = int(n_buckets), int(quantum), int(T)
    _check_bucket_args(tile_key, depths, T, B, q, C, slot_gid)
    if tile_key.device.type == "cpu":
        return bucket_partition_plain(tile_key, depths, T, B, q, C, slot_gid)
    if tile_key.device.type != "cuda":
        raise ValueError(f"bucket_partition runs on CUDA or CPU tensors, not {tile_key.device}")
    fn = _build.load("partition").gs_bucket_partition
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    M = tile_key.shape[0]
    m_pad = cdiv(M, _PACK_C) * _PACK_C
    cap = (m_pad // C) * q
    dev = tile_key.device
    key = torch.empty((B, cap), dtype=torch.int64, device=dev)
    gid = torch.empty((B, cap), dtype=torch.int32, device=dev)
    counts_drops = torch.empty((2, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(tile_key.data_ptr(), None if slot_gid is None else slot_gid.data_ptr(), M,
                m_pad, depths.data_ptr(), depths.shape[0], T, B, q, C,
                key.data_ptr(), gid.data_ptr(), counts_drops.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bucket partition kernel launch failed: cudaError {rc}")
    profiling.count("launch.partition")
    return key, gid, counts_drops[0], counts_drops[1]


def _check_args(x, B, q, key_row, C, bucket_shift, sentinel):
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != 16:
        raise ValueError(f"x must be (16, M) float32, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not 0 <= key_row < 15:
        raise ValueError("key_row must be in [0, 15): row 15 is the validity carrier")
    if B < 2 or B & (B - 1):
        raise ValueError("n_buckets must be a power of two >= 2")
    if not 0 <= bucket_shift < 32:
        raise ValueError("bucket_shift must be in [0, 32)")
    if not (32 <= C <= 1024 and C % 32 == 0):
        raise ValueError("C must be a multiple of 32 in [32, 1024]")
    if x.shape[1] % C:
        raise ValueError("pad M to a multiple of C first")
    if q < 1 or (B * q) % 128:
        raise ValueError("B * quantum must be lane-aligned (a positive multiple of 128)")
    if B * q > 4 * C:
        raise ValueError("headroom B * quantum / C > 4 is never worth the sort")
    if isinstance(sentinel, (int, float)):
        return (float(sentinel),) * B
    sentinels = tuple(float(s) for s in sentinel)
    if len(sentinels) != B:
        raise ValueError(f"need one sentinel per bucket ({B}), got {len(sentinels)}")
    return sentinels


def partition_soa(x: torch.Tensor, n_buckets: int, quantum: int, *, key_row: int = 0,
                  sentinel: Union[float, Sequence[float]], C: int = 512,
                  bucket_shift: int = 0, n_valid: Optional[torch.Tensor] = None,
                  drop_key_above: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable ``n_buckets``-way partition of the (16, M) SoA ``x`` (module
    docstring), the JAX package's contract in plain PyTorch on CPU tensors.
    ``sentinel`` is one float or one per bucket; ``n_valid`` a one-element
    int32 tensor on x's device (default M). Returns ``(out (16, B, cap),
    counts (B,), drops (B,))`` with cap = (M / C) * quantum and counts,
    drops int32. On the card the bucket binning runs ``bucket_partition``."""
    B, q = int(n_buckets), int(quantum)
    sentinels = _check_args(x, B, q, key_row, C, bucket_shift, sentinel)
    if x.device.type != "cpu":
        raise ValueError(f"partition_soa is the plain reference and takes CPU tensors, not "
                         f"{x.device}; the card's partition is bucket_partition")
    M = x.shape[1]
    if n_valid is None:
        n_valid = torch.full((1,), M, dtype=torch.int32)
    if n_valid.dtype != torch.int32 or n_valid.device != x.device:
        raise ValueError("n_valid must be an int32 tensor on x's device")
    n_chunks = M // C
    key = x[key_row]
    keep = torch.arange(M) < n_valid.reshape(()).to(torch.int64)
    if drop_key_above is not None:
        keep &= key < float(drop_key_above)
    kept_cols = torch.nonzero(keep).reshape(-1)
    bid = _bucket_ids(key[kept_cols], bucket_shift, B)
    ok, dst_c, counts, drops = _ranks(kept_cols, bid, C, B, q, n_chunks)

    out = torch.zeros((16, B, n_chunks * q), dtype=torch.float32)
    out[key_row] = torch.as_tensor(sentinels, dtype=torch.float32)[:, None]
    src = kept_cols[ok]
    out[:15, bid[ok], dst_c] = x[:15, src]
    out[15, bid[ok], dst_c] = 1.0
    return out, counts, drops
