"""Stable B-way bucket partition of a (16, M) column SoA (counterpart of
``gaussian_splatting_tpu/ops/partition.py``; CUDA kernel 8,
``csrc/partition.cu``).

Column j's bucket is ``(int(x[key_row, j]) >> bucket_shift) & (B - 1)``.
Every C-column input chunk owns ``quantum`` (q) output columns per bucket:
the chunk's kept columns of bucket b go to ``[g*q, g*q + q)`` of that bucket
in input order, a column ranked q or later in its chunk and bucket is
dropped and counted, and the rest of each window is pad (the bucket's
sentinel on the key row, zero payload). Row 15 of the output is the
validity mask (1 real, 0 pad); input row 15 is not carried through.
``n_valid`` discards every column past a prefix and ``drop_key_above``
every column whose key is at or above it; discarded columns get no bucket
and no count.

The binning path (``tiling.isect_and_sort(sort_buckets=B)``) partitions its
slots by tile so that one batched (B, cap) sort replaces the flat one.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from gaussian_splatting_tpu_torch.ops import _build


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


def partition_soa_plain(x: torch.Tensor, n_buckets: int, quantum: int, *, key_row: int,
                        sentinels: Sequence[float], C: int, bucket_shift: int,
                        n_valid: torch.Tensor, drop_key_above: Optional[float]):
    """Plain PyTorch version of the partition kernel (arguments checked
    and normalised as ``partition_soa`` does). The ranks come from one
    stable sort of the kept columns by (chunk, bucket)."""
    B, q = n_buckets, quantum
    M = x.shape[1]
    n_chunks = M // C
    cap = n_chunks * q
    dev = x.device
    key = x[key_row]
    cols = torch.arange(M, device=dev)
    keep = cols < n_valid.reshape(()).to(torch.int64)
    if drop_key_above is not None:
        keep &= key < drop_key_above
    kept_cols = torch.nonzero(keep).reshape(-1)
    bid = _bucket_ids(key[kept_cols], bucket_shift, B)
    gb = (kept_cols // C) * B + bid                      # (chunk, bucket) group
    gb_sorted, order = torch.sort(gb, stable=True)
    starts = torch.searchsorted(gb_sorted, gb_sorted)
    rank = torch.empty_like(gb)
    rank[order] = torch.arange(gb.shape[0], device=dev) - starts
    fill = torch.bincount(gb, minlength=n_chunks * B).reshape(n_chunks, B)
    kept_n = torch.clamp_max(fill, q)
    counts = kept_n.sum(0).to(torch.int32)
    drops = (fill - kept_n).sum(0).to(torch.int32)

    out = torch.zeros((16, B, cap), dtype=torch.float32, device=dev)
    out[key_row] = torch.as_tensor(sentinels, dtype=torch.float32, device=dev)[:, None]
    ok = rank < q
    src = kept_cols[ok]
    dst_b = bid[ok]
    dst_c = (src // C) * q + rank[ok]
    out[:15, dst_b, dst_c] = x[:15, src]
    out[15, dst_b, dst_c] = 1.0
    return out, counts, drops


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
        raise ValueError("C must be a multiple of 32 in [32, 1024] (one thread a column)")
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
    docstring). ``sentinel`` is one float or one per bucket; ``n_valid`` a
    one-element int32 tensor on x's device (default M). Returns ``(out
    (16, B, cap), counts (B,), drops (B,))`` with cap = (M / C) * quantum
    and counts, drops int32. CUDA tensors run the kernel
    (``csrc/partition.cu``), CPU tensors the plain version."""
    B, q = int(n_buckets), int(quantum)
    sentinels = _check_args(x, B, q, key_row, C, bucket_shift, sentinel)
    M = x.shape[1]
    if n_valid is None:
        n_valid = torch.full((1,), M, dtype=torch.int32, device=x.device)
    n_valid = n_valid.reshape(1).contiguous()
    if n_valid.dtype != torch.int32 or n_valid.device != x.device:
        raise ValueError("n_valid must be an int32 tensor on x's device")
    drop = None if drop_key_above is None else float(drop_key_above)
    if x.device.type == "cpu":
        return partition_soa_plain(x, B, q, key_row=key_row, sentinels=sentinels, C=C,
                                   bucket_shift=bucket_shift, n_valid=n_valid,
                                   drop_key_above=drop)
    if x.device.type != "cuda":
        raise ValueError(f"partition_soa runs on CUDA or CPU tensors, not {x.device}")
    fn = _build.load("partition").gs_partition
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cap = (M // C) * q
    sent = torch.tensor(sentinels, dtype=torch.float32, device=x.device)
    out = torch.empty((16, B, cap), dtype=torch.float32, device=x.device)
    counts = torch.empty((B,), dtype=torch.int32, device=x.device)
    drops = torch.empty((B,), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), M, n_valid.data_ptr(), sent.data_ptr(), B, q, C,
                key_row, int(bucket_shift), drop is not None,
                0.0 if drop is None else drop, out.data_ptr(), counts.data_ptr(),
                drops.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"partition kernel launch failed: cudaError {rc}")
    partition_soa.launches += 1
    return out, counts, drops


partition_soa.launches = 0
