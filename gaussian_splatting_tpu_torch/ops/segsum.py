"""Segmented column sums of a segment-sorted buffer (counterpart of
``gaussian_splatting_tpu/ops/segsum.py``): the last stage of the
per-gaussian gradient reduce.

CUDA tensors run CUDA kernel 4 (``csrc/segsum.cu``: each warp reduces
spans of 128 columns with a segmented scan and writes every output column
once, the zero ones too); CPU tensors run the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from gaussian_splatting_tpu_torch.ops import _build
from gaussian_splatting_tpu_torch.utils import profiling


def _check_args(stacked: torch.Tensor, n_segments: int, n_rows: int) -> None:
    if stacked.dtype != torch.float32 or stacked.dim() != 2 or stacked.shape[0] != 16:
        raise ValueError(f"stacked must be (16, M) float32, got "
                         f"{tuple(stacked.shape)} {stacked.dtype}")
    if not stacked.is_contiguous():
        raise ValueError("stacked must be contiguous")
    if not 0 < n_segments < (1 << 24):
        raise ValueError("segment ids must be exact in float32 (0 < n_segments < 2^24)")
    if not 1 <= n_rows <= 16:
        raise ValueError("n_rows must be in [1, 16]")


def segment_sum_sorted_plain(stacked: torch.Tensor, n_segments: int,
                             n_rows: int = 16) -> torch.Tensor:
    """Plain PyTorch version of the segsum kernel: each run of equal ids is
    summed as a difference of float64 prefix sums at its ends, then rounded
    to float32; rows ``n_rows``..15 are zero."""
    ids = stacked[0].to(torch.int64)
    out = torch.zeros((16, n_segments), dtype=torch.float32, device=stacked.device)
    seg, counts = torch.unique_consecutive(ids, return_counts=True)
    ends = torch.cumsum(counts, 0)
    keep = seg < n_segments
    cs = torch.cat([torch.zeros((n_rows, 1), dtype=torch.float64, device=stacked.device),
                    torch.cumsum(stacked[:n_rows].to(torch.float64), dim=1)], dim=1)
    sums = cs[:, ends[keep]] - cs[:, (ends - counts)[keep]]
    out[:n_rows, seg[keep]] = sums.to(torch.float32)
    return out


def segment_sum_sorted(stacked: torch.Tensor, n_segments: int,
                       n_rows: int = 16) -> torch.Tensor:
    """Sum the columns of a segment-sorted (16, M) buffer per segment id.

    Row 0 holds each column's id as an exact float32 integer, ascending, in
    [0, n_segments]; id ``n_segments`` is the sentinel and must carry zero
    payload. Returns (16, n_segments): column g is the sum of the input
    columns with id g (row 0 = g times their count; callers ignore it), zero
    for ids with no column. Only rows 1..``n_rows``-1 are read: the caller
    promises that rows ``n_rows``..15 of the input are zero, and they are
    zero in the output."""
    _check_args(stacked, n_segments, n_rows)
    if stacked.device.type == "cpu":
        return segment_sum_sorted_plain(stacked, n_segments, n_rows)
    if stacked.device.type != "cuda":
        raise ValueError(f"segment_sum_sorted runs on CUDA or CPU tensors, not {stacked.device}")
    fn = _build.load("segsum").gs_segsum
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((16, n_segments), dtype=torch.float32, device=stacked.device)
    with torch.cuda.device(stacked.device):
        rc = fn(stacked.data_ptr(), stacked.shape[1], n_segments, n_rows, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segsum kernel launch failed: cudaError {rc}")
    profiling.count("launch.segsum")
    return out
