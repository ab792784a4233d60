"""The HexPlane field of 4D Gaussian Splatting (``models/hexplane.py``) as
one differentiable op: ``field(planes, xn, t)`` samples the twelve planes
at each row's normalised position ``xn`` (R, 3) and the time ``t`` and
returns the (R, 32) feature, both scales' six-plane products side by side.

CUDA tensors launch ``csrc/hexplane.cu``'s pair (built with ``-fmad=false``
through ``_build.SOURCE_FLAGS``; counters ``launch.hexplane_fwd`` and
``launch.hexplane_bwd``, one a call): the forward writes the feature, the
backward recomputes the samples and writes the planes' gradients (atomic
sums, so their order varies from run to run) and the coordinates'. CPU
tensors take ``field_plain`` and ``field_bwd_plain``, the same arithmetic in
PyTorch, which ``tests/test_torch_hexplane.py`` holds against
``F.grid_sample`` under autograd.

Each plane is held channel-last, (R_j, R_i, 16) for the pair of axes (i,
j): the published (1, 16, R_j, R_i) parameter is ``plane.permute(2, 0,
1)[None]``. Planes are sampled as ``F.grid_sample(align_corners=True,
padding_mode="border")`` samples them; the time axis takes no gradient.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from gaussian_splatting_tpu_torch.ops import _build
from gaussian_splatting_tpu_torch.utils import profiling

CHANNELS = 16
# The planes of a scale: one a pair (i, j) of the axes (x, y, z, t), in
# itertools.combinations(range(4), 2) order: xy, xz, xt, yz, yt, zt.
PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
N_PLANES = 12


def _axis(q: torch.Tensor, R: int):
    """grid_sample's clipped unnormalised coordinate along an axis of R
    cells: (cell c0, cell c1 (clamped to R - 1, where its weight is 0),
    weights c0 + 1 - x and x - c0, the coordinate's gradient factor)."""
    lim = float(R - 1)
    x = ((q + 1.0) / 2.0) * lim
    clip = ((x > 0.0) & (x < lim)).to(q.dtype)
    x = torch.clamp(x, 0.0, lim)
    f = torch.floor(x)
    c0 = f.to(torch.int64)
    return c0, torch.clamp_max(c0 + 1, R - 1), (f + 1.0) - x, x - f, clip * (lim / 2.0)


def _corners(plane: torch.Tensor, ax, ay):
    """The (R, 16) values of the four corners nw, ne, sw, se."""
    ri = plane.shape[1]
    flat = plane.reshape(-1, plane.shape[-1])
    return (flat[ay[0] * ri + ax[0]], flat[ay[0] * ri + ax[1]],
            flat[ay[1] * ri + ax[0]], flat[ay[1] * ri + ax[1]])


def _weights(ax, ay):
    return ((ax[2] * ay[2])[:, None], (ax[3] * ay[2])[:, None],
            (ax[2] * ay[3])[:, None], (ax[3] * ay[3])[:, None])


def _coords(xn: torch.Tensor, t: torch.Tensor) -> List[torch.Tensor]:
    return [xn[:, 0], xn[:, 1], xn[:, 2], t.reshape(1).to(xn.dtype).expand(xn.shape[0])]


def field_plain(planes: Sequence[torch.Tensor], xn: torch.Tensor, t: torch.Tensor
                ) -> torch.Tensor:
    """The (R, 32) feature in plain PyTorch, the kernel's arithmetic: each
    plane's bilinear sample nw + ne + sw + se, the products 1 * v_0 * ..
    * v_5 left to right."""
    q = _coords(xn, t)
    out = []
    for s in range(N_PLANES // 6):
        acc = torch.ones((xn.shape[0], CHANNELS), dtype=xn.dtype, device=xn.device)
        for p, (i, j) in enumerate(PAIRS):
            plane = planes[6 * s + p]
            ax, ay = _axis(q[i], plane.shape[1]), _axis(q[j], plane.shape[0])
            c, w = _corners(plane, ax, ay), _weights(ax, ay)
            acc = acc * (c[0] * w[0] + c[1] * w[1] + c[2] * w[2] + c[3] * w[3])
        out.append(acc)
    return torch.cat(out, dim=1)


def field_bwd_plain(planes: Sequence[torch.Tensor], xn: torch.Tensor, t: torch.Tensor,
                    gfeat: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(the planes' gradients, the (R, 3) coordinates' gradient) of the
    feature's gradient ``gfeat`` (R, 32), derived by hand as the backward
    kernel computes them: through the product in autograd's order, then
    grid_sample's backward of each plane."""
    q = _coords(xn, t)
    gq = [torch.zeros_like(q[0]) for _ in range(3)]
    grads = [torch.zeros_like(p) for p in planes]
    for s in range(N_PLANES // 6):
        geo, vals, run = [], [], []
        for p, (i, j) in enumerate(PAIRS):
            plane = planes[6 * s + p]
            ax, ay = _axis(q[i], plane.shape[1]), _axis(q[j], plane.shape[0])
            c, w = _corners(plane, ax, ay), _weights(ax, ay)
            v = c[0] * w[0] + c[1] * w[1] + c[2] * w[2] + c[3] * w[3]
            geo.append((ax, ay, c, w))
            vals.append(v)
            run.append(v if p == 0 else run[-1] * v)
        G = gfeat[:, CHANNELS * s:CHANNELS * (s + 1)]
        for p in range(5, -1, -1):
            gv = G if p == 0 else G * run[p - 1]
            if p > 0:
                G = G * vals[p]
            i, j = PAIRS[p]
            ax, ay, c, w = geo[p]
            gx = ((c[1] - c[0]) * gv).sum(-1) * ay[2] + ((c[3] - c[2]) * gv).sum(-1) * ay[3]
            gq[i] = gq[i] + ax[4] * gx
            if j < 3:
                gy = ((c[2] - c[0]) * gv).sum(-1) * ax[2] + ((c[3] - c[1]) * gv).sum(-1) * ax[3]
                gq[j] = gq[j] + ay[4] * gy
            g = grads[6 * s + p]
            flat = g.view(-1, g.shape[-1])
            ri = g.shape[1]
            for (yc, xc), wk in zip(((0, 0), (0, 1), (1, 0), (1, 1)), w):
                flat.index_add_(0, ay[yc] * ri + ax[xc], gv * wk)
    return grads, torch.stack(gq, dim=1)


def _plane_args(planes):
    ptrs = (ctypes.c_int64 * N_PLANES)(*(p.data_ptr() for p in planes))
    dims = (ctypes.c_int32 * (2 * N_PLANES))(*(d for p in planes for d in (p.shape[1],
                                                                           p.shape[0])))
    return ptrs, dims


def _fwd_cuda(planes, xn, t):
    lib = _build.load("hexplane")
    fn = lib.gs_hexplane_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    feat = torch.empty((xn.shape[0], 2 * CHANNELS), dtype=torch.float32, device=xn.device)
    ptrs, dims = _plane_args(planes)
    with torch.cuda.device(xn.device):
        rc = fn(ptrs, dims, xn.data_ptr(), t.data_ptr(), xn.shape[0], feat.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hexplane forward kernel launch failed: cudaError {rc}")
    profiling.count("launch.hexplane_fwd")
    return feat


def _bwd_cuda(planes, xn, t, gfeat):
    lib = _build.load("hexplane")
    fn = lib.gs_hexplane_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    grads = [torch.zeros_like(p) for p in planes]
    gxn = torch.empty_like(xn)
    ptrs, dims = _plane_args(planes)
    gptrs = (ctypes.c_int64 * N_PLANES)(*(g.data_ptr() for g in grads))
    with torch.cuda.device(xn.device):
        rc = fn(ptrs, gptrs, dims, xn.data_ptr(), t.data_ptr(), gfeat.data_ptr(), xn.shape[0],
                gxn.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hexplane backward kernel launch failed: cudaError {rc}")
    profiling.count("launch.hexplane_bwd")
    return grads, gxn


class _Field(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xn, t, *planes):
        if xn.device.type == "cuda":
            feat = _fwd_cuda(planes, xn, t)
        else:
            feat = field_plain(planes, xn, t)
        ctx.save_for_backward(xn, t, *planes)
        return feat

    @staticmethod
    def backward(ctx, gfeat):
        xn, t, *planes = ctx.saved_tensors
        gfeat = gfeat.contiguous()
        if xn.device.type == "cuda":
            grads, gxn = _bwd_cuda(planes, xn, t, gfeat)
        else:
            grads, gxn = field_bwd_plain(planes, xn, t, gfeat)
        return (gxn if ctx.needs_input_grad[0] else None, None,
                *(g if need else None for g, need in zip(grads, ctx.needs_input_grad[2:])))


def _check(planes, xn, t) -> None:
    if len(planes) != N_PLANES:
        raise ValueError(f"hexplane field: {N_PLANES} planes, got {len(planes)}")
    if xn.dim() != 2 or xn.shape[1] != 3:
        raise ValueError(f"hexplane field: xn must be (R, 3), got {tuple(xn.shape)}")
    if t.numel() != 1:
        raise ValueError("hexplane field: t must hold one time")
    for x in (xn, t, *planes):
        if x.dtype != torch.float32 or x.device != xn.device or not x.is_contiguous():
            raise ValueError(f"hexplane field: tensors must be float32, contiguous and on "
                             f"{xn.device}, got {x.dtype} on {x.device}")
    for p in planes:
        if p.dim() != 3 or p.shape[-1] != CHANNELS:
            raise ValueError(f"hexplane field: planes are (R_j, R_i, {CHANNELS}), got "
                             f"{tuple(p.shape)}")
    if xn.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hexplane field runs on CUDA or CPU tensors, not {xn.device}")


def field(planes: Sequence[torch.Tensor], xn: torch.Tensor, t) -> torch.Tensor:
    """The (R, 32) HexPlane feature of the rows ``xn`` (R, 3, in the box's
    [-1, 1]) at the time ``t`` (a number or a one-element float32 tensor),
    differentiable in ``xn`` and the twelve ``planes`` (scale 0's six, then
    scale 1's, each (R_j, R_i, 16) float32). See the module's docstring."""
    t = torch.as_tensor(t, dtype=torch.float32, device=xn.device).reshape(())
    _check(planes, xn, t)
    return _Field.apply(xn, t, *planes)
