"""Projection + SH shading of one view as one autograd Function: the
activations, the EWA projection of ``ops/projection.py`` and the SH colour of
``core/sh.py``, forward and backward, in place of autograd's graph of some
200 elementwise operations a view.

CUDA tensors run the kernel pair of ``csrc/project_sh.cu``: one thread a
slot, the forward writing every output of ``project_and_shade`` and the
backward recomputing the forward's intermediates from the inputs and
writing each gradient once. CPU tensors run the plain version: the forward
is ``project_shade_plain`` (the arithmetic of the autograd path, which pose
refinement still takes) and the backward ``project_shade_bwd_plain``, the
kernel's hand-derived formulas written as tensor operations.

Deformable 3D Gaussians (``models/deform.py``) hand the pair per-view
offsets ``(dx, dr, ds)``, added after the activations: the mean + dx,
exp(log s) + ds and normalize(q) + dr, whose sum the rotation normalizes
again. Without offsets the pair runs the static kernel instances, as before.

The JAX package computes this layer as plain ``jnp`` under ``jax.grad``
(``gaussian_splatting_tpu/ops/projection.py``, ``core/sh.py``), so the kernel
pair replaces no TPU kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gaussian_splatting_tpu_torch.core.activations import opacity_activation, scale_activation
from gaussian_splatting_tpu_torch.core.sh import SH_C1, SH_C2, SH_C3, eval_sh, sh_bases, sh_to_color
from gaussian_splatting_tpu_torch.ops import _build
from gaussian_splatting_tpu_torch.ops.projection import Projected, project_gaussians
from gaussian_splatting_tpu_torch.utils import profiling

MODES = ("classic", "antialiased")
EPS2D = 0.3


def _check_mode(rasterize_mode: str) -> bool:
    """True for the antialiased mode; raises on an unknown one."""
    if rasterize_mode not in MODES:
        raise ValueError(f"unknown rasterize_mode {rasterize_mode!r}")
    return rasterize_mode == "antialiased"


def normalize_quats(q: torch.Tensor):
    """(q / max(|q|, 1e-12), |q|, 1 / max(|q|, 1e-12)) entry by entry, in the
    kernel's operation order."""
    w, x, y, z = q.unbind(-1)
    n = torch.sqrt(w * w + x * x + y * y + z * z)
    inv = 1.0 / torch.clamp_min(n, 1e-12)
    return q * inv[:, None], n, inv


def apply_offsets(means, quats, scales, offsets):
    """The deformed (means, quats, scales): mean + dx, normalize(q) + dr and
    scales + ds, where ``offsets`` is ``(dx, dr, ds)``; None leaves all three
    as they are."""
    if offsets is None:
        return means, quats, scales
    dx, dr, ds = offsets
    return means + dx, normalize_quats(quats)[0] + dr, scales + ds


def project_shade_plain(means, quats, log_scales, logit_opacities, sh_coeffs, viewmat, K,
                        width: int, height: int, sh_degree: int = 3,
                        rasterize_mode: str = "classic", offsets=None):
    """(Projected, colors (N, 3), opacities (N,)) in plain PyTorch,
    differentiable through autograd in every input, the view and the
    ``offsets`` ``(dx, dr, ds)`` included. ``logit_opacities`` is (N,)."""
    antialiased = _check_mode(rasterize_mode)
    means, quats, scales = apply_offsets(means, quats, scale_activation(log_scales), offsets)
    opac = opacity_activation(logit_opacities)
    proj = project_gaussians(means, quats, scales, viewmat, K, width, height, eps2d=EPS2D,
                             opacities=opac)
    if antialiased:
        opac = opac * proj.compensations
    R = viewmat[:3, :3]
    t = viewmat[:3, 3]
    cam_pos = -R.T @ t
    dirs = means - cam_pos[None, :]
    dirs = dirs / torch.clamp_min(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-12)
    colors = sh_to_color(sh_degree, sh_coeffs, dirs)
    return proj, colors, opac


def _sh_basis_grads(degree: int, x, y, z):
    """The gradients (dB/dx, dB/dy, dB/dz) of ``core/sh.py::sh_bases`` 1 up
    to ``degree`` at the unit direction (x, y, z); basis 0 is constant."""
    zero = torch.zeros_like(x)
    out = []
    if degree >= 1:
        c = SH_C1
        out += [(zero, zero - c, zero), (zero, zero, zero + c), (zero - c, zero, zero)]
    if degree >= 2:
        c = SH_C2
        out += [(c[0] * y, c[0] * x, zero), (zero, c[1] * z, c[1] * y),
                (-2.0 * c[2] * x, -2.0 * c[2] * y, 4.0 * c[2] * z), (c[3] * z, zero, c[3] * x),
                (2.0 * c[4] * x, -2.0 * c[4] * y, zero)]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        c = SH_C3
        out += [(6.0 * c[0] * x * y, 3.0 * c[0] * (xx - yy), zero),
                (c[1] * y * z, c[1] * x * z, c[1] * x * y),
                (-2.0 * c[2] * x * y, c[2] * (4.0 * zz - xx - 3.0 * yy), 8.0 * c[2] * y * z),
                (-6.0 * c[3] * x * z, -6.0 * c[3] * y * z, c[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy)),
                (c[4] * (4.0 * zz - 3.0 * xx - yy), -2.0 * c[4] * x * y, 8.0 * c[4] * x * z),
                (2.0 * c[5] * x * z, -2.0 * c[5] * y * z, c[5] * (xx - yy)),
                (3.0 * c[6] * (xx - yy), -6.0 * c[6] * x * y, zero)]
    return out


def project_shade_bwd_plain(means, quats, log_scales, logit_opacities, sh_coeffs, viewmat, K,
                            width: int, height: int, sh_degree: int, rasterize_mode: str,
                            g_means2d=None, g_depths=None, g_conics=None, g_comps=None,
                            g_colors=None, g_opac=None, offsets=None):
    """The gradients (means, quats, log_scales, logit_opacities, sh_coeffs)
    of ``project_shade_plain``'s outputs' cotangents (None is zero), with
    the view held fixed: the kernel's hand-derived formulas as tensor
    operations. The forward's intermediates are recomputed from the inputs;
    each clamp and guard passes or stops its gradient as autograd's does.
    With ``offsets`` ``(dx, dr, ds)`` it also returns the gradients of dr
    and ds (dx's is the means')."""
    antialiased = _check_mode(rasterize_mode)
    if offsets is not None:
        quats1, qn1, inv1 = normalize_quats(quats)
        means = means + offsets[0]
        quats = quats1 + offsets[1]
    dt = means.dtype
    zero = torch.zeros_like(means[:, 0])

    def cols(g, k):
        return [zero] * k if g is None else list(g.reshape(-1, k).to(dt).unbind(-1))

    gmx, gmy = cols(g_means2d, 2)
    (gz_out,) = cols(g_depths, 1)
    gc0, gc1, gc2 = cols(g_conics, 3)
    (g_comp,) = cols(g_comps, 1)
    g_col = cols(g_colors, 3)
    (g_op,) = cols(g_opac, 1)

    W = viewmat[:3, :3].to(dt)
    t = viewmat[:3, 3].to(dt)
    fx, fy = K[0, 0].to(dt), K[1, 1].to(dt)
    m0, m1, m2 = means.unbind(-1)

    # SH: the colour's clamp, the coefficients' gradient and the view
    # direction's.
    cam_pos = -W.T @ t
    d = means - cam_pos[None, :]
    nd = torch.linalg.norm(d, dim=-1)
    nc = torch.clamp_min(nd, 1e-12)
    dn = d / nc[:, None]
    sh = sh_coeffs.to(dt)
    raw = eval_sh(sh_degree, sh, dn) + 0.5
    g_raw = torch.stack(g_col, dim=-1) * (raw >= 0.0)
    g_sh = torch.zeros_like(sh)
    for k, B in enumerate(sh_bases(sh_degree, dn)):
        g_sh[:, k, :] = B * g_raw
    g_dn = torch.zeros_like(means)
    for k, (bx, by, bz) in enumerate(_sh_basis_grads(sh_degree, *dn.unbind(-1)), start=1):
        w = (sh[:, k, :] * g_raw).sum(-1)
        g_dn = g_dn + w[:, None] * torch.stack([bx, by, bz], dim=-1)
    # dn = d / clamp_min(|d|, 1e-12): where |d| passes the clamp the
    # direction's gradient loses its radial part.
    radial = (g_dn * dn).sum(-1, keepdim=True) * dn
    g_d = torch.where((nd >= 1e-12)[:, None], (g_dn - radial) / nc[:, None],
                      g_dn / nc[:, None])

    # The projection's forward in ops/projection.py's operation order: det
    # and det_orig are cancellations that decide the guards.
    scales = torch.exp(log_scales)
    if offsets is not None:
        scales = scales + offsets[2]
    v = scales * scales
    op = torch.sigmoid(logit_opacities.reshape(-1).to(dt))
    qw, qx, qy, qz = quats.unbind(-1)
    qn_n = torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    inv_q = 1.0 / torch.clamp_min(qn_n, 1e-12)
    qw, qx, qy, qz = qw * inv_q, qx * inv_q, qy * inv_q, qz * inv_q
    r = [[1.0 - 2.0 * (qy * qy + qz * qz), 2.0 * (qx * qy - qw * qz), 2.0 * (qx * qz + qw * qy)],
         [2.0 * (qx * qy + qw * qz), 1.0 - 2.0 * (qx * qx + qz * qz), 2.0 * (qy * qz - qw * qx)],
         [2.0 * (qx * qz - qw * qy), 2.0 * (qy * qz + qw * qx), 1.0 - 2.0 * (qx * qx + qy * qy)]]
    s = [[r[i][0] * r[j][0] * v[:, 0] + r[i][1] * r[j][1] * v[:, 1] + r[i][2] * r[j][2] * v[:, 2]
          for j in range(3)] for i in range(3)]
    bw = [[s[k][0] * W[j, 0] + s[k][1] * W[j, 1] + s[k][2] * W[j, 2] for j in range(3)]
          for k in range(3)]
    c = [[W[i, 0] * bw[0][j] + W[i, 1] * bw[1][j] + W[i, 2] * bw[2][j] for j in range(3)]
         for i in range(3)]
    x = W[0, 0] * m0 + W[0, 1] * m1 + W[0, 2] * m2 + t[0]
    y = W[1, 0] * m0 + W[1, 1] * m1 + W[1, 2] * m2 + t[1]
    z = W[2, 0] * m0 + W[2, 1] * m1 + W[2, 2] * m2 + t[2]
    z_ok = ~(torch.abs(z) < 1e-6)
    zs = torch.where(z_ok, z, torch.full_like(z, 1e-6))
    lim_x = 1.3 * (0.5 * width / fx)
    lim_y = 1.3 * (0.5 * height / fy)
    ux_raw, uy_raw = x / zs, y / zs
    ux = torch.clamp(ux_raw, -lim_x, lim_x)
    uy = torch.clamp(uy_raw, -lim_y, lim_y)
    in_x = (ux_raw >= -lim_x) & (ux_raw <= lim_x)
    in_y = (uy_raw >= -lim_y) & (uy_raw <= lim_y)
    tx, ty = zs * ux, zs * uy
    rz = 1.0 / zs
    rz2 = rz * rz
    j00, j02 = fx * rz, -fx * tx * rz2
    j11, j12 = fy * rz, -fy * ty * rz2
    a = j00 * (j00 * c[0][0] + j02 * c[0][2]) + j02 * (j00 * c[0][2] + j02 * c[2][2])
    b = j00 * (j11 * c[0][1] + j12 * c[0][2]) + j02 * (j11 * c[1][2] + j12 * c[2][2])
    cc = j11 * (j11 * c[1][1] + j12 * c[1][2]) + j12 * (j11 * c[1][2] + j12 * c[2][2])
    det_orig = a * cc - b * b
    A, C = a + EPS2D, cc + EPS2D
    det = A * C - b * b
    pos = det > 0.0
    det_safe = torch.where(pos, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe

    # Opacity and compensation: in the antialiased mode the opacity out is
    # sigmoid * compensation.
    ratio = det_orig / det_safe
    comp = torch.sqrt(torch.clamp_min(ratio, 0.0))
    if antialiased:
        g_sig = g_op * comp
        g_comp = g_comp + g_op * op
    else:
        g_sig = g_op
    g_logit = g_sig * op * (1.0 - op)
    live = g_comp != 0.0
    g_ratio = torch.where(live & (ratio >= 0.0), g_comp / torch.where(live, 2.0 * comp, 1.0),
                          zero)
    g_det_orig = g_ratio / det_safe

    # The conic (C, -b, A) / det_safe, and det_safe.
    g_A = gc2 * inv_det
    g_C = gc0 * inv_det
    g_b = -gc1 * inv_det
    g_inv = gc0 * C - gc1 * b + gc2 * A
    g_det = torch.where(pos, -g_inv * inv_det * inv_det - g_ratio * ratio / det_safe, zero)
    g_A = g_A + g_det * C
    g_C = g_C + g_det * A
    g_b = g_b - 2.0 * b * (g_det + g_det_orig)
    g_a = g_A + g_det_orig * cc
    g_c = g_C + g_det_orig * a

    # a, b, c -> the camera covariance (symmetric cotangent gm) and J.
    gm00 = g_a * j00 * j00
    gm11 = g_c * j11 * j11
    gm22 = g_a * j02 * j02 + g_b * j02 * j12 + g_c * j12 * j12
    gm01 = 0.5 * g_b * j00 * j11
    gm02 = g_a * j00 * j02 + 0.5 * g_b * j00 * j12
    gm12 = 0.5 * g_b * j02 * j11 + g_c * j11 * j12
    gm = [[gm00, gm01, gm02], [gm01, gm11, gm12], [gm02, gm12, gm22]]
    g_j00 = 2.0 * g_a * (j00 * c[0][0] + j02 * c[0][2]) + g_b * (j11 * c[0][1] + j12 * c[0][2])
    g_j02 = 2.0 * g_a * (j00 * c[0][2] + j02 * c[2][2]) + g_b * (j11 * c[1][2] + j12 * c[2][2])
    g_j11 = g_b * (j00 * c[0][1] + j02 * c[1][2]) + 2.0 * g_c * (j11 * c[1][1] + j12 * c[1][2])
    g_j12 = g_b * (j00 * c[0][2] + j02 * c[2][2]) + 2.0 * g_c * (j11 * c[1][2] + j12 * c[2][2])

    # Sigma3's cotangent H = W^T gm W, its upper triangle mirrored: an
    # isotropic gaussian at the identity rotation then gets exactly zero
    # quaternion gradient, as autograd gives it. Sigma3 = R diag(v) R^T gives
    # dv_k = (R^T H R)_kk and dR = 2 H R diag(v).
    p = [[gm[i][0] * W[0, l] + gm[i][1] * W[1, l] + gm[i][2] * W[2, l] for l in range(3)]
         for i in range(3)]
    h = [[None] * 3 for _ in range(3)]
    for k in range(3):
        for l in range(k, 3):
            h[k][l] = h[l][k] = W[0, k] * p[0][l] + W[1, k] * p[1][l] + W[2, k] * p[2][l]
    hr = [[sum(h[i][j] * r[j][k] for j in range(3)) for k in range(3)] for i in range(3)]
    g_v = [sum(r[i][k] * hr[i][k] for i in range(3)) for k in range(3)]
    g_r = [[2.0 * hr[i][k] * v[:, k] for k in range(3)] for i in range(3)]
    if offsets is None:
        g_log_scales = 2.0 * v * torch.stack(g_v, dim=-1)
    else:
        g_ds = 2.0 * scales * torch.stack(g_v, dim=-1)
        g_log_scales = g_ds * torch.exp(log_scales)

    # The rotation matrix of the unit quaternion, then its normalization.
    g_qw = 2.0 * (-qz * g_r[0][1] + qy * g_r[0][2] + qz * g_r[1][0] - qx * g_r[1][2]
                  - qy * g_r[2][0] + qx * g_r[2][1])
    g_qx = 2.0 * (qy * g_r[0][1] + qz * g_r[0][2] + qy * g_r[1][0] - 2.0 * qx * g_r[1][1]
                  - qw * g_r[1][2] + qz * g_r[2][0] + qw * g_r[2][1] - 2.0 * qx * g_r[2][2])
    g_qy = 2.0 * (-2.0 * qy * g_r[0][0] + qx * g_r[0][1] + qw * g_r[0][2] + qx * g_r[1][0]
                  + qz * g_r[1][2] - qw * g_r[2][0] + qz * g_r[2][1] - 2.0 * qy * g_r[2][2])
    g_qz = 2.0 * (-2.0 * qz * g_r[0][0] - qw * g_r[0][1] + qx * g_r[0][2] + qw * g_r[1][0]
                  - 2.0 * qz * g_r[1][1] + qy * g_r[1][2] + qx * g_r[2][0] + qy * g_r[2][1])
    g_qn = torch.stack([g_qw, g_qx, g_qy, g_qz], dim=-1)
    qn = torch.stack([qw, qx, qy, qz], dim=-1)
    tang = g_qn - (g_qn * qn).sum(-1, keepdim=True) * qn
    g_quats = torch.where((qn_n >= 1e-12)[:, None], tang, g_qn) * inv_q[:, None]

    # J and the means2d through tx, ty, 1/zs to the camera-frame mean.
    g_rz = (g_j00 * fx + g_j11 * fy + gmx * fx * x + gmy * fy * y
            - 2.0 * rz * (g_j02 * fx * tx + g_j12 * fy * ty))
    g_tx = -g_j02 * fx * rz2
    g_ty = -g_j12 * fy * rz2
    g_ux = torch.where(in_x, g_tx * zs, zero)
    g_uy = torch.where(in_y, g_ty * zs, zero)
    g_zs = (-g_rz * rz * rz + g_tx * ux + g_ty * uy
            - (g_ux * x + g_uy * y) / (zs * zs))
    g_x = gmx * fx * rz + g_ux / zs
    g_y = gmy * fy * rz + g_uy / zs
    g_z = gz_out + torch.where(z_ok, g_zs, zero)
    g_p = torch.stack([g_x, g_y, g_z], dim=-1)
    g_means = g_p @ W + g_d
    if offsets is None:
        return g_means, g_quats, g_log_scales, g_logit, g_sh
    # The rotation's input is normalize(q) + dr: g_quats is dr's gradient.
    along1 = torch.where(qn1 >= 1e-12, (g_quats * quats1).sum(-1), zero)
    g_q = (g_quats - along1[:, None] * quats1) * inv1[:, None]
    return g_means, g_q, g_log_scales, g_logit, g_sh, g_quats, g_ds


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _cuda_inputs(means, quats, log_scales, logit_opacities, sh_coeffs, viewmat, K,
                 offsets=None):
    """The kernels' ten inputs: the five parameter tensors, the view, K and
    the three offsets (None without them), checked."""
    n = means.shape[0]
    ins = [t.contiguous() for t in (means, quats, log_scales, logit_opacities, sh_coeffs)]
    shapes = [(n, 3), (n, 4), (n, 3), (n,), (n, sh_coeffs.shape[1], 3)]
    names = ["means", "quats", "log_scales", "logit_opacities", "sh_coeffs"]
    offs = [None] * 3
    if offsets is not None:
        offs = [t.contiguous() for t in offsets]
        ins, shapes = ins + offs, shapes + [(n, 3), (n, 4), (n, 3)]
        names += ["dx", "dr", "ds"]
    for name, x, shape in zip(names, ins, shapes):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape} float32, got {tuple(x.shape)} {x.dtype}")
        if x.device != means.device:
            raise ValueError(f"{name} is on {x.device}, means on {means.device}")
    cam = [viewmat.to(device=means.device, dtype=torch.float32).contiguous(),
           K.to(device=means.device, dtype=torch.float32).contiguous()]
    if tuple(cam[0].shape) != (4, 4) or tuple(cam[1].shape) != (3, 3):
        raise ValueError("viewmat must be (4, 4) and K (3, 3)")
    if not n < 2 ** 31:
        raise ValueError("project_sh takes fewer than 2^31 slots")
    return ins[:5] + cam + offs


def _launch(which: str, ins, width, height, sh_degree, antialiased, tensors) -> None:
    """``gs_project_sh_<which>`` of ``csrc/project_sh.cu`` on the ten inputs
    (None offsets are null pointers) and ``tensors`` (the forward's outputs;
    or the backward's cotangents, None a null pointer, and gradients), on
    the current stream."""
    n, kb = ins[0].shape[0], ins[4].shape[1]
    if n == 0:
        return
    fn = getattr(_build.load("project_sh"), f"gs_project_sh_{which}")
    fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p] * (len(ins) + len(tensors) + 1))
    fn.restype = ctypes.c_int
    with torch.cuda.device(ins[0].device):
        rc = fn(n, kb, sh_degree, int(antialiased), float(width), float(height),
                *(_ptr(t) for t in (*ins, *tensors)), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"project_sh {which} kernel launch failed: cudaError {rc}")
    profiling.count(f"launch.project_sh_{which}")


class _ProjectShade(torch.autograd.Function):
    """``project_shade_plain`` with the view held fixed: the CUDA kernel pair
    on CUDA tensors, the plain forward and backward on CPU tensors. Saves
    only the inputs. The offsets ``dx, dr, ds`` are three more inputs, all
    None for a static scene."""

    @staticmethod
    def forward(ctx, means, quats, log_scales, logit_opacities, sh_coeffs, viewmat, K, cfg,
                dx=None, dr=None, ds=None):
        width, height, sh_degree, rasterize_mode = cfg
        offsets = None if dx is None else (dx, dr, ds)
        if means.device.type == "cuda":
            ins = _cuda_inputs(means, quats, log_scales, logit_opacities, sh_coeffs, viewmat, K,
                               offsets)
            n, dev = means.shape[0], means.device
            out = [torch.empty((n, 2), device=dev), torch.empty((n,), device=dev),
                   torch.empty((n, 3), device=dev),
                   torch.empty((n,), dtype=torch.int32, device=dev),
                   torch.empty((n,), device=dev), torch.empty((n, 3), device=dev),
                   torch.empty((n,), device=dev)]
            _launch("fwd", ins, width, height, sh_degree, rasterize_mode == "antialiased", out)
        elif means.device.type == "cpu":
            ins = (means, quats, log_scales, logit_opacities, sh_coeffs, viewmat, K)
            proj, colors, opac = project_shade_plain(*ins, width, height, sh_degree,
                                                     rasterize_mode, offsets)
            ins = ins + (dx, dr, ds)
            out = [proj.means2d, proj.depths, proj.conics, proj.radii, proj.compensations,
                   colors, opac]
        else:
            raise ValueError(f"project_shade runs on CUDA or CPU tensors, not {means.device}")
        ctx.mark_non_differentiable(out[3])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*ins)
        ctx.cfg = cfg
        return tuple(out)

    @staticmethod
    def backward(ctx, g_means2d, g_depths, g_conics, _g_radii, g_comps, g_colors, g_opac):
        ins = ctx.saved_tensors
        width, height, sh_degree, rasterize_mode = ctx.cfg
        deform = ins[7] is not None
        grads = (g_means2d, g_depths, g_conics, g_comps, g_colors, g_opac)
        if ins[0].device.type == "cuda":
            out = [torch.empty_like(t) for t in ins[:5]]
            if deform:
                out += [torch.empty_like(t) for t in ins[8:]]
            grads = [None if g is None else g.to(torch.float32).contiguous() for g in grads]
            _launch("bwd", ins, width, height, sh_degree, rasterize_mode == "antialiased",
                    [*grads, *out, *([None, None] if not deform else [])])
        else:
            out = project_shade_bwd_plain(*ins[:7], width, height, sh_degree, rasterize_mode,
                                          *grads, offsets=ins[7:] if deform else None)
        # dx's gradient is the means' (a copy: autograd may add into either
        # in place).
        out = list(out[:5]) + ([out[0].clone(), *out[5:]] if deform else [None] * 3)
        need = ctx.needs_input_grad
        g = [o if nd else None for o, nd in zip(out[:5], need[:5])]
        return (*g, None, None, None, *(o if nd else None for o, nd in zip(out[5:], need[8:])))


def project_shade(means, quats, log_scales, logit_opacities, sh_coeffs, viewmat, K,
                  width: int, height: int, sh_degree: int = 3,
                  rasterize_mode: str = "classic", offsets=None):
    """``project_shade_plain``'s outputs through the kernel pair (CUDA) or
    the plain forward and hand-derived backward (CPU); the view gets no
    gradient, the ``offsets`` ``(dx, dr, ds)`` do. ``logit_opacities`` is
    (N,)."""
    _check_mode(rasterize_mode)
    if not 0 <= sh_degree <= 3 or sh_coeffs.shape[1] < (sh_degree + 1) ** 2:
        raise ValueError(f"sh_degree {sh_degree} needs 0..3 and at least "
                         f"{(sh_degree + 1) ** 2} SH bases, got {sh_coeffs.shape[1]}")
    means2d, depths, conics, radii, comps, colors, opac = _ProjectShade.apply(
        means, quats, log_scales, logit_opacities, sh_coeffs, viewmat, K,
        (width, height, sh_degree, rasterize_mode), *(offsets or ()))
    proj = Projected(means2d=means2d, depths=depths, conics=conics, radii=radii,
                     compensations=comps)
    return proj, colors, opac
