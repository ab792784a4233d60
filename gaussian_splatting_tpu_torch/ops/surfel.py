"""2D Gaussian Splatting (Huang et al., SIGGRAPH 2024): surfels through the
port's binning and two kernel pairs of their own.

A surfel is a flat gaussian disc: a centre p, a rotation R = [t_u, t_v, t_w]
from a quaternion, two scales (s_u, s_v), an opacity and SH colour; its
normal is t_w. Per view (``project_surfels``, the kernel pair
``gs_project_surfel_fwd`` / ``_bwd`` of ``csrc/project_sh.cu``):

- the splat-to-screen map T, whose columns are K W (s_u t_u), K W (s_v t_v)
  and K (W p + t). The port writes it in pixel coordinates centred at the
  projected centre c = (T_u3, T_v3) / T_w3: then T_u3 = T_v3 = 0, the seven
  other entries ``tmat`` = [T_u1, T_u2, T_v1, T_v2, T_w1, T_w2, T_w3] and c
  are what the rasterizer reads, and the intersection below loses nothing
  to the cancellation of x T_w - T_u at x ~ 1000 pixels. The map is the
  published one moved by -c: the same (u, v) at every pixel;
- the view-space normal W t_w turned to face the camera;
- SH colour along the view direction, as the static projection's;
- for the binning, an ellipse around c that holds every pixel the surfel
  can reach with alpha >= 1/255: the image of the disc u^2 + v^2 <= Q
  (Q = 2 (ln(255 o) + 1e-3), the binning's gate), a conic whose dual is
  T diag(Q, Q, -1) T^T, moved to c and grown to hold the screen filter's
  circle as well (``binning_ellipse``). It is written as
  a conic scaled so that the binning's q <= Q test is that ellipse, and
  the radius bounds it. A surfel whose disc at that level crosses the
  camera plane, or whose centre lies nearer than 0.2, is culled.

Per pixel (x, y) and entry (``csrc/rasterize_surfel.cu``, its plain
version ``surfel_fwd_plain``): k = dx T_w - T_u, l = dy T_w - T_v with (dx,
dy) = (x, y) - c, p = k x l, (u, v) = (p1, p2) / p3; rho3 = u^2 + v^2, rho2 =
|(dx, dy)|^2 / sigma^2 with sigma = sqrt(2) / 2 (the object-space low-pass
filter); rho = min(rho3, rho2), alpha = min(o e^(-rho / 2), 0.999); the
depth z = u T_w1 + v T_w2 + T_w3 where rho3 <= rho2, else T_w3. An entry
counts as the published rasterizer counts it: p3 != 0, z >= 0.2 and alpha >=
1/255. Blending is front to back with the static kernels' chunk-carried
stop rule, and a pixel gets 12 rows: colour (3), expected depth sum w z,
alpha sum w, the normal sum w n (3), the depth distortion sum_{j<i} w_i w_j
(m_i - m_j)^2 with m = f / (f - n) (1 - n / z), n = 0.2, f = 100, the median
depth (z of the last entry with transmittance above 0.5 before it), and
the sums M1 = sum w m and M2 = sum w m^2 the distortion's backward reads
(the distortion equals A M2 - M1^2 with A the alpha). The median depth
carries no gradient.

The backward kernel writes two gradient streams of the static layout, one
(32, cap) buffer: rows 0-15 [id, dcx, dcy, dT (7), dop, 0 x 5] and rows
16-31 [id, dr, dg, db, dn (3), 0 x 9]; the reduce sorts the ids once and
packs and sums each half (``reduce_surfel_grads``). The SoA is two
``pack_soa`` tables, the second gathered through the first's id row
(``second_soa``): rows [cx, cy, T (7), o] and [r, g, b, n (3), the
binning conic (3)]; the kernels' warp cull tests the binning ellipse
(``raster_tiles.cuh::warp_may_hit``).

CPU tensors run the plain versions: ``project_surfels_plain`` and its
hand-derived backward ``project_surfels_bwd_plain``, ``surfel_fwd_plain`` and
``surfel_bwd_plain``. ``models/surfel_ref.py`` is the plain reference the
tests hold all of it to.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from gaussian_splatting_tpu_torch.core.sh import eval_sh
from gaussian_splatting_tpu_torch.ops import _build
from gaussian_splatting_tpu_torch.ops.project_sh import _ptr, _sh_basis_grads
from gaussian_splatting_tpu_torch.ops.rasterize_cuda import (
    ALPHA_CLAMP,
    ALPHA_SKIP,
    T_EARLY_STOP,
    _check_fwd_args,
    _cumprod_sequential,
    _pixel_centres,
    _plain_batches,
    grad_cap,
)
from gaussian_splatting_tpu_torch.ops.tiling import (
    cdiv,
    isect_and_sort,
    pack_rows,
    pack_soa,
    sorted_gid_key,
)
from gaussian_splatting_tpu_torch.utils import profiling

NEAR = 0.2             # the published near plane: centres and entry depths below it are cut
FAR = 100.0            # the far value of the distortion's depth map m
M_SCALE = FAR / (FAR - NEAR)
FILTER_INV_SQ = 2.0    # 1 / sigma^2 of the screen filter, sigma = sqrt(2) / 2
OUT_ROWS = 12          # r g b depth alpha nx ny nz distortion median M1 M2
GRAD_ROWS_A = 11       # id dcx dcy dT(7) dop
GRAD_ROWS_B = 7        # id dr dg db dn(3)
# (tiles x pixels x entries) elements of one plain batch's temporaries.
_PLAIN_ELEMS = 1 << 23
# Room the binning ellipse keeps over the float32 rounding of its own terms.
_ELLIPSE_SLACK = 1e-3


class SurfelProjected(NamedTuple):
    """One view's screen-space surfels, leading dim N."""

    centers: torch.Tensor  # (N, 2) projected centre c, pixels
    tmat: torch.Tensor     # (N, 7) T_u1 T_u2 T_v1 T_v2 T_w1 T_w2 T_w3, centred at c
    normals: torch.Tensor  # (N, 3) view-space normal facing the camera
    depths: torch.Tensor   # (N,) centre depth T_w3 (the sort key)
    conics: torch.Tensor   # (N, 3) the binning ellipse as a conic at the gate Q
    radii: torch.Tensor    # (N,) int32, 0 = culled
    colors: torch.Tensor   # (N, 3)
    opac: torch.Tensor     # (N,)


# ---- projection ---------------------------------------------------------------


def _rotation(quats: torch.Tensor):
    """Row-major rotation entries of the normalized quaternion, with the
    unit quaternion, |q| and 1 / max(|q|, 1e-12), in the kernel's order."""
    w, x, y, z = quats.unbind(-1)
    qn = torch.sqrt(w * w + x * x + y * y + z * z)
    inv = 1.0 / torch.clamp_min(qn, 1e-12)
    w, x, y, z = w * inv, x * inv, y * inv, z * inv
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = (1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
         2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
         2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy))
    return r, (w, x, y, z), qn, inv


def _gate_q(op: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(2.0 * (torch.log(255.0 * torch.clamp_min(op, 1e-12)) + 1e-3), 0.0)


def binning_ellipse(tmat: torch.Tensor, op: torch.Tensor, width: int, height: int,
                    centers: torch.Tensor):
    """The binning's (conics (N, 3), radii (N,) int32) of surfels with map
    ``tmat`` and opacity ``op``: the ellipse around c that holds the image
    of the disc rho3 <= Q and the filter's circle rho2 <= Q, Q the gate
    (see the module docstring), as the conic Q S^-1 of its matrix S, and
    ceil of its half-extent plus one. Radius 0 where the disc at that level
    crosses the camera plane, the centre is nearer than 0.2, the ellipse
    misses the image or a value is not finite."""
    tu1, tu2, tv1, tv2, tw1, tw2, tw3 = tmat.unbind(-1)
    Q = _gate_q(op)
    d11 = Q * (tu1 * tu1 + tu2 * tu2)
    d12 = Q * (tu1 * tv1 + tu2 * tv2)
    d22 = Q * (tv1 * tv1 + tv2 * tv2)
    d13 = Q * (tu1 * tw1 + tu2 * tw2)
    d23 = Q * (tv1 * tw1 + tv2 * tw2)
    d33 = Q * (tw1 * tw1 + tw2 * tw2) - tw3 * tw3
    ok = d33 < 0.0
    f = -1.0 / torch.where(ok, d33, torch.full_like(d33, -1.0))
    mx, my = -f * d13, -f * d23
    s11 = f * d11 + mx * mx
    s12 = f * d12 + mx * my
    s22 = f * d22 + my * my
    # The disc's image moved from its centre m to c (its Minkowski sum with
    # the disc of radius |m|, bounded by (1 + |m| / s) S + (|m|^2 + |m| s) I,
    # s = sqrt(tr S / 2)), then the filter's circle of radius sqrt(Q / 2) at
    # c (the union of two ellipses about c lies in the ellipse of their
    # matrices' sum).
    mm = mx * mx + my * my
    mlen = torch.sqrt(mm)
    sig = torch.sqrt(torch.clamp_min(0.5 * (s11 + s22), 1e-12))
    a = 1.0 + mlen / sig
    b = mm + mlen * sig + 0.5 * Q
    grow = 1.0 + _ELLIPSE_SLACK
    e11 = (a * s11 + b) * grow
    e12 = a * s12 * grow
    e22 = (a * s22 + b) * grow
    det = e11 * e22 - e12 * e12
    det_s = torch.where(det > 0.0, det, torch.ones_like(det))
    conics = torch.stack([Q * e22 / det_s, -Q * e12 / det_s, Q * e11 / det_s], dim=-1)
    rad = torch.ceil(torch.sqrt(torch.clamp_min(torch.maximum(e11, e22), 0.0))) + 1.0
    cx, cy = centers[:, 0], centers[:, 1]
    inside = (cx + rad > 0.0) & (cx - rad < width) & (cy + rad > 0.0) & (cy - rad < height)
    finite = torch.isfinite(conics).all(-1) & torch.isfinite(rad) & torch.isfinite(centers).all(-1)
    valid = ok & (tw3 > NEAR) & (det > 0.0) & inside & finite & (rad < 2.0 ** 24)
    radii = torch.where(valid, rad, torch.zeros_like(rad)).to(torch.int32)
    return conics, radii


def project_surfels_plain(means, quats, log_scales, logit_opacities, sh_coeffs, viewmat, K,
                          width: int, height: int, sh_degree: int = 3) -> SurfelProjected:
    """``SurfelProjected`` in plain PyTorch, each quantity in the kernel's
    operation order, differentiable through autograd in every input but the
    view (the binning's conics and radii are computed without gradient).
    ``logit_opacities`` is (N,) or (N, 1)."""
    W = viewmat[:3, :3]
    t = viewmat[:3, 3]
    fx, fy, cx0, cy0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    m0, m1, m2 = means.unbind(-1)
    x = W[0, 0] * m0 + W[0, 1] * m1 + W[0, 2] * m2 + t[0]
    y = W[1, 0] * m0 + W[1, 1] * m1 + W[1, 2] * m2 + t[1]
    z = W[2, 0] * m0 + W[2, 1] * m1 + W[2, 2] * m2 + t[2]
    r, _, _, _ = _rotation(quats)
    su = torch.exp(log_scales[:, 0])
    sv = torch.exp(log_scales[:, 1])
    wtu = [W[i, 0] * r[0] + W[i, 1] * r[3] + W[i, 2] * r[6] for i in range(3)]
    wtv = [W[i, 0] * r[1] + W[i, 1] * r[4] + W[i, 2] * r[7] for i in range(3)]
    ncam = [W[i, 0] * r[2] + W[i, 1] * r[5] + W[i, 2] * r[8] for i in range(3)]
    U = [v * su for v in wtu]
    V = [v * sv for v in wtv]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    ux = x / zs
    uy = y / zs
    tmat = torch.stack([fx * (U[0] - ux * U[2]), fx * (V[0] - ux * V[2]),
                        fy * (U[1] - uy * U[2]), fy * (V[1] - uy * V[2]),
                        U[2], V[2], z], dim=-1)
    centers = torch.stack([fx * ux + cx0, fy * uy + cy0], dim=-1)
    facing = ncam[0] * x + ncam[1] * y + ncam[2] * z
    sign = torch.where(facing > 0.0, -torch.ones_like(z), torch.ones_like(z)).detach()
    normals = torch.stack([sign * v for v in ncam], dim=-1)
    op = torch.sigmoid(logit_opacities.reshape(-1))

    cam = -W.T @ t
    d = means - cam[None, :]
    dn = d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-12)
    colors = torch.clamp_min(eval_sh(sh_degree, sh_coeffs, dn) + 0.5, 0.0)
    with torch.no_grad():
        conics, radii = binning_ellipse(tmat.detach(), op.detach(), width, height,
                                        centers.detach())
    return SurfelProjected(centers, tmat, normals, z.detach(), conics, radii, colors, op)


def project_surfels_bwd_plain(means, quats, log_scales, logit_opacities, sh_coeffs, viewmat,
                              K, sh_degree: int, g_centers=None, g_tmat=None, g_normals=None,
                              g_colors=None, g_opac=None):
    """The gradients (means, quats, log_scales, logit_opacities (N,),
    sh_coeffs) of ``project_surfels_plain``'s differentiable outputs'
    cotangents (None is zero), with the view held fixed: the kernel's
    hand-derived formulas as tensor operations, the forward's intermediates
    recomputed from the inputs."""
    dt = means.dtype
    zero = torch.zeros_like(means[:, 0])

    def cols(g, k):
        return [zero] * k if g is None else list(g.reshape(-1, k).to(dt).unbind(-1))

    gcx, gcy = cols(g_centers, 2)
    gt = cols(g_tmat, 7)
    gn = cols(g_normals, 3)
    g_col = cols(g_colors, 3)
    (g_op,) = cols(g_opac, 1)

    W = viewmat[:3, :3].to(dt)
    t = viewmat[:3, 3].to(dt)
    fx, fy = K[0, 0].to(dt), K[1, 1].to(dt)

    # SH, as the static projection's backward.
    cam_pos = -W.T @ t
    d = means - cam_pos[None, :]
    nd = torch.linalg.norm(d, dim=-1)
    nc = torch.clamp_min(nd, 1e-12)
    dn = d / nc[:, None]
    from gaussian_splatting_tpu_torch.core.sh import sh_bases

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
    radial = (g_dn * dn).sum(-1, keepdim=True) * dn
    g_d = torch.where((nd >= 1e-12)[:, None], (g_dn - radial) / nc[:, None],
                      g_dn / nc[:, None])

    # The forward again.
    m0, m1, m2 = means.unbind(-1)
    x = W[0, 0] * m0 + W[0, 1] * m1 + W[0, 2] * m2 + t[0]
    y = W[1, 0] * m0 + W[1, 1] * m1 + W[1, 2] * m2 + t[1]
    z = W[2, 0] * m0 + W[2, 1] * m1 + W[2, 2] * m2 + t[2]
    r, (qw, qx, qy, qz), qn_n, inv_q = _rotation(quats)
    su = torch.exp(log_scales[:, 0])
    sv = torch.exp(log_scales[:, 1])
    wtu = [W[i, 0] * r[0] + W[i, 1] * r[3] + W[i, 2] * r[6] for i in range(3)]
    wtv = [W[i, 0] * r[1] + W[i, 1] * r[4] + W[i, 2] * r[7] for i in range(3)]
    ncam = [W[i, 0] * r[2] + W[i, 1] * r[5] + W[i, 2] * r[8] for i in range(3)]
    U = [v * su for v in wtu]
    V = [v * sv for v in wtv]
    z_small = torch.abs(z) < 1e-6
    zs = torch.where(z_small, torch.full_like(z, 1e-6), z)
    ux = x / zs
    uy = y / zs
    facing = ncam[0] * x + ncam[1] * y + ncam[2] * z
    sign = torch.where(facing > 0.0, -torch.ones_like(z), torch.ones_like(z))

    # T and c to the camera-frame axes, centre and the projected (ux, uy).
    g_ux = fx * gcx - fx * U[2] * gt[0] - fx * V[2] * gt[1]
    g_uy = fy * gcy - fy * U[2] * gt[2] - fy * V[2] * gt[3]
    gU = [fx * gt[0], fy * gt[2], -fx * ux * gt[0] - fy * uy * gt[2] + gt[4]]
    gV = [fx * gt[1], fy * gt[3], -fx * ux * gt[1] - fy * uy * gt[3] + gt[5]]
    g_zs = -(g_ux * x + g_uy * y) / (zs * zs)
    gpx = g_ux / zs
    gpy = g_uy / zs
    gpz = gt[6] + torch.where(z_small, zero, g_zs)
    # U = (W t_u) s_u, V = (W t_v) s_v, n = sign W t_w.
    g_wtu = [g * su for g in gU]
    g_wtv = [g * sv for g in gV]
    g_su = wtu[0] * gU[0] + wtu[1] * gU[1] + wtu[2] * gU[2]
    g_sv = wtv[0] * gV[0] + wtv[1] * gV[1] + wtv[2] * gV[2]
    g_log_scales = torch.stack([g_su * su, g_sv * sv], dim=-1)
    g_nc = [sign * g for g in gn]
    g_tu = [W[0, k] * g_wtu[0] + W[1, k] * g_wtu[1] + W[2, k] * g_wtu[2] for k in range(3)]
    g_tv = [W[0, k] * g_wtv[0] + W[1, k] * g_wtv[1] + W[2, k] * g_wtv[2] for k in range(3)]
    g_tw = [W[0, k] * g_nc[0] + W[1, k] * g_nc[1] + W[2, k] * g_nc[2] for k in range(3)]
    gr = [g_tu[0], g_tv[0], g_tw[0], g_tu[1], g_tv[1], g_tw[1], g_tu[2], g_tv[2], g_tw[2]]
    g_qw = 2.0 * (-qz * gr[1] + qy * gr[2] + qz * gr[3] - qx * gr[5] - qy * gr[6] + qx * gr[7])
    g_qx = 2.0 * (qy * gr[1] + qz * gr[2] + qy * gr[3] - 2.0 * qx * gr[4] - qw * gr[5]
                  + qz * gr[6] + qw * gr[7] - 2.0 * qx * gr[8])
    g_qy = 2.0 * (-2.0 * qy * gr[0] + qx * gr[1] + qw * gr[2] + qx * gr[3] + qz * gr[5]
                  - qw * gr[6] + qz * gr[7] - 2.0 * qy * gr[8])
    g_qz = 2.0 * (-2.0 * qz * gr[0] - qw * gr[1] + qx * gr[2] + qw * gr[3] - 2.0 * qz * gr[4]
                  + qy * gr[5] + qx * gr[6] + qy * gr[7])
    g_qn = torch.stack([g_qw, g_qx, g_qy, g_qz], dim=-1)
    qn = torch.stack([qw, qx, qy, qz], dim=-1)
    tang = g_qn - (g_qn * qn).sum(-1, keepdim=True) * qn
    g_quats = torch.where((qn_n >= 1e-12)[:, None], tang, g_qn) * inv_q[:, None]

    g_means = torch.stack([gpx, gpy, gpz], dim=-1) @ W + g_d
    op = torch.sigmoid(logit_opacities.reshape(-1).to(dt))
    g_logit = g_op * op * (1.0 - op)
    return g_means, g_quats, g_log_scales, g_logit, g_sh


def _surfel_inputs(means, quats, log_scales, logit_opacities, sh_coeffs, viewmat, K):
    n = means.shape[0]
    ins = [x.contiguous() for x in (means, quats, log_scales, logit_opacities.reshape(-1),
                                    sh_coeffs)]
    shapes = [(n, 3), (n, 4), (n, 2), (n,), (n, sh_coeffs.shape[1], 3)]
    for name, x, shape in zip(("means", "quats", "log_scales", "logit_opacities", "sh_coeffs"),
                              ins, shapes):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or x.device != means.device:
            raise ValueError(f"{name} must be {shape} float32 on {means.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    cam = [viewmat.to(device=means.device, dtype=torch.float32).contiguous(),
           K.to(device=means.device, dtype=torch.float32).contiguous()]
    if tuple(cam[0].shape) != (4, 4) or tuple(cam[1].shape) != (3, 3):
        raise ValueError("viewmat must be (4, 4) and K (3, 3)")
    return ins + cam


def _launch_project(which: str, ins, width, height, sh_degree, tensors) -> None:
    n, kb = ins[0].shape[0], ins[4].shape[1]
    if n == 0:
        return
    fn = getattr(_build.load("project_sh"), f"gs_project_surfel_{which}")
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p] * (len(ins) + len(tensors) + 1))
    fn.restype = ctypes.c_int
    with torch.cuda.device(ins[0].device):
        rc = fn(n, kb, sh_degree, float(width), float(height),
                *(_ptr(t) for t in (*ins, *tensors)), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"project_surfel {which} kernel launch failed: cudaError {rc}")
    profiling.count(f"launch.project_surfel_{which}")


class _ProjectSurfels(torch.autograd.Function):
    """``project_surfels_plain`` with the view held fixed: the kernel pair on
    CUDA tensors, the plain forward and hand-derived backward on CPU
    tensors. Saves only the inputs."""

    @staticmethod
    def forward(ctx, means, quats, log_scales, logit_opacities, sh_coeffs, viewmat, K, cfg):
        width, height, sh_degree = cfg
        ins = _surfel_inputs(means, quats, log_scales, logit_opacities, sh_coeffs, viewmat, K)
        if means.device.type == "cuda":
            n, dev = means.shape[0], means.device
            out = [torch.empty((n, 2), device=dev), torch.empty((n, 7), device=dev),
                   torch.empty((n, 3), device=dev), torch.empty((n,), device=dev),
                   torch.empty((n, 3), device=dev),
                   torch.empty((n,), dtype=torch.int32, device=dev),
                   torch.empty((n, 3), device=dev), torch.empty((n,), device=dev)]
            _launch_project("fwd", ins, width, height, sh_degree, out)
        elif means.device.type == "cpu":
            out = list(project_surfels_plain(*ins, width, height, sh_degree))
        else:
            raise ValueError(f"project_surfels runs on CUDA or CPU tensors, not {means.device}")
        ctx.mark_non_differentiable(out[3], out[4], out[5])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*ins)
        ctx.cfg = cfg
        return tuple(out)

    @staticmethod
    def backward(ctx, g_centers, g_tmat, g_normals, _gd, _gc, _gr, g_colors, g_opac):
        ins = ctx.saved_tensors
        width, height, sh_degree = ctx.cfg
        grads = (g_centers, g_tmat, g_normals, g_colors, g_opac)
        if ins[0].device.type == "cuda":
            out = [torch.empty_like(x) for x in ins[:5]]
            grads = [None if g is None else g.to(torch.float32).contiguous() for g in grads]
            _launch_project("bwd", ins, width, height, sh_degree, [*grads, *out])
        else:
            out = project_surfels_bwd_plain(*ins[:7], sh_degree, *grads)
        need = ctx.needs_input_grad
        g = [o if nd else None for o, nd in zip(out, need[:5])]
        if g[3] is not None:
            g[3] = g[3].reshape(ctx.saved_tensors[3].shape)
        return (*g, None, None, None)


def project_surfels(means, quats, log_scales, logit_opacities, sh_coeffs, viewmat, K,
                    width: int, height: int, sh_degree: int = 3) -> SurfelProjected:
    """``project_surfels_plain``'s outputs through the kernel pair (CUDA) or
    the plain forward and hand-derived backward (CPU); the view gets no
    gradient. ``logit_opacities`` is (N,)."""
    if not 0 <= sh_degree <= 3 or sh_coeffs.shape[1] < (sh_degree + 1) ** 2:
        raise ValueError(f"sh_degree {sh_degree} needs 0..3 and at least "
                         f"{(sh_degree + 1) ** 2} SH bases, got {sh_coeffs.shape[1]}")
    out = _ProjectSurfels.apply(means, quats, log_scales, logit_opacities.reshape(-1),
                                sh_coeffs, viewmat, K, (width, height, sh_degree))
    return SurfelProjected(*out)


# ---- raster: per (pixel, entry) --------------------------------------------------


def _eval(px, py, cx, cy, tu1, tu2, tv1, tv2, tw1, tw2, tw3, op):
    """The kernel's per-(pixel, entry) arithmetic (``rasterize_surfel.cu::
    eval_surfel``), the same float32 operations in the same order."""
    dx = px - cx
    dy = py - cy
    k1 = dx * tw1 - tu1
    k2 = dx * tw2 - tu2
    k3 = dx * tw3
    l1 = dy * tw1 - tv1
    l2 = dy * tw2 - tv2
    l3 = dy * tw3
    p1 = k2 * l3 - k3 * l2
    p2 = k3 * l1 - k1 * l3
    p3 = k1 * l2 - k2 * l1
    hit = p3 != 0.0
    p3s = torch.where(hit, p3, torch.ones_like(p3))
    u = p1 / p3s
    v = p2 / p3s
    rho3 = u * u + v * v
    rho2 = FILTER_INV_SQ * (dx * dx + dy * dy)
    disc = hit & (rho3 <= rho2)
    rho = torch.where(disc, rho3, rho2)
    vis = torch.exp(-0.5 * rho)
    araw = op * vis
    z = torch.where(disc, (u * tw1 + v * tw2) + tw3, tw3)
    contrib = hit & (z >= NEAR) & (araw >= ALPHA_SKIP)
    alpha = torch.where(contrib, torch.clamp_max(araw, ALPHA_CLAMP), torch.zeros_like(araw))
    return dict(dx=dx, dy=dy, k=(k1, k2, k3), l=(l1, l2, l3), p3=p3s, u=u, v=v, disc=disc,
                vis=vis, araw=araw, z=z, contrib=contrib, alpha=alpha)


def _tile_data(soa_a, soa_b, st, pos, cnt):
    """The entries ``pos`` of a batch of tiles (starts ``st``, counts
    ``cnt``): (valid (B, K), soa_a's (16, B, K), soa_b's)."""
    valid = pos[None, :] < cnt[:, None]
    col = torch.where(valid, st[:, None] + pos[None, :], 0)
    return valid, soa_a[:, col], soa_b[:, col]


def surfel_fwd_plain(tile_starts: torch.Tensor, counts: torch.Tensor, soa_a: torch.Tensor,
                     soa_b: torch.Tensor, tile_size: int, ntx: int, chunk: int):
    """Plain PyTorch version of the surfel forward kernel. Returns ``(out,
    pairs)``: ``out`` (T, 12, P) rows [r, g, b, depth, alpha, nx, ny, nz,
    distortion, median depth, M1, M2], and the (pixel, entry) pairs that
    carry a weight. A per-chunk loop over batches of tiles, with the static
    kernels' chunk-carried stop rule (``rasterize_cuda.fwd_tiles_plain``)."""
    T = counts.shape[0]
    P = tile_size * tile_size
    dev = soa_a.device
    out = torch.zeros((T, OUT_ROWS, P), dtype=torch.float32, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    for tiles, longest in _plain_batches(counts, chunk, P, _PLAIN_ELEMS):
        cnt = counts[tiles].long()
        st = tile_starts[tiles].long()
        px, py = _pixel_centres(tiles, tile_size, ntx)
        B = tiles.shape[0]
        acc = torch.zeros((B, OUT_ROWS, P), dtype=torch.float32, device=dev)
        tcar = torch.ones((B, P, 1), dtype=torch.float32, device=dev)
        med = torch.zeros((B, P), dtype=torch.float32, device=dev)
        for c0 in range(0, longest, chunk):
            pos = c0 + torch.arange(min(chunk, longest - c0), device=dev)
            valid, a, b = _tile_data(soa_a, soa_b, st, pos, cnt)
            a = [a[i][:, None, :] for i in range(10)]
            e = _eval(px, py, *a)
            contrib = e["contrib"] & valid[:, None, :]
            alpha = torch.where(contrib, e["alpha"], 0.0)
            prod_incl = _cumprod_sequential(1.0 - alpha)
            prod_excl = torch.cat([torch.ones_like(prod_incl[..., :1]), prod_incl[..., :-1]], -1)
            mask = tcar * prod_incl > T_EARLY_STOP
            keep = mask & contrib
            t_before = tcar * prod_excl
            w = torch.where(keep, alpha * tcar * prod_excl, 0.0)
            z = torch.where(keep, e["z"], 0.0)
            m = torch.where(keep, M_SCALE * (1.0 - NEAR / torch.where(keep, e["z"], 1.0)), 0.0)
            a_ex = acc[:, 4, :, None] + torch.cumsum(w, -1) - w
            m1_ex = acc[:, 10, :, None] + torch.cumsum(w * m, -1) - w * m
            m2_ex = acc[:, 11, :, None] + torch.cumsum(w * m * m, -1) - w * m * m
            acc[:, 8] += (w * (m * m * a_ex + m2_ex - 2.0 * m * m1_ex)).sum(-1)
            for row in range(3):
                acc[:, row] += (w * b[row][:, None, :]).sum(-1)
                acc[:, 5 + row] += (w * b[3 + row][:, None, :]).sum(-1)
            acc[:, 3] += (w * z).sum(-1)
            acc[:, 4] += w.sum(-1)
            acc[:, 10] += (w * m).sum(-1)
            acc[:, 11] += (w * m * m).sum(-1)
            cand = keep & (t_before > 0.5)
            K_ = cand.shape[-1]
            last = torch.where(cand, torch.arange(K_, device=dev), -1).amax(-1)
            med = torch.where(last >= 0, torch.gather(z, -1, last.clamp_min(0)[..., None])[..., 0],
                              med)
            tcar = tcar * torch.where(mask, prod_incl, 1.0).amin(-1, keepdim=True)
            pairs += keep.sum()
        acc[:, 9] = med
        out[tiles] = acc
    return out, pairs


def surfel_bwd_plain(tile_starts: torch.Tensor, counts: torch.Tensor, soa_a: torch.Tensor,
                     soa_b: torch.Tensor, gout: torch.Tensor, fout: torch.Tensor,
                     tile_size: int, ntx: int, chunk: int, n_gaussians: int, grad_cap: int):
    """Plain PyTorch version of the surfel backward kernel. Returns ``(grad,
    meta, active)``: the (32, grad_cap) stream (rows 0-15 [id, dcx, dcy,
    dT (7), dop, 0...], rows 16-31 [id, dr, dg, db, dn (3), 0...]) with the
    columns in tile order as ``rasterize_cuda.bwd_tiles_plain`` orders
    them, meta [n_written, n_dropped] and the pairs with gradient terms.
    The forward is recomputed as ``surfel_fwd_plain`` computes it; the
    distortion's gradient reads the pixel's final alpha, M1 and M2."""
    ts = tile_size
    P = ts * ts
    dev = soa_a.device
    grad = torch.empty((32, grad_cap), dtype=torch.float32, device=dev)
    excl = torch.cumsum(counts.long(), 0) - counts.long()
    total = int(counts.sum())
    n_chunks_total = cdiv(total, chunk)
    kept = min(n_chunks_total, grad_cap // chunk) * chunk
    grad[:, :kept] = 0.0
    grad[0, :kept] = float(n_gaussians)
    grad[16, :kept] = float(n_gaussians)
    active = torch.zeros((), dtype=torch.int64, device=dev)
    for tiles, longest in _plain_batches(counts, chunk, P, _PLAIN_ELEMS):
        cnt = counts[tiles].long()
        st = tile_starts[tiles].long()
        px, py = _pixel_centres(tiles, ts, ntx)
        g = gout[tiles]
        f = fout[tiles]
        gc = [g[:, c, :, None] for c in range(9)]
        A, M1, M2 = (f[:, c, :, None] for c in (4, 10, 11))
        lc = A * M2 - M1 * M1
        q = (sum(g[:, c] * f[:, c] for c in range(8)) + 2.0 * g[:, 8] * lc[..., 0])[..., None]
        tcar = torch.ones((tiles.shape[0], P, 1), dtype=torch.float32, device=dev)
        pcar = torch.zeros((tiles.shape[0], P, 1), dtype=torch.float32, device=dev)
        for c0 in range(0, longest, chunk):
            pos = c0 + torch.arange(min(chunk, longest - c0), device=dev)
            valid, a, b = _tile_data(soa_a, soa_b, st, pos, cnt)
            av = [a[i][:, None, :] for i in range(10)]
            bv = [b[i][:, None, :] for i in range(6)]
            e = _eval(px, py, *av)
            contrib = e["contrib"] & valid[:, None, :]
            alpha = torch.where(contrib, e["alpha"], 0.0)
            prod_incl = _cumprod_sequential(1.0 - alpha)
            prod_excl = torch.cat([torch.ones_like(prod_incl[..., :1]), prod_incl[..., :-1]], -1)
            mask = tcar * prod_incl > T_EARLY_STOP
            keep = mask & contrib
            t_before = tcar * prod_excl
            w = torch.where(keep, alpha * t_before, 0.0)
            zk = torch.where(keep, e["z"], 1.0)
            m = M_SCALE * (1.0 - NEAR / zk)
            f_l = M2 + A * m * m - 2.0 * M1 * m
            gw = (gc[0] * bv[0] + gc[1] * bv[1] + gc[2] * bv[2] + gc[3] * zk + gc[4]
                  + gc[5] * bv[3] + gc[6] * bv[4] + gc[7] * bv[5] + gc[8] * f_l)
            gww = torch.where(keep, gw * w, 0.0)
            prefix = pcar + torch.cumsum(gww, -1)
            d_alpha = torch.where(keep, gw * t_before - (q - prefix) / (1.0 - alpha), 0.0)
            active += keep.sum()
            gate = keep & (e["araw"] <= ALPHA_CLAMP)
            d_rho = torch.where(gate, -0.5 * d_alpha * e["araw"], 0.0)
            d_op = torch.where(gate, d_alpha * e["vis"], 0.0)
            dz = torch.where(keep, w * (gc[3] + gc[8] * 2.0 * (A * m - M1) * M_SCALE * NEAR
                                        / (zk * zk)), 0.0)
            disc = e["disc"] & keep
            u, v, p3 = e["u"], e["v"], e["p3"]
            tw1, tw2, tw3 = av[6], av[7], av[8]
            d_rho3 = torch.where(disc, d_rho, 0.0)
            d_rho2 = torch.where(disc, 0.0, d_rho)
            du = torch.where(disc, 2.0 * u * d_rho3 + dz * tw1, 0.0)
            dv = torch.where(disc, 2.0 * v * d_rho3 + dz * tw2, 0.0)
            dp1 = du / p3
            dp2 = dv / p3
            dp3 = -(du * u + dv * v) / p3
            dp1, dp2, dp3 = (torch.where(disc, x, 0.0) for x in (dp1, dp2, dp3))
            k1, k2, k3 = e["k"]
            l1, l2, l3 = e["l"]
            dk1 = l2 * dp3 - l3 * dp2
            dk2 = l3 * dp1 - l1 * dp3
            dk3 = l1 * dp2 - l2 * dp1
            dl1 = dp2 * k3 - dp3 * k2
            dl2 = dp3 * k1 - dp1 * k3
            dl3 = dp1 * k2 - dp2 * k1
            dx, dy = e["dx"], e["dy"]
            d_tw1 = torch.where(disc, dz * u, 0.0) + dx * dk1 + dy * dl1
            d_tw2 = torch.where(disc, dz * v, 0.0) + dx * dk2 + dy * dl2
            d_tw3 = dz + dx * dk3 + dy * dl3
            ddx = tw1 * dk1 + tw2 * dk2 + tw3 * dk3 + 2.0 * FILTER_INV_SQ * dx * d_rho2
            ddy = tw1 * dl1 + tw2 * dl2 + tw3 * dl3 + 2.0 * FILTER_INV_SQ * dy * d_rho2
            rows_a = (-ddx, -ddy, -dk1, -dk2, -dl1, -dl2, d_tw1, d_tw2, d_tw3, d_op)
            rows_b = tuple(w * gc[c] for c in (0, 1, 2, 5, 6, 7))
            dest = (excl[tiles, None] + pos[None, :])[valid]
            ok = dest < kept
            dest = dest[ok]
            idv = a[11]                                   # SoA row 11: the surfel id
            grad[0, dest] = idv[valid][ok]
            grad[16, dest] = idv[valid][ok]
            for r, val in enumerate(rows_a):
                grad[1 + r, dest] = val.sum(1)[valid][ok]
            for r, val in enumerate(rows_b):
                grad[17 + r, dest] = val.sum(1)[valid][ok]
            tcar = tcar * torch.where(mask, prod_incl, 1.0).amin(-1, keepdim=True)
            pcar = pcar + gww.sum(-1, keepdim=True)
    meta = torch.tensor([kept, n_chunks_total * chunk - kept], dtype=torch.int32, device=dev)
    return grad, meta, active


def _check_surfel_args(tile_starts, counts, soa_a, soa_b, tile_size, chunk):
    _check_fwd_args(tile_starts, counts, soa_a, tile_size, chunk)
    if soa_b.dtype != torch.float32 or tuple(soa_b.shape) != tuple(soa_a.shape):
        raise ValueError(f"soa_b must be {tuple(soa_a.shape)} float32 like soa_a, got "
                         f"{tuple(soa_b.shape)} {soa_b.dtype}")
    if soa_b.device != soa_a.device or not soa_b.is_contiguous():
        raise ValueError("soa_b must be contiguous and on soa_a's device")


def surfel_fwd(tile_starts: torch.Tensor, counts: torch.Tensor, soa_a: torch.Tensor,
               soa_b: torch.Tensor, tile_size: int, ntx: int, chunk: int) -> torch.Tensor:
    """Forward blend of every tile's segment of surfels: (T, 12, P) rows
    [r, g, b, depth, alpha, nx, ny, nz, distortion, median depth, M1, M2].
    CUDA tensors run the kernel (``csrc/rasterize_surfel.cu``), CPU tensors
    the plain version."""
    _check_surfel_args(tile_starts, counts, soa_a, soa_b, tile_size, chunk)
    if soa_a.device.type == "cpu":
        return surfel_fwd_plain(tile_starts, counts, soa_a, soa_b, tile_size, ntx, chunk)[0]
    if soa_a.device.type != "cuda":
        raise ValueError(f"surfel_fwd runs on CUDA or CPU tensors, not {soa_a.device}")
    fn = _build.load("rasterize_surfel").gs_surfel_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    T = counts.shape[0]
    out = torch.empty((T, OUT_ROWS, tile_size * tile_size), dtype=torch.float32,
                      device=soa_a.device)
    with torch.cuda.device(soa_a.device):
        rc = fn(tile_starts.data_ptr(), counts.data_ptr(), soa_a.data_ptr(), soa_b.data_ptr(),
                soa_a.shape[1], out.data_ptr(), T, tile_size, ntx, chunk,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"surfel_raster_fwd kernel launch failed: cudaError {rc}")
    profiling.count("launch.surfel_raster_fwd")
    return out


def surfel_bwd(tile_starts: torch.Tensor, counts: torch.Tensor, soa_a: torch.Tensor,
               soa_b: torch.Tensor, gout: torch.Tensor, fout: torch.Tensor, tile_size: int,
               ntx: int, chunk: int, n_gaussians: int, grad_cap: int):
    """Backward sweep of every tile's segment of surfels. ``gout`` is the
    cotangent of the forward output ``fout`` (both (T, 12, P); rows 9-11
    take none). Returns ``(grad, meta)``: the (32, grad_cap) stream of
    ``surfel_bwd_plain`` and [n_written, n_dropped], counted in whole chunks
    as ``rasterize_cuda.bwd_tiles`` counts them. CUDA tensors run the kernel
    (its column order changes from run to run), CPU tensors the plain
    version."""
    _check_surfel_args(tile_starts, counts, soa_a, soa_b, tile_size, chunk)
    shape = (counts.shape[0], OUT_ROWS, tile_size * tile_size)
    for name, x in (("gout", gout), ("fout", fout)):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape} float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if grad_cap < chunk or grad_cap % chunk:
        raise ValueError("grad_cap must be a positive multiple of chunk")
    if soa_a.device.type == "cpu":
        return surfel_bwd_plain(tile_starts, counts, soa_a, soa_b, gout, fout, tile_size, ntx,
                                chunk, n_gaussians, grad_cap)[:2]
    if soa_a.device.type != "cuda":
        raise ValueError(f"surfel_bwd runs on CUDA or CPU tensors, not {soa_a.device}")
    fn = _build.load("rasterize_surfel").gs_surfel_bwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    grad = torch.empty((32, grad_cap), dtype=torch.float32, device=soa_a.device)
    meta = torch.empty((3,), dtype=torch.int32, device=soa_a.device)
    with torch.cuda.device(soa_a.device):
        rc = fn(tile_starts.data_ptr(), counts.data_ptr(), soa_a.data_ptr(), soa_b.data_ptr(),
                soa_a.shape[1], gout.data_ptr(), fout.data_ptr(), grad.data_ptr(), grad_cap,
                meta.data_ptr(), counts.shape[0], tile_size, ntx, chunk, float(n_gaussians),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"surfel_raster_bwd kernel launch failed: cudaError {rc}")
    profiling.count("launch.surfel_raster_bwd")
    return grad, meta[:2]


SURFEL_GRAD_KEYS = ("dcx", "dcy", "dtu1", "dtu2", "dtv1", "dtv2", "dtw1", "dtw2", "dtw3", "dop",
                    "dr", "dg", "db", "dnx", "dny", "dnz")


def reduce_surfel_grads(grad: torch.Tensor, n_gaussians: int, n_written: torch.Tensor,
                        sort_slices: int = 0) -> torch.Tensor:
    """Per-surfel sums (16, N) of the (32, pcap) stream, rows in
    ``SURFEL_GRAD_KEYS`` order: ``tiling.reduce_padded_grads`` with one id
    sort a slice shared by the stream's two halves, each half packed
    (``pack_rows``, 11 and 7 rows) and summed (``segment_sum_sorted``)."""
    from gaussian_splatting_tpu_torch.ops.segsum import segment_sum_sorted

    N = n_gaussians
    pcap = grad.shape[1]
    K = max(int(sort_slices), 1)
    if pcap % K != 0:
        K = 1
    m = pcap // K
    n_valid = n_written.reshape(1).to(torch.int32)
    half_a, half_b = grad[:16], grad[16:]
    sums = None
    for i in range(K):
        key_sorted, perm = sorted_gid_key(half_a, N, n_valid, i * m, m)
        a = segment_sum_sorted(pack_rows(half_a, perm, key_sorted, n_valid, i * m,
                                         GRAD_ROWS_A, float(N)), N, GRAD_ROWS_A)
        b = segment_sum_sorted(pack_rows(half_b, perm, key_sorted, n_valid, i * m,
                                         GRAD_ROWS_B, float(N)), N, GRAD_ROWS_B)
        part = torch.cat([a[1:GRAD_ROWS_A], b[1:GRAD_ROWS_B]])
        sums = part if sums is None else sums + part
    return sums


def surfel_records(p: SurfelProjected):
    """The two (N, 10) record tables ``pack_soa`` gathers for the surfel
    kernels: [cx, cy, T (7), o] and [r, g, b, n (3), the binning conic (3),
    0]."""
    rec_a = torch.cat([p.centers, p.tmat, p.opac[:, None]], dim=1)
    rec_b = torch.cat([p.colors, p.normals, p.conics, torch.zeros_like(p.opac[:, None])], dim=1)
    return (rec_a.to(torch.float32).contiguous(), rec_b.to(torch.float32).contiguous())


def second_soa(records_b: torch.Tensor, soa_a: torch.Tensor) -> torch.Tensor:
    """The second SoA, the same width as ``soa_a`` (``isect_and_sort``'s
    of the first records), gathered from ``records_b`` through ``soa_a``'s id
    row (row 11, exact floats; 0 in the columns no kernel reads)."""
    return pack_soa(records_b, soa_a[11].to(torch.int32), pad=0)


class _SurfelConfig(NamedTuple):
    width: int
    height: int
    ts: int
    chunk: int
    max_t: int
    grad_cap: int
    reduce_slices: int
    sort_buckets: int
    bucket_headroom: float
    class_budgets: Optional[tuple]
    depth_bits: int
    sort_bands: int


class _RasterizeSurfels(torch.autograd.Function):
    """Binning + the surfel forward kernel; the backward runs the surfel
    backward kernel and the per-surfel reduce."""

    @staticmethod
    def forward(ctx, centers, tmat, normals, colors, opac, conics, depths, radii, cfg):
        rec_a, rec_b = surfel_records(SurfelProjected(centers, tmat, normals, depths, conics,
                                                      radii, colors, opac))
        with profiling.annotate("render.binning"):
            b = isect_and_sort(centers, conics, colors, opac, depths, radii, cfg.width,
                               cfg.height, cfg.ts, cfg.chunk, cfg.max_t,
                               class_budgets=cfg.class_budgets, depth_bits=cfg.depth_bits,
                               sort_buckets=cfg.sort_buckets, sort_bands=cfg.sort_bands,
                               bucket_headroom=cfg.bucket_headroom, records=rec_a)
            soa_b = second_soa(rec_b, b.sorted_soa)
        ntx = cdiv(cfg.width, cfg.ts)
        with profiling.annotate("render.raster_fwd"):
            out = surfel_fwd(b.tile_starts, b.counts, b.sorted_soa, soa_b, cfg.ts, ntx,
                             cfg.chunk)
        n_grad_dropped = torch.clamp_min(b.n_isect + cfg.chunk - cfg.grad_cap, 0)
        n_budget_dropped = b.n_budget_dropped + b.n_bucket_dropped
        ctx.mark_non_differentiable(b.n_isect, b.n_dropped, n_budget_dropped, n_grad_dropped)
        ctx.save_for_backward(b.sorted_soa, soa_b, b.tile_starts, b.counts, out)
        ctx.cfg = cfg
        ctx.n = centers.shape[0]
        return out, b.n_isect, b.n_dropped, n_budget_dropped, n_grad_dropped

    @staticmethod
    def backward(ctx, g_out, *_):
        cfg = ctx.cfg
        soa_a, soa_b, tile_starts, counts, out = ctx.saved_tensors
        N = ctx.n
        g = torch.zeros_like(out) if g_out is None else g_out.contiguous()
        ntx = cdiv(cfg.width, cfg.ts)
        with profiling.annotate("render.raster_bwd"):
            grad, meta = surfel_bwd(tile_starts, counts, soa_a, soa_b, g, out, cfg.ts, ntx,
                                    cfg.chunk, N, cfg.grad_cap)
        with profiling.annotate("render.reduce"):
            s = reduce_surfel_grads(grad, N, meta[0], cfg.reduce_slices)
        return (s[0:2].T, s[2:9].T, s[13:16].T, s[10:13].T, s[9], None, None, None, None)


def rasterize_surfels(p: SurfelProjected, width: int, height: int, bg=None, tile_size: int = 16,
                      chunk: int = 256, max_tiles_per_gaussian: int = 16, class_budgets=None,
                      depth_bits: int = 0, sort_buckets: int = 0, sort_bands: int = 0,
                      grad_buffer_frac: float = 1.0, reduce_slices: int = 0,
                      bucket_headroom: float = 1.5):
    """Binning + the surfel kernels (plain versions for CPU tensors) of one
    view's ``SurfelProjected``. Returns ``(maps (H, W, 12), stats)``: the
    forward's rows as image channels, the colour with ``bg`` composited
    under (1 - alpha), and the binning's overflow counters. Differentiable
    with respect to the centres, the maps T, the normals, the colours and
    the opacities; the median depth and the sums M1, M2 take no gradient.
    The binning options are ``rasterize_cuda.rasterize_tiled``'s."""
    ts = tile_size
    if ts * ts not in (64, 256, 1024):
        raise ValueError("tile_size must be 8, 16, or 32")
    ntx, nty = cdiv(width, ts), cdiv(height, ts)
    budgets = None if class_budgets is None else tuple(int(b) for b in class_budgets)
    N = p.centers.shape[0]
    cfg = _SurfelConfig(width, height, ts, chunk, max_tiles_per_gaussian,
                        grad_cap(N, max_tiles_per_gaussian, chunk, grad_buffer_frac, budgets,
                                 sort_bands),
                        int(reduce_slices), int(sort_buckets), float(bucket_headroom), budgets,
                        int(depth_bits), int(sort_bands))
    out, n_isect, n_dropped, n_budget_dropped, n_grad_dropped = _RasterizeSurfels.apply(
        p.centers, p.tmat, p.normals, p.colors, p.opac, p.conics, p.depths, p.radii, cfg)
    img = out.reshape(nty, ntx, OUT_ROWS, ts, ts).permute(0, 3, 1, 4, 2)
    img = img.reshape(nty * ts, ntx * ts, OUT_ROWS)[:height, :width]
    if bg is not None:
        rgb = img[..., :3] + (1.0 - img[..., 4])[..., None] * bg[None, None, :]
        img = torch.cat([rgb, img[..., 3:]], dim=-1)
    return img, {"n_isect": n_isect, "n_dropped": n_dropped,
                 "n_budget_dropped": n_budget_dropped, "n_grad_dropped": n_grad_dropped}


def surfel_screen(means, quats, log_scales, logit_opacities, viewmat, K, width: int,
                  height: int):
    """(centres, conics, radii, opacities) of the binning, without gradient:
    what the trainer's footprint measurement reads of a surfel scene."""
    with torch.no_grad():
        sh = torch.zeros((means.shape[0], 1, 3), dtype=means.dtype, device=means.device)
        p = project_surfels_plain(means, quats, log_scales, logit_opacities, sh, viewmat, K,
                                  width, height, 0)
    return p.centers, p.conics, p.radii, p.opac
