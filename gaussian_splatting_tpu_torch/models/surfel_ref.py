"""The plain reference of 2D Gaussian Splatting (Huang et al., SIGGRAPH 2024,
arXiv 2403.17888; code ``github.com/hbb1/2d-gaussian-splatting``, rasterizer
``diff-surfel-rasterization``) in plain float32 PyTorch, written from the
paper and its code, apart from the port: it imports nothing of ``ops/`` or
``csrc/`` and no JAX.

- The surfel: centre p, rotation R = [t_u, t_v, t_w] of the normalized
  quaternion, two scales, normal t_w, opacity sigmoid(logit), SH colour
  max(SH + 0.5, 0) along the view direction.
- The splat-to-screen map T = [K W s_u t_u, K W s_v t_v, K (W p + t)] (rows
  T_u, T_v, T_w), written in pixel coordinates centred at the projected
  centre c (``project``): the published map moved by -c, so that T_u3 =
  T_v3 = 0 and the same (u, v) comes out at every pixel.
- The ray-splat intersection k = x T_w - T_u, l = y T_w - T_v, (u, v) = (k x
  l)_{1,2} / (k x l)_3; rho3 = u^2 + v^2; the object-space low-pass filter
  rho2 = |(x, y) - c|^2 / sigma^2, sigma = sqrt(2) / 2; rho = min(rho3, rho2),
  alpha = min(o e^(-rho / 2), 0.999); the entry's depth u T_w1 + v T_w2 +
  T_w3 where rho3 <= rho2, else T_w3; an entry counts where (k x l)_3 != 0,
  its depth is at least 0.2 and alpha >= 1/255.
- Blending front to back in the order of the tile lists (``tile_lists``)
  with the port's chunk-carried stop rule: inside a chunk of ``chunk``
  entries an entry counts while T_carry prod_{j<=k}(1 - alpha_j) > 1e-4.
  Maps: colour, expected depth sum w z, alpha, normal sum w n (the view-space
  normal turned to face the camera), median depth (the depth of the last
  entry with transmittance above 0.5 before it), and the depth distortion
  sum_{j<i} w_i w_j (m_i - m_j)^2 with m = f / (f - n) (1 - n / z), n = 0.2, f
  = 100, accumulated in one pass from A = sum w, M1 = sum w m, M2 = sum w m^2.
- Normal consistency (``normal_loss``): the surface depth (expected depth /
  alpha at ``depth_ratio`` 0, else blended with the median), unprojected
  through each pixel centre to world points, central differences, their
  cross product normalized and multiplied by the (detached) alpha; the term
  is mean(1 - n_rendered . N_s) with n_rendered in world space. Distortion:
  the mean of the map.
- A training view's loss (``view_loss``): (1 - lambda) L1 + lambda (1 -
  SSIM) of the straight-through-clamped colour (3x3 average-pool SSIM) plus
  the two terms with their weights; gradients by autograd.

The tile lists (``tile_lists``) are the port's dense binning: the tiles of
the axis-aligned window of the binning ellipse (the image of the disc at
the 1/255 gate, grown to hold the filter's circle) that pass the exact
ellipse/tile test, each tile's surfels by centre depth, with no tile cap.

Departures from the published code, each kept because the port does the
same:
- alpha is clamped at 0.999 (the published rasterizer clamps at 0.99);
- the filter's centre is the projected centre c (the published rasterizer
  takes the centre of the 3-sigma disc image's bounding box) and a pixel's
  centre is (x + 0.5, y + 0.5), the port's pixel convention;
- the screen footprint is that ellipse at the port's 1/255 gate (the
  published code bins the 3-sigma disc's bounding box), and a surfel whose
  disc at that level crosses the camera plane is culled;
- the densify statistic is ||dL/d p|| of the 3D centre summed into all three
  accumulator columns, as the static port accumulates it (the published code
  accumulates the screen-space centre's gradient); a split draws its
  children in the tangent plane, s_u n_1 t_u + s_v n_2 t_v at the child's
  scales (the published code draws at the parent's);
- the normal term starts at iteration 7000 and the distortion term at 3000
  of the port's counter, which starts at 0 (the published code tests
  ``iteration > 7000`` with a counter that starts at 1).

``torch.backends.cuda.matmul.allow_tf32`` and ``cudnn.allow_tf32`` are set
False on import: the reference's products are float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NEAR = 0.2
FAR = 100.0
FILTER_INV_SQ = 2.0
ALPHA_CLAMP = 0.999
ALPHA_SKIP = 1.0 / 255.0
T_EARLY_STOP = 1e-4
WINDOW_EPS = 0.5
ELLIPSE_SLACK = 1e-3
LAMBDA_DIST_FROM = 3000
LAMBDA_NORMAL_FROM = 7000

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class Proj(NamedTuple):
    centers: torch.Tensor  # (N, 2)
    tmat: torch.Tensor     # (N, 7) T_u1 T_u2 T_v1 T_v2 T_w1 T_w2 T_w3
    normals: torch.Tensor  # (N, 3)
    depths: torch.Tensor   # (N,)
    conics: torch.Tensor   # (N, 3) the binning ellipse at the gate
    radii: torch.Tensor    # (N,) int32
    colors: torch.Tensor   # (N, 3)
    opac: torch.Tensor     # (N,)


def sh_color(degree: int, coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """max(SH + 0.5, 0) of ``coeffs`` (N, K, 3) at unit ``dirs`` (N, 3)."""
    res = SH_C0 * coeffs[:, 0]
    if degree >= 1:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        res = res - SH_C1 * y * coeffs[:, 1] + SH_C1 * z * coeffs[:, 2] - SH_C1 * x * coeffs[:, 3]
        if degree >= 2:
            xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
            res = (res + SH_C2[0] * xy * coeffs[:, 4] + SH_C2[1] * yz * coeffs[:, 5]
                   + SH_C2[2] * (2.0 * zz - xx - yy) * coeffs[:, 6]
                   + SH_C2[3] * xz * coeffs[:, 7] + SH_C2[4] * (xx - yy) * coeffs[:, 8])
            if degree >= 3:
                res = (res + SH_C3[0] * y * (3.0 * xx - yy) * coeffs[:, 9]
                       + SH_C3[1] * xy * z * coeffs[:, 10]
                       + SH_C3[2] * y * (4.0 * zz - xx - yy) * coeffs[:, 11]
                       + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * coeffs[:, 12]
                       + SH_C3[4] * x * (4.0 * zz - xx - yy) * coeffs[:, 13]
                       + SH_C3[5] * z * (xx - yy) * coeffs[:, 14]
                       + SH_C3[6] * x * (xx - 3.0 * yy) * coeffs[:, 15])
    return torch.clamp_min(res + 0.5, 0.0)


def rotation(q: torch.Tensor):
    """Row-major entries of the rotation of the normalized quaternion."""
    w, x, y, z = q.unbind(-1)
    inv = 1.0 / torch.clamp_min(torch.sqrt(w * w + x * x + y * y + z * z), 1e-12)
    w, x, y, z = w * inv, x * inv, y * inv, z * inv
    return (1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y),
            2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x),
            2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y))


def gate_q(op: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(2.0 * (torch.log(255.0 * torch.clamp_min(op, 1e-12)) + 1e-3), 0.0)


def footprint(tmat, op, centers, width: int, height: int):
    """The binning ellipse as a conic at the gate, and its radius (0 =
    culled): the ellipse of the dual conic T diag(Q, Q, -1) T^T (the disc's
    image), moved from its centre m to c as its Minkowski sum with the disc
    of radius |m| ((1 + |m| / s) S + (|m|^2 + |m| s) I, s = sqrt(tr S / 2)),
    then the filter's circle added (the sum of the two matrices)."""
    tu1, tu2, tv1, tv2, tw1, tw2, tw3 = tmat.unbind(-1)
    Q = gate_q(op)
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
    mm = mx * mx + my * my
    mlen = torch.sqrt(mm)
    sig = torch.sqrt(torch.clamp_min(0.5 * (s11 + s22), 1e-12))
    a = 1.0 + mlen / sig
    b = mm + mlen * sig + 0.5 * Q
    grow = 1.0 + ELLIPSE_SLACK
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
    return conics, torch.where(valid, rad, torch.zeros_like(rad)).to(torch.int32)


def project(means, quats, log_scales, logit_op, sh, viewmat, K, width: int, height: int,
            sh_degree: int) -> Proj:
    """One view's surfels on screen, differentiable in the parameters."""
    W, t = viewmat[:3, :3], viewmat[:3, 3]
    fx, fy, cx0, cy0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    cam = means @ W.T + t
    x, y, z = cam.unbind(-1)
    r = rotation(quats)
    Rm = torch.stack(r, -1).reshape(-1, 3, 3)
    axes = torch.einsum("ij,njk->nik", W, Rm)          # columns W t_u, W t_v, W t_w
    s = torch.exp(log_scales)
    U = axes[:, :, 0] * s[:, :1]
    V = axes[:, :, 1] * s[:, 1:2]
    n = axes[:, :, 2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    ux, uy = x / zs, y / zs
    tmat = torch.stack([fx * (U[:, 0] - ux * U[:, 2]), fx * (V[:, 0] - ux * V[:, 2]),
                        fy * (U[:, 1] - uy * U[:, 2]), fy * (V[:, 1] - uy * V[:, 2]),
                        U[:, 2], V[:, 2], z], dim=-1)
    centers = torch.stack([fx * ux + cx0, fy * uy + cy0], dim=-1)
    sign = torch.where((n * cam).sum(-1) > 0.0, -1.0, 1.0).detach()
    normals = n * sign[:, None]
    op = torch.sigmoid(logit_op.reshape(-1))
    d = means + (W.T @ t)[None, :]
    dirs = d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-12)
    colors = sh_color(sh_degree, sh, dirs)
    with torch.no_grad():
        conics, radii = footprint(tmat.detach(), op.detach(), centers.detach(), width, height)
    return Proj(centers, tmat, normals, z.detach(), conics, radii, colors, op)


def tile_lists(p: Proj, width: int, height: int, ts: int):
    """(tile_starts (T + 1,), gid) of the dense binning with no tile cap:
    tile t holds, by centre depth, the surfels whose ellipse window covers
    it and whose exact ellipse/tile test passes."""
    with torch.no_grad():
        ntx, nty = -(-width // ts), -(-height // ts)
        dev = p.centers.device
        ca, cb, cc = p.conics.unbind(-1)
        mx, my = p.centers.unbind(-1)
        op = p.opac
        valid = (p.radii > 0) & (op >= ALPHA_SKIP)
        r = p.radii.float()
        det_s = torch.clamp_min(ca * cc - cb * cb, 1e-20)
        Q = gate_q(op)
        xe = torch.minimum(r, torch.sqrt(Q * torch.clamp_min(cc, 1e-12) / det_s) + WINDOW_EPS)
        ye = torch.minimum(r, torch.sqrt(Q * torch.clamp_min(ca, 1e-12) / det_s) + WINDOW_EPS)
        tx0 = torch.clamp(torch.floor((mx - xe) / ts), 0, ntx)
        tx1 = torch.clamp(torch.ceil((mx + xe) / ts), 0, ntx)
        ty0 = torch.clamp(torch.floor((my - ye) / ts), 0, nty)
        ty1 = torch.clamp(torch.ceil((my + ye) / ts), 0, nty)
        tiles = torch.arange(ntx * nty, device=dev)
        tx, ty = (tiles % ntx).float(), (tiles // ntx).float()
        inwin = (valid[:, None] & (tx[None] >= tx0[:, None]) & (tx[None] < tx1[:, None])
                 & (ty[None] >= ty0[:, None]) & (ty[None] < ty1[:, None]))
        g, t = torch.nonzero(inwin, as_tuple=True)
        xl = tx[t] * ts - mx[g]
        xh = xl + ts
        yl = ty[t] * ts - my[g]
        yh = yl + ts
        a_, b_, c_ = ca[g], cb[g], cc[g]

        def quad(qx, qy):
            return a_ * qx * qx + 2.0 * b_ * qx * qy + c_ * qy * qy

        def clip(v, lo, hi):
            return torch.minimum(torch.maximum(v, lo), hi)

        q_min = torch.minimum(
            torch.minimum(quad(xl, clip(-b_ * xl / torch.clamp_min(c_, 1e-12), yl, yh)),
                          quad(xh, clip(-b_ * xh / torch.clamp_min(c_, 1e-12), yl, yh))),
            torch.minimum(quad(clip(-b_ * yl / torch.clamp_min(a_, 1e-12), xl, xh), yl),
                          quad(clip(-b_ * yh / torch.clamp_min(a_, 1e-12), xl, xh), yh)))
        inside = (xl <= 0) & (xh >= 0) & (yl <= 0) & (yh >= 0)
        keep = inside | ~(q_min > Q[g])
        g, t = g[keep], t[keep]
        depth = p.depths[g]
        order = torch.argsort(depth, stable=True)
        g, t = g[order], t[order]
        order = torch.argsort(t, stable=True)
        g, t = g[order], t[order]
        starts = torch.searchsorted(t, torch.arange(ntx * nty + 1, device=dev))
    return starts, g


def _blend_tiles(tiles, longest, starts, gid, p: Proj, ts: int, ntx: int, chunk: int):
    """The 12 maps (B, P, 12) of a batch of tiles, differentiable in the
    screen values."""
    dev = p.centers.device
    P = ts * ts
    B = tiles.shape[0]
    st = starts[tiles]
    cnt = starts[tiles + 1] - st
    pidx = torch.arange(P, device=dev)
    px = ((((tiles % ntx) * ts)[:, None] + pidx % ts).float() + 0.5)[:, :, None]
    py = ((((tiles // ntx) * ts)[:, None] + pidx // ts).float() + 0.5)[:, :, None]
    zero = torch.zeros((B, P), device=dev)
    rgb = torch.zeros((B, P, 3), device=dev)
    nrm = torch.zeros((B, P, 3), device=dev)
    D, A, M1, M2, dist = zero, zero, zero, zero, zero
    med = zero
    tcar = torch.ones((B, P, 1), device=dev)
    for c0 in range(0, longest, chunk):
        pos = c0 + torch.arange(min(chunk, longest - c0), device=dev)
        valid = pos[None, :] < cnt[:, None]
        g = gid[torch.where(valid, st[:, None] + pos[None, :], 0)]
        c = p.centers[g]
        tm = p.tmat[g]
        tu1, tu2, tv1, tv2, tw1, tw2, tw3 = (tm[..., i][:, None, :] for i in range(7))
        dx = px - c[..., 0][:, None, :]
        dy = py - c[..., 1][:, None, :]
        k1, k2, k3 = dx * tw1 - tu1, dx * tw2 - tu2, dx * tw3
        l1, l2, l3 = dy * tw1 - tv1, dy * tw2 - tv2, dy * tw3
        p1 = k2 * l3 - k3 * l2
        p2 = k3 * l1 - k1 * l3
        p3 = k1 * l2 - k2 * l1
        hit = p3 != 0.0
        p3s = torch.where(hit, p3, torch.ones_like(p3))
        u, v = p1 / p3s, p2 / p3s
        rho3 = u * u + v * v
        rho2 = FILTER_INV_SQ * (dx * dx + dy * dy)
        disc = hit & (rho3 <= rho2)
        rho = torch.where(disc, rho3, rho2)
        araw = p.opac[g][:, None, :] * torch.exp(-0.5 * rho)
        z = torch.where(disc, (u * tw1 + v * tw2) + tw3, tw3)
        contrib = hit & (z >= NEAR) & (araw >= ALPHA_SKIP) & valid[:, None, :]
        alpha = torch.where(contrib, torch.clamp_max(araw, ALPHA_CLAMP), torch.zeros_like(araw))
        prod = torch.cumprod(1.0 - alpha, -1)
        prod_ex = torch.cat([torch.ones_like(prod[..., :1]), prod[..., :-1]], -1)
        mask = (tcar * prod).detach() > T_EARLY_STOP
        keep = mask & contrib
        t_before = tcar * prod_ex
        w = torch.where(keep, alpha * t_before, torch.zeros_like(alpha))
        zk = torch.where(keep, z, torch.ones_like(z))
        m = torch.where(keep, FAR / (FAR - NEAR) * (1.0 - NEAR / zk), torch.zeros_like(z))
        wm, wmm = w * m, w * m * m
        a_ex = A[..., None] + torch.cumsum(w, -1) - w
        m1_ex = M1[..., None] + torch.cumsum(wm, -1) - wm
        m2_ex = M2[..., None] + torch.cumsum(wmm, -1) - wmm
        dist = dist + (w * (m * m * a_ex + m2_ex - 2.0 * m * m1_ex)).sum(-1)
        rgb = rgb + torch.einsum("bpk,bkc->bpc", w, p.colors[g])
        nrm = nrm + torch.einsum("bpk,bkc->bpc", w, p.normals[g])
        D = D + (w * torch.where(keep, z, torch.zeros_like(z))).sum(-1)
        A = A + w.sum(-1)
        M1 = M1 + wm.sum(-1)
        M2 = M2 + wmm.sum(-1)
        with torch.no_grad():
            cand = keep & (t_before > 0.5)
            kk = torch.arange(cand.shape[-1], device=dev)
            last = torch.where(cand, kk, torch.full_like(kk, -1)).amax(-1)
            zmed = torch.gather(z.detach(), -1, last.clamp_min(0)[..., None])[..., 0]
            med = torch.where(last >= 0, zmed, med)
        tcar = tcar * torch.where(mask, prod, torch.ones_like(prod)).amin(-1, keepdim=True)
    return torch.cat([rgb, D[..., None], A[..., None], nrm, dist[..., None], med[..., None],
                      M1[..., None], M2[..., None]], dim=-1)


def blend(p: Proj, width: int, height: int, ts: int = 16, chunk: int = 256,
          elems: int = 1 << 24) -> torch.Tensor:
    """The (H, W, 12) maps [r, g, b, depth, alpha, normal (3), distortion,
    median depth, M1, M2] of one view, differentiable in the screen values
    (batches of tiles, each within ``elems`` (tile, pixel, entry)
    elements)."""
    ntx, nty = -(-width // ts), -(-height // ts)
    starts, gid = tile_lists(p, width, height, ts)
    counts = starts[1:] - starts[:-1]
    order = torch.argsort(counts, descending=True, stable=True)
    cnt = counts[order].tolist()
    P = ts * ts
    full = torch.zeros((ntx * nty, P, 12), device=p.centers.device)
    i = 0
    while i < len(cnt) and cnt[i] > 0:
        n = max(1, min(1024, elems // (P * max(1, min(chunk, cnt[i])))))
        tiles = order[i:i + n]
        full = full.index_put((tiles,), _blend_tiles(tiles, cnt[i], starts, gid, p, ts, ntx,
                                                      chunk))
        i += n
    img = full.reshape(nty, ntx, ts, ts, 12).permute(0, 2, 1, 3, 4)
    return img.reshape(nty * ts, ntx * ts, 12)[:height, :width]


def render(means, quats, log_scales, logit_op, sh, viewmat, K, width: int, height: int,
           sh_degree: int, tile_size: int = 16, chunk: int = 256) -> torch.Tensor:
    """The (H, W, 12) maps of one view (``blend``), differentiable."""
    p = project(means, quats, log_scales, logit_op, sh, viewmat, K, width, height, sh_degree)
    return blend(p, width, height, tile_size, chunk)


# ---- the regularizers and the loss --------------------------------------------------


def depth_to_normal(viewmat, K, depth: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) world-space normals of a depth map: each pixel centre's
    ray ((x + 0.5 - cx) / fx, (y + 0.5 - cy) / fy, 1) (K^-1 of zero-skew
    intrinsics) times the depth, to the world, central differences down the
    rows and along the columns, their cross product normalized; zero on the
    border."""
    H, W = depth.shape
    dev = depth.device
    xs = (torch.arange(W, device=dev, dtype=torch.float32) + 0.5 - K[0, 2]) / K[0, 0]
    ys = (torch.arange(H, device=dev, dtype=torch.float32) + 0.5 - K[1, 2]) / K[1, 1]
    cam = torch.stack([depth * xs[None, :], depth * ys[:, None], depth], dim=-1)
    pts = (cam - viewmat[:3, 3]) @ viewmat[:3, :3]
    dx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dy = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = F.normalize(torch.cross(dx, dy, dim=-1), dim=-1)
    return F.pad(n.permute(2, 0, 1), (1, 1, 1, 1)).permute(1, 2, 0)


def surface_depth(maps: torch.Tensor, depth_ratio: float) -> torch.Tensor:
    expected = maps[..., 3] / torch.clamp_min(maps[..., 4], 1e-10)
    if depth_ratio == 0.0:
        return expected
    return (1.0 - depth_ratio) * expected + depth_ratio * maps[..., 9]


def normal_loss(maps: torch.Tensor, viewmat, K, depth_ratio: float = 0.0) -> torch.Tensor:
    """mean(1 - n_rendered . N_s), n_rendered the rendered normal in world
    space, N_s the surface depth's normal times the detached alpha."""
    n_world = maps[..., 5:8] @ viewmat[:3, :3]
    ns = depth_to_normal(viewmat, K, surface_depth(maps, depth_ratio))
    ns = ns * maps[..., 4].detach()[..., None]
    return (1.0 - (n_world * ns).sum(-1)).mean()


def distortion_loss(maps: torch.Tensor) -> torch.Tensor:
    return maps[..., 8].mean()


def _pool3(img):
    x = img.permute(2, 0, 1)[None]
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)[0].permute(1, 2, 0)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    mu1, mu2 = _pool3(a), _pool3(b)
    s1 = _pool3(a * a) - mu1 * mu1
    s2 = _pool3(b * b) - mu2 * mu2
    s12 = _pool3(a * b) - mu1 * mu2
    return (((2 * mu1 * mu2 + C1) * (2 * s12 + C2))
            / ((mu1 * mu1 + mu2 * mu2 + C1) * (s1 + s2 + C2))).mean()


def photometric(img: torch.Tensor, gt: torch.Tensor, lam: float) -> torch.Tensor:
    r = img + (torch.clamp(img, 0.0, 1.0) - img).detach()
    return (1.0 - lam) * torch.mean(torch.abs(r - gt)) + lam * (1.0 - ssim(r, gt))


def reg_weights(iteration: int, lambda_normal: float, lambda_dist: float):
    """The two terms' weights at ``iteration``: each zero before its start."""
    return (lambda_normal if iteration >= LAMBDA_NORMAL_FROM else 0.0,
            lambda_dist if iteration >= LAMBDA_DIST_FROM else 0.0)


def view_loss(params: dict, viewmat, K, gt, width: int, height: int, sh_degree: int,
              iteration: int, lambda_dssim: float = 0.2, lambda_normal: float = 0.05,
              lambda_dist: float = 100.0, depth_ratio: float = 0.0, tile_size: int = 16,
              chunk: int = 256) -> torch.Tensor:
    """One view's loss: the photometric term of the colour plus the normal
    and distortion terms at ``iteration``'s weights. ``params`` holds
    ``means``, ``quats``, ``log_scales`` (N, 2), ``logit_opacities`` and
    ``sh`` (N, K, 3)."""
    maps = render(params["means"], params["quats"], params["log_scales"],
                  params["logit_opacities"], params["sh"], viewmat, K, width, height,
                  sh_degree, tile_size, chunk)
    ln, ld = reg_weights(iteration, lambda_normal, lambda_dist)
    loss = photometric(maps[..., :3], gt, lambda_dssim)
    return loss + ln * normal_loss(maps, viewmat, K, depth_ratio) + ld * distortion_loss(maps)
