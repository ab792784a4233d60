"""The plain reference renderer: 3D gaussians and a camera to an image, in
plain PyTorch, with the semantics that shape the port's image.

It imports nothing of the program. The arithmetic is a frozen copy of the
plain formulas the port follows (EWA projection with the opacity-aware
radius, SH degrees 0-3, the sheared tile window with its exact ellipse/tile
cull and the ``max_t`` tile cap, the compact footprint classes and their
budgets, the (tile, depth) order), written over whole tensors, and a blend
that keeps the per-chunk stop rule: inside a chunk of ``chunk`` entries an
entry counts while ``T_carry * prod_incl > 1e-4``, and a pixel stopped in one
chunk takes entries of the next again. Every function takes a ``dtype``: the
control of the benchmark runs the same code in bfloat16.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

ALPHA_CLAMP = 0.999
ALPHA_SKIP = 1.0 / 255.0
T_EARLY_STOP = 1e-4
WINDOW_EPS = 0.5
NEG_INF_LOGIT = -20.0

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

# (tiles x pixels x entries) elements of one blend batch's temporaries.
BLEND_ELEMS = 1 << 25
BLEND_ELEMS_GRAD = 1 << 23


def cdiv(a, b):
    return -(-a // b)


class Screen(NamedTuple):
    """One view's screen-space gaussians, leading dim N."""

    means2d: torch.Tensor  # (N, 2)
    conics: torch.Tensor   # (N, 3)
    colors: torch.Tensor   # (N, 3)
    opac: torch.Tensor     # (N,)
    depths: torch.Tensor   # (N,)
    radii: torch.Tensor    # (N,) int32, 0 = culled


def sh_basis_eval(degree: int, coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Raw SH colors (N, 3) of ``coeffs`` (N, K, 3) at unit ``dirs`` (N, 3),
    the terms added in the order of the published basis."""
    result = SH_C0 * coeffs[..., 0, :]
    if degree >= 1:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (result - SH_C1 * y * coeffs[..., 1, :] + SH_C1 * z * coeffs[..., 2, :]
                  - SH_C1 * x * coeffs[..., 3, :])
        if degree >= 2:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result + SH_C2[0] * xy * coeffs[..., 4, :]
                      + SH_C2[1] * yz * coeffs[..., 5, :]
                      + SH_C2[2] * (2.0 * zz - xx - yy) * coeffs[..., 6, :]
                      + SH_C2[3] * xz * coeffs[..., 7, :]
                      + SH_C2[4] * (xx - yy) * coeffs[..., 8, :])
            if degree >= 3:
                result = (result + SH_C3[0] * y * (3.0 * xx - yy) * coeffs[..., 9, :]
                          + SH_C3[1] * xy * z * coeffs[..., 10, :]
                          + SH_C3[2] * y * (4.0 * zz - xx - yy) * coeffs[..., 11, :]
                          + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * coeffs[..., 12, :]
                          + SH_C3[4] * x * (4.0 * zz - xx - yy) * coeffs[..., 13, :]
                          + SH_C3[5] * z * (xx - yy) * coeffs[..., 14, :]
                          + SH_C3[6] * x * (xx - 3.0 * yy) * coeffs[..., 15, :])
    return result


def _rot_cols(q):
    w, x, y, z = q.unbind(-1)
    inv = 1.0 / torch.clamp_min(torch.sqrt(w * w + x * x + y * y + z * z), 1e-12)
    w, x, y, z = w * inv, x * inv, y * inv, z * inv
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy))


def project(means, quats, log_scales, logit_op, sh, viewmat, K, width, height,
            sh_degree, dtype=torch.float32, opacity_radius: bool = True) -> Screen:
    """EWA projection with eps2d 0.3, the frustum-clamped Jacobian (1.3x the
    view cone), the opacity-aware radius (3 sigma at most, the 1/255 gate
    inside), the activations and the SH colors max(SH + 0.5, 0) along the
    view directions, entry by entry over (N,) columns. Differentiable;
    computed in ``dtype``. ``opacity_radius=False`` keeps the plain 3-sigma
    radius (the trainer measures footprints so)."""
    viewmat, K = viewmat.to(means.device), K.to(means.device)
    means, quats, log_scales, logit_op, sh = (
        t.to(dtype) for t in (means, quats, log_scales, logit_op, sh))
    Rw = viewmat[:3, :3].to(dtype)
    tw = viewmat[:3, 3].to(dtype)
    Kd = K.to(dtype)
    fx, fy, cx, cy = Kd[0, 0], Kd[1, 1], Kd[0, 2], Kd[1, 2]
    scales = torch.exp(log_scales)
    op = torch.sigmoid(logit_op.reshape(-1))

    m0, m1, m2 = means[:, 0], means[:, 1], means[:, 2]
    x = Rw[0, 0] * m0 + Rw[0, 1] * m1 + Rw[0, 2] * m2 + tw[0]
    y = Rw[1, 0] * m0 + Rw[1, 1] * m1 + Rw[1, 2] * m2 + tw[1]
    z = Rw[2, 0] * m0 + Rw[2, 1] * m1 + Rw[2, 2] * m2 + tw[2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)

    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _rot_cols(quats)
    v0, v1, v2 = (scales[:, i] * scales[:, i] for i in range(3))
    s00 = r00 * r00 * v0 + r01 * r01 * v1 + r02 * r02 * v2
    s01 = r00 * r10 * v0 + r01 * r11 * v1 + r02 * r12 * v2
    s02 = r00 * r20 * v0 + r01 * r21 * v1 + r02 * r22 * v2
    s11 = r10 * r10 * v0 + r11 * r11 * v1 + r12 * r12 * v2
    s12 = r10 * r20 * v0 + r11 * r21 * v1 + r12 * r22 * v2
    s22 = r20 * r20 * v0 + r21 * r21 * v1 + r22 * r22 * v2
    b00 = s00 * Rw[0, 0] + s01 * Rw[0, 1] + s02 * Rw[0, 2]
    b01 = s00 * Rw[1, 0] + s01 * Rw[1, 1] + s02 * Rw[1, 2]
    b02 = s00 * Rw[2, 0] + s01 * Rw[2, 1] + s02 * Rw[2, 2]
    b10 = s01 * Rw[0, 0] + s11 * Rw[0, 1] + s12 * Rw[0, 2]
    b11 = s01 * Rw[1, 0] + s11 * Rw[1, 1] + s12 * Rw[1, 2]
    b12 = s01 * Rw[2, 0] + s11 * Rw[2, 1] + s12 * Rw[2, 2]
    b20 = s02 * Rw[0, 0] + s12 * Rw[0, 1] + s22 * Rw[0, 2]
    b21 = s02 * Rw[1, 0] + s12 * Rw[1, 1] + s22 * Rw[1, 2]
    b22 = s02 * Rw[2, 0] + s12 * Rw[2, 1] + s22 * Rw[2, 2]
    c00 = Rw[0, 0] * b00 + Rw[0, 1] * b10 + Rw[0, 2] * b20
    c01 = Rw[0, 0] * b01 + Rw[0, 1] * b11 + Rw[0, 2] * b21
    c02 = Rw[0, 0] * b02 + Rw[0, 1] * b12 + Rw[0, 2] * b22
    c11 = Rw[1, 0] * b01 + Rw[1, 1] * b11 + Rw[1, 2] * b21
    c12 = Rw[1, 0] * b02 + Rw[1, 1] * b12 + Rw[1, 2] * b22
    c22 = Rw[2, 0] * b02 + Rw[2, 1] * b12 + Rw[2, 2] * b22

    lim_x = 1.3 * (0.5 * width / fx)
    lim_y = 1.3 * (0.5 * height / fy)
    tx = zs * torch.clamp(x / zs, -lim_x, lim_x)
    ty = zs * torch.clamp(y / zs, -lim_y, lim_y)
    rz = 1.0 / zs
    rz2 = rz * rz
    j00, j02 = fx * rz, -fx * tx * rz2
    j11, j12 = fy * rz, -fy * ty * rz2
    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22)
    b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22)
    a = a + 0.3
    c = c + 0.3
    det = a * c - b * b
    det_safe = torch.where(det <= 0.0, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    conics = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mx = fx * x * rz + cx
    my = fy * y * rz + cy
    with torch.no_grad():
        mid = 0.5 * (a + c)
        lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.01))
        opd = op.detach().float()
        s_cut = torch.log(torch.clamp_min(opd, 1e-12) * 255.0)
        mult = torch.clamp_max(torch.sqrt(2.0 * torch.clamp_min(s_cut, 1e-12)), 3.0)
        if not opacity_radius:
            mult = torch.full_like(mult, 3.0)
        rad = torch.ceil(mult * torch.sqrt(torch.clamp_min(lam.float(), 0.0)))
        mxf, myf = mx.detach().float(), my.detach().float()
        inside = ((mxf + rad > 0) & (mxf - rad < width) & (myf + rad > 0)
                  & (myf - rad < height))
        valid = (z > 0.01) & (z < 1e10) & (det > 0.0) & inside & (rad > 0.0)
        radii = torch.where(valid, rad, torch.zeros_like(rad)).to(torch.int32)

    cam = -Rw.T @ tw
    dirs = means - cam[None, :]
    dirs = dirs / torch.clamp_min(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-12)
    colors = torch.clamp_min(sh_basis_eval(sh_degree, sh, dirs) + 0.5, 0.0)
    return Screen(torch.stack([mx, my], dim=-1), conics, colors, op, z, radii)


# ---- binning ---------------------------------------------------------------


def class_caps(max_t: int) -> Tuple[int, ...]:
    """Footprint class caps 1, 2, 3, 4, 6, 8, 12, 16, 24, ... up to max_t."""
    caps = [c for c in (1, 2, 3, 4, 6) if c <= max_t]
    c = caps[-1]
    while c < max_t:
        c = c * 4 // 3 if c % 3 == 0 else c * 3 // 2
        caps.append(c)
    return tuple(caps)


def _gate_q(op):
    return torch.clamp_min(2.0 * (torch.log(255.0 * torch.clamp_min(op, 1e-12)) + 1e-3), 0.0)


def footprints(s: Screen, width: int, height: int, ts: int, max_t: int):
    """Per gaussian: the sheared window (tx0, ty0, nx, wt), its tile count
    and the count under the cap. float32."""
    ntx, nty = cdiv(width, ts), cdiv(height, ts)
    m2, con, op = s.means2d.float(), s.conics.float(), s.opac.float()
    valid = (s.radii > 0) & (op >= ALPHA_SKIP)
    r = s.radii.float()
    mx, my = m2[:, 0], m2[:, 1]
    ca, cb, cc = con[:, 0], con[:, 1], con[:, 2]
    ca_s = torch.clamp_min(ca, 1e-12)
    det_s = torch.clamp_min(ca * cc - cb * cb, 1e-20)
    Q = _gate_q(op)
    xe = torch.minimum(r, torch.sqrt(Q * torch.clamp_min(cc, 1e-12) / det_s) + WINDOW_EPS)
    ye = torch.minimum(r, torch.sqrt(Q * ca_s / det_s) + WINDOW_EPS)
    tx0 = torch.clamp(torch.floor((mx - xe) / ts), 0, ntx).to(torch.int32)
    tx1 = torch.clamp(torch.ceil((mx + xe) / ts), 0, ntx).to(torch.int32)
    ty0 = torch.clamp(torch.floor((my - ye) / ts), 0, nty).to(torch.int32)
    ty1 = torch.clamp(torch.ceil((my + ye) / ts), 0, nty).to(torch.int32)
    zero = torch.zeros_like(tx0)
    nx = torch.where(valid, torch.clamp_min(tx1 - tx0, 0), zero)
    ny = torch.where(valid, torch.clamp_min(ty1 - ty0, 0), zero)
    w_px = (torch.abs(cb) * ts + 2.0 * torch.sqrt(Q * ca_s)) / ca_s + 2.0 * WINDOW_EPS
    wt = torch.minimum(torch.ceil(w_px / ts) + 1.0, nx.float()).to(torch.int32)
    n_tiles = ny * wt
    return tx0, ty0, nx, wt, n_tiles, torch.clamp_max(n_tiles, max_t)


def _slot_tiles(s: Screen, g, tx0, ty0, nx, wt, slot, width, ts):
    """Tile of slot ``slot`` of gaussian ``g`` (1-D, paired), or -1 where the
    window's row base or the exact ellipse/tile cull rules it out."""
    ntx = cdiv(width, ts)
    fts = float(ts)
    m2, con, op = s.means2d.float()[g], s.conics.float()[g], s.opac.float()[g]
    mx, my = m2[:, 0], m2[:, 1]
    ca, cb, cc = con[:, 0], con[:, 1], con[:, 2]
    wts = torch.clamp_min(wt, 1)
    r = torch.div(slot, wts, rounding_mode="floor")
    c = slot - r * wts
    ca_s, cc_s = torch.clamp_min(ca, 1e-12), torch.clamp_min(cc, 1e-12)
    det = ca * cc - cb * cb
    Q = _gate_q(op)

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    dyl = (ty0 + r).float() * fts - my
    dyc = dyl + 0.5 * fts
    dym = clip(torch.zeros_like(dyl), dyl, dyl + fts)
    half = torch.sqrt(torch.clamp_min(ca * Q - det * dym * dym, 0.0)) / ca_s
    dxlo = (-cb * dyc - 0.5 * torch.abs(cb) * fts) / ca_s - half - WINDOW_EPS
    base = clip(torch.floor((mx + dxlo) / fts).to(torch.int32), tx0, tx0 + nx - wts)
    tx, ty = base + c, ty0 + r
    xl = tx.float() * fts - mx
    xh = xl + fts
    yl = ty.float() * fts - my
    yh = yl + fts

    def quad(qx, qy):
        return ca * qx * qx + 2.0 * cb * qx * qy + cc * qy * qy

    q_min = torch.minimum(
        torch.minimum(quad(xl, clip(-cb * xl / cc_s, yl, yh)),
                      quad(xh, clip(-cb * xh / cc_s, yl, yh))),
        torch.minimum(quad(clip(-cb * yl / ca_s, xl, xh), yl),
                      quad(clip(-cb * yh / ca_s, xl, xh), yh)))
    inside = (xl <= 0) & (xh >= 0) & (yl <= 0) & (yh >= 0)
    q_min = torch.where(inside, torch.zeros_like(q_min), q_min)
    tid = ty * ntx + tx
    return torch.where(q_min > Q, torch.full_like(tid, -1), tid)


def budget_kept(n_capped: torch.Tensor, max_t: int, class_budgets):
    """Which gaussians keep their tiles under the class budgets, and each
    one's slot offset in the layout the sort runs over. Class c (capped tile
    count in (caps[c-1], caps[c]]) keeps its first ``class_budgets[c]``
    gaussians in index order, in a (cap_c, budget_c) block after the blocks
    of the classes before it: slot s of its j-th gaussian sits at offset_c +
    s * budget_c + j. Gaussians with no tile belong to no class. Without
    budgets every gaussian keeps its tiles, slot s of gaussian g at s * N +
    g. Returns (kept, base, stride): slot s of g sits at base[g] + s *
    stride[g]."""
    N = n_capped.shape[0]
    dev = n_capped.device
    if class_budgets is None:
        return (torch.ones_like(n_capped, dtype=torch.bool),
                torch.arange(N, device=dev), torch.full((N,), N, device=dev))
    caps_l = class_caps(max_t)
    caps = torch.tensor(caps_l, dtype=n_capped.dtype, device=dev)
    L = caps.shape[0]
    cls = torch.sum(n_capped[:, None] > caps[None, :], dim=1)
    cls = torch.where(n_capped > 0, cls, torch.full_like(cls, L))
    budgets = torch.tensor(list(class_budgets) + [0], device=dev)
    sizes = torch.tensor([c * b for c, b in zip(caps_l, class_budgets)] + [0], device=dev)
    offset = torch.cumsum(sizes, 0) - sizes
    onehot = torch.nn.functional.one_hot(cls, L + 1)
    rank = (torch.cumsum(onehot, 0) - onehot).gather(1, cls[:, None])[:, 0]
    kept = (rank < budgets[cls]) & (n_capped > 0)
    return kept, offset[cls] + rank, budgets[cls]


class Binned(NamedTuple):
    tile_starts: torch.Tensor  # (T + 1,) int64
    gid: torch.Tensor          # (n_isect,) int64 gaussians in (tile, depth) order
    n_isect: int
    n_dropped: int             # tiles lost to the cap
    n_budget_dropped: int      # tiles lost to the class budgets


def _order_bits(d: torch.Tensor) -> torch.Tensor:
    b = d.float().contiguous().view(torch.int32).to(torch.int64)
    return torch.where(b >= 0, b + (1 << 31), (~b) & 0xFFFFFFFF)


def bin_view(s: Screen, width: int, height: int, ts: int, max_t: int,
             class_budgets=None, slot_batch: int = 1 << 24) -> Binned:
    """The kept (tile, gaussian) pairs of a view in (tile, depth) order."""
    with torch.no_grad():
        T = cdiv(width, ts) * cdiv(height, ts)
        tx0, ty0, nx, wt, n_tiles, n_capped = footprints(s, width, height, ts, max_t)
        kept, base, stride = budget_kept(n_capped, max_t, class_budgets)
        n_dropped = int((n_tiles - n_capped).sum())
        n_budget = int(torch.where(kept, 0, n_capped).sum())
        ncap = torch.where(kept, n_capped, torch.zeros_like(n_capped))
        g_all = torch.repeat_interleave(torch.arange(ncap.shape[0], device=ncap.device),
                                        ncap.long())
        first = torch.cumsum(ncap.long(), 0) - ncap.long()
        slot_all = torch.arange(g_all.shape[0], device=ncap.device) - first[g_all]
        tiles, gids, where = [], [], []
        for i in range(0, g_all.shape[0], slot_batch):
            g, sl = g_all[i:i + slot_batch], slot_all[i:i + slot_batch]
            tid = _slot_tiles(s, g, tx0[g], ty0[g], nx[g], wt[g], sl.to(torch.int32), width, ts)
            ok = tid >= 0
            tiles.append(tid[ok].long())
            gids.append(g[ok])
            where.append((base[g] + sl * stride[g])[ok])
        # Entries of equal (tile, depth) keep the order of their slots.
        order = torch.argsort(torch.cat(where))
        tile = torch.cat(tiles)[order]
        gid = torch.cat(gids)[order]
        key = (tile << 32) | _order_bits(s.depths.detach()[gid])
        key, order = torch.sort(key, stable=True)
        gid = gid[order]
        starts = torch.searchsorted(key, torch.arange(T + 1, device=key.device) << 32)
        return Binned(starts, gid, int(gid.shape[0]), n_dropped, n_budget)


# ---- blend -----------------------------------------------------------------


def _batches(counts: torch.Tensor, chunk: int, P: int, elems: int):
    order = torch.argsort(counts, descending=True, stable=True)
    cnt = counts[order].tolist()
    i = 0
    while i < len(cnt):
        k = max(1, min(chunk, cnt[i]))
        n = max(1, min(1024, elems // (P * k)))
        if cnt[i] == 0:
            return
        yield order[i:i + n], cnt[i]
        i += n


def _blend_tiles(tiles, longest, b: Binned, s: Screen, ts, ntx, chunk, dtype):
    """rgb (B, P, 3) of ``tiles`` and the number of (pixel, entry) pairs
    that carry a weight. Differentiable with respect to the screen values."""
    dev = s.means2d.device
    P = ts * ts
    st = b.tile_starts[tiles]
    cnt = b.tile_starts[tiles + 1] - st
    pidx = torch.arange(P, device=dev)
    px = ((((tiles % ntx) * ts)[:, None] + pidx % ts).float() + 0.5)[:, :, None].to(dtype)
    py = ((((tiles // ntx) * ts)[:, None] + pidx // ts).float() + 0.5)[:, :, None].to(dtype)
    rgb = torch.zeros((tiles.shape[0], P, 3), dtype=dtype, device=dev)
    tcar = torch.ones((tiles.shape[0], P, 1), dtype=dtype, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    for c0 in range(0, longest, chunk):
        pos = c0 + torch.arange(min(chunk, longest - c0), device=dev)
        valid = pos[None, :] < cnt[:, None]
        g = b.gid[torch.where(valid, st[:, None] + pos[None, :], 0)]     # (B, K)
        m2, con, col, op = s.means2d[g], s.conics[g], s.colors[g], s.opac[g]
        dx = px - m2[..., 0][:, None, :]
        dy = py - m2[..., 1][:, None, :]
        ca, cb, cc = (con[..., i][:, None, :] for i in range(3))
        sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        araw = op[:, None, :] * torch.exp(-sigma)
        contrib = (sigma >= 0) & (araw >= ALPHA_SKIP) & valid[:, None, :]
        alpha = torch.where(contrib, torch.clamp_max(araw, ALPHA_CLAMP), torch.zeros_like(araw))
        prod = torch.cumprod(1.0 - alpha, -1)
        prod_ex = torch.cat([torch.ones_like(prod[..., :1]), prod[..., :-1]], -1)
        mask = (tcar * prod).float() > T_EARLY_STOP
        w = torch.where(mask, alpha * tcar * prod_ex, torch.zeros_like(alpha))
        rgb = rgb + torch.einsum("bpk,bkc->bpc", w, col)
        tcar = tcar * torch.where(mask, prod, torch.ones_like(prod)).amin(-1, keepdim=True)
        pairs = pairs + (mask & contrib).sum()
    return rgb, pairs


def blend(b: Binned, s: Screen, width, height, ts=16, chunk=256, dtype=torch.float32):
    """The (H, W, 3) image of a binned view (no gradients) and the number of
    (pixel, entry) pairs that carry a weight."""
    ntx = cdiv(width, ts)
    counts = b.tile_starts[1:] - b.tile_starts[:-1]
    parts, pairs = [], 0
    with torch.no_grad():
        for tiles, longest in _batches(counts, chunk, ts * ts, BLEND_ELEMS):
            rgb, n = _blend_tiles(tiles, longest, b, s, ts, ntx, chunk, dtype)
            parts.append((tiles, rgb))
            pairs += int(n)
        nty = cdiv(height, ts)
        full = torch.zeros((ntx * nty, ts * ts, 3), dtype=dtype, device=s.means2d.device)
        for tiles, rgb in parts:
            full[tiles] = rgb
        img = full.reshape(nty, ntx, ts, ts, 3).permute(0, 2, 1, 3, 4)
        img = img.reshape(nty * ts, ntx * ts, 3)[:height, :width]
    return img, pairs


def blend_backward(b: Binned, s: Screen, d_image: torch.Tensor, width, height, ts=16,
                   chunk=256, dtype=torch.float32):
    """Backpropagate ``d_image`` (H, W, 3), the gradient of a loss with
    respect to the blended image, into the leaves of ``s``'s screen values,
    recomputing the blend one batch of tiles at a time."""
    ntx, nty = cdiv(width, ts), cdiv(height, ts)
    counts = b.tile_starts[1:] - b.tile_starts[:-1]
    pad = torch.zeros((nty * ts, ntx * ts, 3), dtype=d_image.dtype, device=d_image.device)
    pad[:height, :width] = d_image
    d_tiles = pad.reshape(nty, ts, ntx, ts, 3).permute(0, 2, 1, 3, 4).reshape(
        ntx * nty, ts * ts, 3)
    leaves = [t for t in (s.means2d, s.conics, s.colors, s.opac) if t.requires_grad]
    for tiles, longest in _batches(counts, chunk, ts * ts, BLEND_ELEMS_GRAD):
        rgb, _ = _blend_tiles(tiles, longest, b, s, ts, ntx, chunk, dtype)
        torch.autograd.backward(rgb, d_tiles[tiles].to(rgb.dtype), inputs=leaves)


def render(means, quats, log_scales, logit_op, sh, viewmat, K, width, height, sh_degree,
           ts=16, chunk=256, max_t=16, class_budgets=None, dtype=torch.float32):
    """(image (H, W, 3) float32, binning, pairs that carry a weight) of one
    view, without gradients."""
    with torch.no_grad():
        s = project(means, quats, log_scales, logit_op, sh, viewmat, K, width, height,
                    sh_degree, dtype)
        b = bin_view(s, width, height, ts, max_t, class_budgets)
        img, pairs = blend(b, s, width, height, ts, chunk, dtype)
    return img.float(), b, pairs


def masked_logits(logit_op: torch.Tensor, alive: Optional[torch.Tensor]) -> torch.Tensor:
    """Dead slots at opacity ~0 (logit -20)."""
    if alive is None:
        return logit_op
    return torch.where(alive[:, None], logit_op, torch.full_like(logit_op, NEG_INF_LOGIT))


def look_at(eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)) -> torch.Tensor:
    """World-to-camera (4, 4) float32 on the host: +z forward, +y down."""
    eye_t, tgt, upv = (torch.tensor(v, dtype=torch.float64) for v in (eye, target, up))
    fwd = tgt - eye_t
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(fwd, upv)
    right = right / torch.linalg.norm(right)
    down = torch.linalg.cross(fwd, right)
    R = torch.stack([right, down, fwd])
    vm = torch.eye(4, dtype=torch.float64)
    vm[:3, :3] = R
    vm[:3, 3] = -R @ eye_t
    return vm.float()


def intrinsics(width: int, height: int, focal: float) -> torch.Tensor:
    return torch.tensor([[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0],
                         [0.0, 0.0, 1.0]], dtype=torch.float32)

