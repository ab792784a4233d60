"""The plain reference of 2D Gaussian Splatting (Huang et al., SIGGRAPH 2024,
arXiv 2403.17888) for the benchmark, in plain PyTorch. It imports nothing
of the program; it extends ``reference/train.py`` (the static step's loss,
Adam, batches, tile cap and class budgets) and ``reference/render.py`` (the
binning: the sheared windows, the exact ellipse/tile cull, the cap, the
budgets, the (tile, depth) order) by import.

A surfel (centre, rotation, two scales, opacity, SH) projects to the map T
= [K W s_u t_u, K W s_v t_v, K (W p + t)], written in pixels centred at its
projected centre c; a pixel's ray meets it at (u, v) = (k x l)_{1,2} / (k x
l)_3 with k = dx T_w - T_u, l = dy T_w - T_v; rho = min(u^2 + v^2, |(dx,
dy)|^2 / sigma^2), sigma = sqrt(2) / 2 (the screen filter); alpha = min(o
e^(-rho / 2), 0.999); the entry's depth is the intersection's where the disc
term is the smaller, else the centre's; an entry counts where (k x l)_3 !=
0, its depth is at least 0.2 and alpha >= 1/255. It is binned as the
program bins it: by the ellipse that holds the disc's image at the 1/255
gate and the filter's circle (``footprint``), through ``render.bin_view``.
Blending keeps the per-chunk stop rule and gives 12 maps a pixel: colour,
expected depth sum w z, alpha, the normal sum w n (the view-space normal
facing the camera), the distortion sum_{j<i} w_i w_j (m_i - m_j)^2 (m = f /
(f - n) (1 - n / z), n 0.2, f 100), the median depth, M1 and M2.

A view's loss (``view_terms``): the photometric term of ``train.py`` on the
colour, plus lambda_n mean(1 - n_world . N_s) (N_s the normal of the
expected-depth map's world points by central differences, times the
detached alpha) from iteration 7000 and lambda_d mean(distortion) from
3000. A step (``reference_steps``): each view's maps without gradient, the
loss's gradient with respect to the maps, then the blend again tile batch
by tile batch under autograd into the screen values and through the
projection into the parameters; the scale hinge on the two scales; Adam as
``train.py``'s. ``densify`` is ``train.py``'s with the split children drawn
in the tangent plane (s_u n_1 t_u + s_v n_2 t_v at the child's scales).

Every function takes a ``dtype`` (the control runs it in bfloat16) and the
faults of the control: ``drop_dist``, ``drop_normal`` and ``no_filter``
leave out the distortion term, the normal term and the screen filter.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import render as R
from portbench.reference import train as RT

PARAM_KEYS = RT.PARAM_KEYS
NEAR = 0.2
FAR = 100.0
FILTER_INV_SQ = 2.0
ELLIPSE_SLACK = 1e-3
DIST_FROM = 3000
NORMAL_FROM = 7000
BLEND_ELEMS = 1 << 23
BLEND_ELEMS_GRAD = 1 << 21


class Surfels(NamedTuple):
    """One view's screen-space surfels, leading dim N."""

    centers: torch.Tensor  # (N, 2)
    tmat: torch.Tensor     # (N, 7) T_u1 T_u2 T_v1 T_v2 T_w1 T_w2 T_w3
    normals: torch.Tensor  # (N, 3)
    colors: torch.Tensor   # (N, 3)
    opac: torch.Tensor     # (N,)
    screen: R.Screen       # the binning's view: centre, ellipse conic, radius, depth


def footprint(tmat, op, centers, width: int, height: int):
    """The binning ellipse, as a conic at the 1/255 gate Q, and its radius
    (0 = culled): the image of the disc rho3 <= Q (dual conic T diag(Q, Q, -1)
    T^T) moved from its centre m to c (its Minkowski sum with the disc of
    radius |m|, (1 + |m| / s) S + (|m|^2 + |m| s) I, s = sqrt(tr S / 2)), and
    the filter's circle added to its matrix. float32."""
    tu1, tu2, tv1, tv2, tw1, tw2, tw3 = tmat.float().unbind(-1)
    Q = R._gate_q(op.float())
    d11 = Q * (tu1 * tu1 + tu2 * tu2)
    d12 = Q * (tu1 * tv1 + tu2 * tv2)
    d22 = Q * (tv1 * tv1 + tv2 * tv2)
    d13 = Q * (tu1 * tw1 + tu2 * tw2)
    d23 = Q * (tv1 * tw1 + tv2 * tw2)
    d33 = Q * (tw1 * tw1 + tw2 * tw2) - tw3 * tw3
    ok = d33 < 0.0
    f = -1.0 / torch.where(ok, d33, torch.full_like(d33, -1.0))
    mx, my = -f * d13, -f * d23
    s11, s12, s22 = f * d11 + mx * mx, f * d12 + mx * my, f * d22 + my * my
    mm = mx * mx + my * my
    mlen = torch.sqrt(mm)
    sig = torch.sqrt(torch.clamp_min(0.5 * (s11 + s22), 1e-12))
    a = 1.0 + mlen / sig
    b = mm + mlen * sig + 0.5 * Q
    grow = 1.0 + ELLIPSE_SLACK
    e11, e12, e22 = (a * s11 + b) * grow, a * s12 * grow, (a * s22 + b) * grow
    det = e11 * e22 - e12 * e12
    det_s = torch.where(det > 0.0, det, torch.ones_like(det))
    conics = torch.stack([Q * e22 / det_s, -Q * e12 / det_s, Q * e11 / det_s], dim=-1)
    rad = torch.ceil(torch.sqrt(torch.clamp_min(torch.maximum(e11, e22), 0.0))) + 1.0
    c = centers.float()
    inside = ((c[:, 0] + rad > 0) & (c[:, 0] - rad < width) & (c[:, 1] + rad > 0)
              & (c[:, 1] - rad < height))
    finite = torch.isfinite(conics).all(-1) & torch.isfinite(rad) & torch.isfinite(c).all(-1)
    valid = ok & (tw3 > NEAR) & (det > 0.0) & inside & finite & (rad < 2.0 ** 24)
    return conics, torch.where(valid, rad, torch.zeros_like(rad)).to(torch.int32)


def project(means, quats, log_scales, logit_op, sh, viewmat, K, width: int, height: int,
            sh_degree: int, dtype=torch.float32) -> Surfels:
    """One view's surfels on screen in ``dtype``, differentiable in the
    parameters."""
    viewmat, K = viewmat.to(means.device), K.to(means.device)
    means, quats, log_scales, logit_op, sh = (
        t.to(dtype) for t in (means, quats, log_scales, logit_op, sh))
    W, t = viewmat[:3, :3].to(dtype), viewmat[:3, 3].to(dtype)
    Kd = K.to(dtype)
    fx, fy, cx0, cy0 = Kd[0, 0], Kd[1, 1], Kd[0, 2], Kd[1, 2]
    m0, m1, m2 = means.unbind(-1)
    x = W[0, 0] * m0 + W[0, 1] * m1 + W[0, 2] * m2 + t[0]
    y = W[1, 0] * m0 + W[1, 1] * m1 + W[1, 2] * m2 + t[1]
    z = W[2, 0] * m0 + W[2, 1] * m1 + W[2, 2] * m2 + t[2]
    r = R._rot_cols(quats)
    su, sv = torch.exp(log_scales[:, 0]), torch.exp(log_scales[:, 1])
    wtu = [W[i, 0] * r[0] + W[i, 1] * r[3] + W[i, 2] * r[6] for i in range(3)]
    wtv = [W[i, 0] * r[1] + W[i, 1] * r[4] + W[i, 2] * r[7] for i in range(3)]
    ncam = [W[i, 0] * r[2] + W[i, 1] * r[5] + W[i, 2] * r[8] for i in range(3)]
    U, V = [v * su for v in wtu], [v * sv for v in wtv]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    ux, uy = x / zs, y / zs
    tmat = torch.stack([fx * (U[0] - ux * U[2]), fx * (V[0] - ux * V[2]),
                        fy * (U[1] - uy * U[2]), fy * (V[1] - uy * V[2]), U[2], V[2], z], -1)
    centers = torch.stack([fx * ux + cx0, fy * uy + cy0], dim=-1)
    facing = ncam[0] * x + ncam[1] * y + ncam[2] * z
    sign = torch.where(facing > 0, -torch.ones_like(z), torch.ones_like(z)).detach()
    normals = torch.stack([sign * v for v in ncam], dim=-1)
    op = torch.sigmoid(logit_op.reshape(-1))
    cam = -W.T @ t
    d = means - cam[None, :]
    dirs = d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-12)
    colors = torch.clamp_min(R.sh_basis_eval(sh_degree, sh, dirs) + 0.5, 0.0)
    with torch.no_grad():
        conics, radii = footprint(tmat.detach(), op.detach(), centers.detach(), width, height)
        screen = R.Screen(centers.detach().float(), conics, colors.detach().float(),
                          op.detach().float(), z.detach().float(), radii)
    return Surfels(centers, tmat, normals, colors, op, screen)


def _blend_tiles(tiles, longest, b: R.Binned, s: Surfels, ts, ntx, chunk, dtype,
                 no_filter=False):
    """The 12 maps (B, P, 12) of ``tiles`` and the pairs that carry a
    weight; differentiable in the screen values."""
    dev = s.centers.device
    P = ts * ts
    B = tiles.shape[0]
    st = b.tile_starts[tiles]
    cnt = b.tile_starts[tiles + 1] - st
    pidx = torch.arange(P, device=dev)
    px = ((((tiles % ntx) * ts)[:, None] + pidx % ts).float() + 0.5)[:, :, None].to(dtype)
    py = ((((tiles // ntx) * ts)[:, None] + pidx // ts).float() + 0.5)[:, :, None].to(dtype)
    zero = torch.zeros((B, P), dtype=dtype, device=dev)
    rgb = torch.zeros((B, P, 3), dtype=dtype, device=dev)
    nrm = torch.zeros((B, P, 3), dtype=dtype, device=dev)
    D, A, M1, M2, dist, med = zero, zero, zero, zero, zero, zero
    tcar = torch.ones((B, P, 1), dtype=dtype, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    for c0 in range(0, longest, chunk):
        pos = c0 + torch.arange(min(chunk, longest - c0), device=dev)
        valid = pos[None, :] < cnt[:, None]
        g = b.gid[torch.where(valid, st[:, None] + pos[None, :], 0)]
        c = s.centers[g]
        tu1, tu2, tv1, tv2, tw1, tw2, tw3 = (s.tmat[g][..., i][:, None, :] for i in range(7))
        dx = px - c[..., 0][:, None, :]
        dy = py - c[..., 1][:, None, :]
        k1, k2, k3 = dx * tw1 - tu1, dx * tw2 - tu2, dx * tw3
        l1, l2, l3 = dy * tw1 - tv1, dy * tw2 - tv2, dy * tw3
        p1, p2, p3 = k2 * l3 - k3 * l2, k3 * l1 - k1 * l3, k1 * l2 - k2 * l1
        hit = p3 != 0
        p3s = torch.where(hit, p3, torch.ones_like(p3))
        u, v = p1 / p3s, p2 / p3s
        rho3 = u * u + v * v
        rho2 = FILTER_INV_SQ * (dx * dx + dy * dy)
        if no_filter:
            rho2 = torch.full_like(rho2, float("inf"))
        disc = hit & (rho3 <= rho2)
        rho = torch.where(disc, rho3, rho2)
        araw = s.opac[g][:, None, :] * torch.exp(-0.5 * rho)
        z = torch.where(disc, (u * tw1 + v * tw2) + tw3, tw3)
        contrib = (hit & (z.float() >= NEAR) & (araw.float() >= R.ALPHA_SKIP)
                   & valid[:, None, :])
        alpha = torch.where(contrib, torch.clamp_max(araw, R.ALPHA_CLAMP), torch.zeros_like(araw))
        prod = torch.cumprod(1.0 - alpha, -1)
        prod_ex = torch.cat([torch.ones_like(prod[..., :1]), prod[..., :-1]], -1)
        mask = (tcar * prod).detach().float() > R.T_EARLY_STOP
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
        rgb = rgb + torch.einsum("bpk,bkc->bpc", w, s.colors[g])
        nrm = nrm + torch.einsum("bpk,bkc->bpc", w, s.normals[g])
        D = D + (w * torch.where(keep, z, torch.zeros_like(z))).sum(-1)
        A, M1, M2 = A + w.sum(-1), M1 + wm.sum(-1), M2 + wmm.sum(-1)
        with torch.no_grad():
            cand = keep & (t_before.float() > 0.5)
            kk = torch.arange(cand.shape[-1], device=dev)
            last = torch.where(cand, kk, torch.full_like(kk, -1)).amax(-1)
            zmed = torch.gather(z.detach(), -1, last.clamp_min(0)[..., None])[..., 0]
            med = torch.where(last >= 0, zmed, med)
        tcar = tcar * torch.where(mask, prod, torch.ones_like(prod)).amin(-1, keepdim=True)
        pairs = pairs + keep.sum()
    maps = torch.cat([rgb, D[..., None], A[..., None], nrm, dist[..., None], med[..., None],
                      M1[..., None], M2[..., None]], dim=-1)
    return maps, pairs


def blend(b: R.Binned, s: Surfels, width, height, ts=16, chunk=256, dtype=torch.float32,
          no_filter=False):
    """The (H, W, 12) float32 maps of a binned view, without gradients, and
    the pairs that carry a weight."""
    ntx, nty = R.cdiv(width, ts), R.cdiv(height, ts)
    counts = b.tile_starts[1:] - b.tile_starts[:-1]
    full = torch.zeros((ntx * nty, ts * ts, 12), device=s.centers.device)
    pairs = 0
    with torch.no_grad():
        for tiles, longest in R._batches(counts, chunk, ts * ts, BLEND_ELEMS):
            maps, n = _blend_tiles(tiles, longest, b, s, ts, ntx, chunk, dtype, no_filter)
            full[tiles] = maps.float()
            pairs += int(n)
    img = full.reshape(nty, ntx, ts, ts, 12).permute(0, 2, 1, 3, 4)
    return img.reshape(nty * ts, ntx * ts, 12)[:height, :width], pairs


def blend_backward(b: R.Binned, s: Surfels, d_maps: torch.Tensor, width, height, ts=16,
                   chunk=256, dtype=torch.float32, no_filter=False):
    """Backpropagate ``d_maps`` (H, W, 12) into the leaves of ``s``'s screen
    values, the blend recomputed one batch of tiles at a time."""
    ntx, nty = R.cdiv(width, ts), R.cdiv(height, ts)
    counts = b.tile_starts[1:] - b.tile_starts[:-1]
    pad = torch.zeros((nty * ts, ntx * ts, 12), dtype=d_maps.dtype, device=d_maps.device)
    pad[:height, :width] = d_maps
    d_tiles = pad.reshape(nty, ts, ntx, ts, 12).permute(0, 2, 1, 3, 4).reshape(
        ntx * nty, ts * ts, 12)
    leaves = [t for t in (s.centers, s.tmat, s.normals, s.colors, s.opac) if t.requires_grad]
    for tiles, longest in R._batches(counts, chunk, ts * ts, BLEND_ELEMS_GRAD):
        maps, _ = _blend_tiles(tiles, longest, b, s, ts, ntx, chunk, dtype, no_filter)
        torch.autograd.backward(maps, d_tiles[tiles].to(maps.dtype), inputs=leaves)


def render(means, quats, log_scales, logit_op, sh, viewmat, K, width, height, sh_degree,
           ts=16, chunk=256, max_t=16, class_budgets=None, dtype=torch.float32):
    """(maps (H, W, 12) float32, binning, pairs) of one view, no gradients."""
    with torch.no_grad():
        s = project(means, quats, log_scales, logit_op, sh, viewmat, K, width, height,
                    sh_degree, dtype)
        b = R.bin_view(s.screen, width, height, ts, max_t, class_budgets)
        maps, pairs = blend(b, s, width, height, ts, chunk, dtype)
    return maps, b, pairs


# ---- the loss --------------------------------------------------------------------


def depth_to_normal(viewmat, K, depth: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) world normals of a depth map: the pixel centres' rays
    ((x + 0.5 - cx) / fx, (y + 0.5 - cy) / fy, 1) times the depth, to the
    world, central differences down the rows and along the columns, their
    cross product normalized; zero on the border."""
    H, W = depth.shape
    dev = depth.device
    K = K.to(dev).float()
    xs = (torch.arange(W, device=dev, dtype=torch.float32) + 0.5 - K[0, 2]) / K[0, 0]
    ys = (torch.arange(H, device=dev, dtype=torch.float32) + 0.5 - K[1, 2]) / K[1, 1]
    cam = torch.stack([depth * xs[None, :], depth * ys[:, None], depth], dim=-1)
    vm = viewmat.to(dev).float()
    pts = (cam - vm[:3, 3]) @ vm[:3, :3]
    dx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dy = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = F.normalize(torch.cross(dx, dy, dim=-1), dim=-1)
    return F.pad(n.permute(2, 0, 1), (1, 1, 1, 1)).permute(1, 2, 0)


def view_terms(maps: torch.Tensor, viewmat, K, gt, cfg: dict, iteration: int,
               drop_dist=False, drop_normal=False):
    """(loss, normal term, distortion term) of one view's maps (H, W, 12)."""
    ln = cfg["surfel_lambda_normal"] if iteration >= NORMAL_FROM and not drop_normal else 0.0
    ld = cfg["surfel_lambda_dist"] if iteration >= DIST_FROM and not drop_dist else 0.0
    loss = RT.photometric(maps[..., :3], gt, cfg["lambda_dssim"])
    surf = maps[..., 3] / torch.clamp_min(maps[..., 4], 1e-10)
    r = cfg["surfel_depth_ratio"]
    if r:
        surf = (1.0 - r) * surf + r * maps[..., 9]
    ns = depth_to_normal(viewmat, K, surf) * maps[..., 4].detach()[..., None]
    n_world = maps[..., 5:8] @ viewmat.to(maps.device).float()[:3, :3]
    l_n = (1.0 - (n_world * ns).sum(-1)).mean()
    l_d = maps[..., 8].mean()
    return loss + ln * l_n + ld * l_d, l_n, l_d


def view_loss_and_backward(p, alive, viewmat, K, gt, cfg, sh_degree, max_t, budgets,
                           scale: float, iteration: int, dtype=torch.float32, faults=None):
    """Loss of one view; its gradient times ``scale`` is added into the
    leaves' ``.grad``. Returns (loss, pairs, n_isect, maps)."""
    faults = faults or {}
    s = project(p["means"], p["quats"], p["log_scales"],
                R.masked_logits(p["logit_opacities"], alive), RT.sh_coeffs(p), viewmat, K,
                cfg["width"], cfg["height"], sh_degree, dtype)
    b = R.bin_view(s.screen, cfg["width"], cfg["height"], cfg["tile_size"], max_t, budgets)
    nf = faults.get("no_filter", False)
    maps, pairs = blend(b, s, cfg["width"], cfg["height"], cfg["tile_size"],
                        cfg["raster_chunk"], dtype, nf)
    leaf = maps.detach().requires_grad_(True)
    loss, _, _ = view_terms(leaf, viewmat, K, gt, cfg, iteration,
                            faults.get("drop_dist", False), faults.get("drop_normal", False))
    (d_maps,) = torch.autograd.grad(loss * scale, leaf)
    leaves = [t.detach().requires_grad_(True) for t in s[:5]]
    s2 = Surfels(*leaves, s.screen)
    blend_backward(b, s2, d_maps, cfg["width"], cfg["height"], cfg["tile_size"],
                   cfg["raster_chunk"], dtype, nf)
    outs, grads = [], []
    for o, leaf_t in zip(s[:5], leaves):
        if leaf_t.grad is not None:
            outs.append(o)
            grads.append(leaf_t.grad)
    torch.autograd.backward(outs, grads)
    return float(loss.detach()), pairs, b.n_isect, maps


def reference_steps(init: Dict[str, np.ndarray], alive: np.ndarray, viewmats, Ks, targets,
                    batches: Sequence[np.ndarray], cfg: dict, sh_degree: int, max_t: int,
                    budgets, start_iter: int, adam_step: int, device, dtype=torch.float32,
                    faults=None, keep_maps: bool = True) -> dict:
    """``train.reference_steps`` for surfels: the trainer's first
    ``len(batches)`` steps from ``init``, each view's loss with the two
    regularizers at the step's iteration. Also returns the first step's
    views' maps (``maps``, host float32, with ``keep_maps``)."""
    dev = device
    p = {k: torch.as_tensor(init[k], device=dev).float() for k in PARAM_KEYS}
    p0 = {k: v.clone() for k, v in p.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.as_tensor(init["nu/" + k], device=dev).float() for k in PARAM_KEYS}
    alive_t = torch.as_tensor(alive, device=dev)
    b1, b2, eps = cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"]
    losses, grad_norms, pairs, isects, maps0 = [], {}, [], [], []
    step = adam_step
    for i, views in enumerate(batches):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        total = 0.0
        for v in list(views):
            gt = torch.as_tensor(targets[v], device=dev).float() / 255.0
            loss, n_pairs, n_isect, maps = view_loss_and_backward(
                leaves, alive_t, viewmats[v].to(dev), Ks[v].to(dev), gt, cfg, sh_degree,
                max_t, budgets, 1.0 / len(views), start_iter + i, dtype, faults)
            total += loss
            pairs.append(n_pairs)
            isects.append(n_isect)
            if i == 0 and keep_maps:
                maps0.append(maps[..., 3:12].cpu())
            del maps
        reg = RT.scale_reg(leaves["log_scales"], alive_t, cfg["scale_reg_max_ratio"],
                           cfg["scale_reg_weight"])
        reg.backward()
        losses.append(total / len(views) + float(reg.detach()))
        grads = {k: (leaves[k].grad if leaves[k].grad is not None
                     else torch.zeros_like(leaves[k])) for k in PARAM_KEYS}
        if i == 0:
            grad_norms = {k: float(torch.linalg.norm(g.double())) for k, g in grads.items()}
        with torch.no_grad():
            step += 1
            t = torch.tensor(float(step), dtype=torch.float32)
            c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** t
            c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** t
            lrs = RT.group_lrs(cfg, start_iter + i)
            for k in PARAM_KEYS:
                g = grads[k]
                mu[k].mul_(b1).add_((1.0 - b1) * g)
                nu[k].mul_(b2).add_((1.0 - b2) * g * g)
                p[k] = p[k] - lrs[k] * (mu[k] / c1.to(dev)) / (torch.sqrt(nu[k] / c2.to(dev))
                                                                + eps)
            e = torch.full((), float(cfg["extent"]), dtype=torch.float32, device=dev)
            p["log_scales"] = torch.clamp_max(p["log_scales"],
                                              torch.log(e * cfg["scale_clamp_ratio"] + 1e-9))
        del leaves, grads
    change = {k: float(torch.linalg.norm((p[k] - p0[k]).double())) for k in PARAM_KEYS}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "pairs": pairs, "isects": isects, "maps": maps0}


def _rotmat(q: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotation of the normalized quaternion, as the program's
    densify computes it."""
    q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), 1e-12)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz, xy, xz, yz = x * x, y * y, z * z, x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
                        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
                        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)],
                       dim=-1).reshape(q.shape[:-1] + (3, 3))


def tangent_offsets(quats, child_scales, n):
    """The split child's offset s_u n_1 t_u + s_v n_2 t_v."""
    rot = _rotmat(quats)
    tu = rot[:, :, 0] * child_scales[:, :1]
    tv = rot[:, :, 1] * child_scales[:, 1:2]
    return tu * n[:, :1] + tv * n[:, 1:2]


def densify(params: Dict[str, torch.Tensor], mu, nu, alive, grad_accum, grad_count, cfg,
            extent: float, normals) -> dict:
    """``train.densify`` for surfels: the same clone, split, cap and prune,
    the split children drawn in the tangent plane (``tangent_offsets`` of
    the first two columns of ``normals``, two (C, 3) draws)."""
    C = params["means"].shape[0]
    dev = params["means"].device
    ext = torch.tensor(extent, dtype=torch.float32, device=dev)
    grad = torch.linalg.norm(grad_accum / (grad_count + 1e-8), dim=-1)
    max_scale = torch.amax(torch.exp(params["log_scales"]), dim=-1)
    op = torch.sigmoid(params["logit_opacities"])[:, 0]
    n_alive = torch.sum(alive.to(torch.int32))
    hot = alive & (grad >= cfg["densify_grads_threshold"]) & (op > cfg["densify_min_opacity"])
    clone = hot & (max_scale <= ext * cfg["densify_clone_extent_ratio"])
    split = hot & (max_scale > ext * cfg["densify_clone_extent_ratio"])
    budget = torch.clamp_min(min(int(cfg["max_gaussians"]), C) - n_alive, 0)
    both = clone | split
    order = torch.argsort(-torch.where(both, grad, torch.full_like(grad, -float("inf"))),
                          stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(C, device=dev)
    keep = both & (rank < budget)
    clone, split = clone & keep, split & keep
    n_clone, n_split = int(clone.sum()), int(split.sum())
    free = RT._nonzero_padded(~alive)
    csrc, ssrc = RT._nonzero_padded(clone), RT._nonzero_padded(split)
    slot = torch.arange(C, device=dev)
    p = dict(params)
    mu, nu = dict(mu), dict(nu)

    def scatter(tab, src, dst, valid):
        d = torch.where(valid, dst, torch.full_like(dst, C))
        return {k: RT._set_rows(v, d, v[torch.clamp_max(src, C - 1)]) for k, v in tab.items()}

    def zero(tab, dst, valid):
        d = torch.where(valid, dst, torch.full_like(dst, C))
        return {k: RT._set_rows(v, d, torch.zeros_like(v)) for k, v in tab.items()}

    cvalid = slot < n_clone
    p = scatter(p, csrc, free, cvalid)
    alive = RT._set_rows(alive, torch.where(cvalid, free, C), torch.ones_like(alive))
    mu, nu = zero(mu, free, cvalid), zero(nu, free, cvalid)
    svalid = slot < n_split
    child2 = free[torch.clamp_max(slot + n_clone, C - 1)]
    p = scatter(p, ssrc, child2, svalid)
    alive = RT._set_rows(alive, torch.where(svalid, child2, C), torch.ones_like(alive))
    n1, n2 = normals
    src = torch.clamp_max(ssrc, C - 1)
    child_ls = params["log_scales"][src] - torch.log(torch.tensor(1.6, device=dev))
    child_s = torch.exp(child_ls)
    pm = params["means"][src]
    q = params["quats"][src]
    d1 = torch.where(svalid, ssrc, C)
    d2 = torch.where(svalid, child2, C)
    p["means"] = RT._set_rows(RT._set_rows(p["means"], d1, pm + tangent_offsets(q, child_s, n1)),
                              d2, pm + tangent_offsets(q, child_s, n2))
    p["log_scales"] = RT._set_rows(RT._set_rows(p["log_scales"], d1, child_ls), d2, child_ls)
    for dst in (ssrc, child2):
        mu, nu = zero(mu, dst, svalid), zero(nu, dst, svalid)
    max2 = torch.amax(torch.exp(p["log_scales"]), dim=-1)
    op2 = torch.sigmoid(p["logit_opacities"])[:, 0]
    prune = alive & ((op2 < cfg["densify_min_opacity"])
                     | (max2 > ext * cfg["densify_prune_extent_ratio"]))
    alive = alive & ~prune
    return {"params": p, "mu": mu, "nu": nu, "alive": alive, "n_cloned": n_clone,
            "n_split": n_split, "n_pruned": int(prune.sum())}
