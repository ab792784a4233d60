"""The plain reference of a training step and of a densify event, in plain
PyTorch and NumPy. It imports nothing of the program.

A step: render each view of the batch (``render.project``, ``bin_view``,
``blend``), the photometric loss (1 - lambda) L1 + lambda (1 - SSIM) of the
straight-through-clamped image (3x3 average-pool SSIM), the anisotropy hinge
regularizer, one backward (the blend recomputed tile batch by tile batch
under autograd), Adam with one shared step counter and per-group rates (the
position rate decaying exponentially), the scale ceiling. What the trainer
derives at set-up (the tile cap from the p95 of the footprints, the class
budgets from their histograms over three views, the batches its sampler
draws) is worked out again here from the same inputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import render as R

PARAM_KEYS = ("means", "quats", "log_scales", "logit_opacities", "features_dc",
              "features_rest")


# ---- what the trainer derives at set-up ----------------------------------


def tile_counts_host(s: R.Screen, alive: np.ndarray, width: int, height: int, ts: int):
    """The nonzero sheared-window tile counts of the alive gaussians, in
    float64 on the host, as the trainer measures footprints."""
    m = s.means2d.detach().cpu().double().numpy()[alive]
    r = s.radii.cpu().double().numpy()[alive]
    c = s.conics.detach().cpu().double().numpy()[alive]
    op = s.opac.detach().cpu().double().numpy()[alive]
    ntx, nty = R.cdiv(width, ts), R.cdiv(height, ts)
    ca, cb, cc = c[:, 0], c[:, 1], c[:, 2]
    ca_s = np.maximum(ca, 1e-12)
    det_s = np.maximum(ca * cc - cb * cb, 1e-20)
    Q = 2.0 * (np.log(255.0 * np.maximum(op, 1e-12)) + 1e-3)
    xe = np.minimum(r, np.sqrt(np.maximum(Q, 0) * np.maximum(cc, 1e-12) / det_s) + R.WINDOW_EPS)
    ye = np.minimum(r, np.sqrt(np.maximum(Q, 0) * ca_s / det_s) + R.WINDOW_EPS)
    tx0 = np.clip(np.floor((m[:, 0] - xe) / ts), 0, ntx)
    tx1 = np.clip(np.ceil((m[:, 0] + xe) / ts), 0, ntx)
    ty0 = np.clip(np.floor((m[:, 1] - ye) / ts), 0, nty)
    ty1 = np.clip(np.ceil((m[:, 1] + ye) / ts), 0, nty)
    nx = np.maximum(tx1 - tx0, 0)
    ny = np.maximum(ty1 - ty0, 0)
    w_px = (np.abs(cb) * ts + 2.0 * np.sqrt(np.maximum(Q, 0) * ca_s)) / ca_s + 2 * R.WINDOW_EPS
    nt = ny * np.minimum(np.ceil(w_px / ts) + 1, nx)
    nt = np.where((r > 0) & (op >= R.ALPHA_SKIP), nt, 0).astype(np.int64)
    return nt[nt > 0]


def measured_views(n_views: int) -> np.ndarray:
    return np.linspace(0, n_views - 1, min(3, n_views)).astype(int)


def footprint_counts(params: Dict[str, torch.Tensor], alive: torch.Tensor, viewmats, Ks,
                     width: int, height: int, ts: int) -> List[np.ndarray]:
    out = []
    alive_np = alive.cpu().numpy()
    with torch.no_grad():
        for i in measured_views(len(viewmats)):
            s = R.project(params["means"], params["quats"], params["log_scales"],
                          params["logit_opacities"], sh_coeffs(params), viewmats[i], Ks[i],
                          width, height, 0, opacity_radius=False)
            nt = tile_counts_host(s, alive_np, width, height, ts)
            if len(nt):
                out.append(nt)
    return out


def choose_max_tiles(counts, capacity: int, max_t0: int, max_sort_entries: int) -> int:
    if not counts:
        return max_t0
    p95 = float(np.percentile(np.concatenate(counts), 95))
    budget = max(max_sort_entries // max(capacity, 1), 8)
    chosen = int(min(max(p95, max_t0), budget, 256))
    return 1 << (chosen - 1).bit_length()


def _squeeze_under_pow2(budgets, hard_min, caps, align=128, max_trim=0.10):
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


def choose_class_budgets(counts, capacity: int, max_t: int, max_sort_entries: int,
                         headroom: float = 1.1) -> tuple:
    """Per-class budgets: the per-class maximum over the measured views,
    times ``headroom``, rounded up to 128 plus 128, at most the capacity,
    trimmed under a power of two where that costs at most a tenth of the
    slots, scaled down to ``max_sort_entries`` slots if above."""
    caps = np.asarray(R.class_caps(int(max_t)), np.int64)
    L = len(caps)
    per_view = [np.bincount(np.searchsorted(caps, np.clip(nt, 1, max_t)), minlength=L)[:L]
                for nt in counts]
    cnt = np.max(per_view, axis=0) if per_view else np.zeros(L, np.int64)
    budgets = np.ceil(cnt * headroom / 128.0).astype(np.int64) * 128 + 128
    budgets = np.minimum(budgets, capacity)
    hard_min = np.minimum(np.ceil(cnt / 128.0).astype(np.int64) * 128, capacity)
    budgets = np.asarray(_squeeze_under_pow2(budgets, hard_min, caps), np.int64)
    slots = int((budgets * caps).sum())
    if slots > max_sort_entries:
        scale = max_sort_entries / slots
        budgets = np.maximum((budgets * scale).astype(np.int64) // 128 * 128, 128)
    return tuple(int(b) for b in budgets)


def batch_schedule(n_views: int, batch: int, steps: int, val_seed: int, val_fraction: float,
                   val_max_views: int) -> List[np.ndarray]:
    """The view indices of the first ``steps`` batches the trainer's sampler
    draws: the validation views held out by ``RandomState(val_seed)``, then
    one choice with replacement a step from ``default_rng(val_seed + 1)``."""
    rng = np.random.RandomState(val_seed)
    n_val = 0 if n_views < 4 else min(max(1, int(round(n_views * val_fraction))),
                                      val_max_views)
    perm = rng.permutation(n_views)
    val = set(np.sort(perm[:n_val]).tolist())
    train_idx = np.array([i for i in range(n_views) if i not in val])
    brng = np.random.default_rng(val_seed + 1)
    return [train_idx[brng.choice(len(train_idx), batch, replace=True)] for _ in range(steps)]


# ---- the step ------------------------------------------------------------


def sh_coeffs(p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([p["features_dc"], p["features_rest"]], dim=1)


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


def scale_reg(log_scales, alive, max_ratio: float, weight: float):
    s = torch.exp(log_scales)
    ratio = s.amax(-1) / torch.clamp_min(s.amin(-1), 1e-8)
    hinge = torch.clamp_min(ratio, max_ratio) - max_ratio
    a = alive.to(log_scales.dtype)
    return weight * (hinge * a).sum() / torch.clamp_min(a.sum(), 1.0)


def xyz_lr(cfg: dict, iteration: int) -> torch.Tensor:
    """The position rate, decaying exponentially, in float32."""
    progress = torch.clamp_max(torch.tensor(float(iteration), dtype=torch.float32)
                               / float(cfg["position_lr_max_steps"]), 1.0)
    ratio = cfg["position_lr_final"] / cfg["position_lr_init"]
    return cfg["position_lr_init"] * torch.pow(torch.full_like(progress, ratio), progress)


def group_lrs(cfg: dict, iteration: int) -> Dict[str, float]:
    return {"means": float(xyz_lr(cfg, iteration)), "quats": cfg["lr_rotation"],
            "log_scales": cfg["lr_scaling"], "logit_opacities": cfg["lr_opacity"],
            "features_dc": cfg["lr_features_dc"], "features_rest": cfg["lr_features_rest"]}


def view_loss_and_backward(p, alive, viewmat, K, gt, cfg, sh_degree, max_t, budgets,
                           scale: float, dtype=torch.float32):
    """Loss of one view; its gradient times ``scale`` is added into the
    leaves' ``.grad``. Returns (loss, pairs, n_isect)."""
    s = R.project(p["means"], p["quats"], p["log_scales"],
                  R.masked_logits(p["logit_opacities"], alive), sh_coeffs(p), viewmat, K,
                  cfg["width"], cfg["height"], sh_degree, dtype)
    b = R.bin_view(s, cfg["width"], cfg["height"], cfg["tile_size"], max_t, budgets)
    img, pairs = R.blend(b, s, cfg["width"], cfg["height"], cfg["tile_size"],
                         cfg["raster_chunk"], dtype)
    img = img.float().detach().requires_grad_(True)
    loss = photometric(img, gt, cfg["lambda_dssim"])
    (d_img,) = torch.autograd.grad(loss * scale, img)
    leaves = [t.detach().requires_grad_(True) for t in (s.means2d, s.conics, s.colors, s.opac)]
    s2 = R.Screen(*leaves, s.depths.detach(), s.radii)
    R.blend_backward(b, s2, d_img, cfg["width"], cfg["height"], cfg["tile_size"],
                     cfg["raster_chunk"], dtype)
    outs, grads = [], []
    for o, leaf in zip((s.means2d, s.conics, s.colors, s.opac), leaves):
        if leaf.grad is not None:
            outs.append(o)
            grads.append(leaf.grad)
    torch.autograd.backward(outs, grads)
    return float(loss.detach()), pairs, b.n_isect


def reference_steps(init: Dict[str, np.ndarray], alive: np.ndarray, viewmats, Ks, targets,
                    batches: Sequence[np.ndarray], cfg: dict, sh_degree: int, max_t: int,
                    budgets, start_iter: int, adam_step: int, device,
                    dtype=torch.float32, drop_half: bool = False) -> dict:
    """Follow the trainer's first ``len(batches)`` steps from ``init`` (the
    checkpoint's parameters, Adam moments mu = 0 and ``nu/<leaf>``).
    ``targets`` is (V, H, W, 3) uint8. Returns the losses, the first step's
    gradient norm of each leaf, each leaf's change after the last step, and
    the pairs that carried a weight and the intersections of each view.
    ``drop_half`` (a fault) renders only the first half of each batch and
    takes the mean over it."""
    dev = device
    p = {k: torch.as_tensor(init[k], device=dev).float() for k in PARAM_KEYS}
    p0 = {k: v.clone() for k, v in p.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.as_tensor(init["nu/" + k], device=dev).float() for k in PARAM_KEYS}
    alive_t = torch.as_tensor(alive, device=dev)
    b1, b2, eps = cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"]
    losses, grad_norms, pairs, isects = [], {}, [], []
    step = adam_step
    for i, views in enumerate(batches):
        views = list(views)[:max(1, len(views) // 2)] if drop_half else list(views)
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        total = 0.0
        for v in views:
            gt = torch.as_tensor(targets[v], device=dev).float() / 255.0
            loss, n_pairs, n_isect = view_loss_and_backward(
                leaves, alive_t, viewmats[v].to(dev), Ks[v].to(dev), gt, cfg, sh_degree,
                max_t, budgets, 1.0 / len(views), dtype)
            total += loss
            pairs.append(n_pairs)
            isects.append(n_isect)
        reg = scale_reg(leaves["log_scales"], alive_t, cfg["scale_reg_max_ratio"],
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
            lrs = group_lrs(cfg, start_iter + i)
            for k in PARAM_KEYS:
                g = grads[k]
                mu[k].mul_(b1).add_((1.0 - b1) * g)
                nu[k].mul_(b2).add_((1.0 - b2) * g * g)
                p[k] = p[k] - lrs[k] * (mu[k] / c1.to(dev)) / (torch.sqrt(nu[k] / c2.to(dev)) + eps)
            e = torch.full((), float(cfg["extent"]), dtype=torch.float32, device=dev)
            p["log_scales"] = torch.clamp_max(p["log_scales"],
                                              torch.log(e * cfg["scale_clamp_ratio"] + 1e-9))
        del leaves, grads
    change = {k: float(torch.linalg.norm((p[k] - p0[k]).double())) for k in PARAM_KEYS}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "pairs": pairs, "isects": isects}


# ---- densify -------------------------------------------------------------


def _nonzero_padded(mask):
    C = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    out = torch.full((C + 1,), C, dtype=torch.int64, device=mask.device)
    out.scatter_(0, torch.where(mask, pos, torch.full_like(pos, C)),
                 torch.arange(C, device=mask.device))
    out[C] = C
    return out[:C]


def _set_rows(a, dst, rows):
    C = a.shape[0]
    ext = torch.cat([a, a[:1]])
    ext.index_copy_(0, dst, rows)
    return ext[:C]


def densify(params: Dict[str, torch.Tensor], mu, nu, alive, grad_accum, grad_count, cfg,
            extent: float, normals) -> dict:
    """One clone/split/prune sweep: gaussians whose mean accumulated
    position gradient reaches the threshold, with opacity above the
    minimum, are cloned into free slots (small ones) or split in two (large
    ones, children at scale / 1.6 around the parent by ``normals``), the
    highest gradients first when the population cap binds; then gaussians
    too transparent or too large die. Adam moments of new gaussians are
    zeroed."""
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
    cap = min(int(cfg["max_gaussians"]), C)
    budget = torch.clamp_min(cap - n_alive, 0)
    both = clone | split
    order = torch.argsort(-torch.where(both, grad, torch.full_like(grad, -float("inf"))),
                          stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(C, device=dev)
    keep = both & (rank < budget)
    clone, split = clone & keep, split & keep
    n_clone, n_split = int(clone.sum()), int(split.sum())
    free = _nonzero_padded(~alive)
    csrc, ssrc = _nonzero_padded(clone), _nonzero_padded(split)
    slot = torch.arange(C, device=dev)
    p = dict(params)
    mu, nu = dict(mu), dict(nu)

    def scatter(tab, src, dst, valid):
        d = torch.where(valid, dst, torch.full_like(dst, C))
        return {k: _set_rows(v, d, v[torch.clamp_max(src, C - 1)]) for k, v in tab.items()}

    def zero(tab, dst, valid):
        d = torch.where(valid, dst, torch.full_like(dst, C))
        return {k: _set_rows(v, d, torch.zeros_like(v)) for k, v in tab.items()}

    cvalid = slot < n_clone
    p = scatter(p, csrc, free, cvalid)
    alive = _set_rows(alive, torch.where(cvalid, free, C), torch.ones_like(alive))
    mu, nu = zero(mu, free, cvalid), zero(nu, free, cvalid)
    svalid = slot < n_split
    child2 = free[torch.clamp_max(slot + n_clone, C - 1)]
    p = scatter(p, ssrc, child2, svalid)
    alive = _set_rows(alive, torch.where(svalid, child2, C), torch.ones_like(alive))
    n1, n2 = normals
    src = torch.clamp_max(ssrc, C - 1)
    child_ls = params["log_scales"][src] - torch.log(torch.tensor(1.6, device=dev))
    child_s = torch.exp(child_ls)
    pm = params["means"][src]
    d1 = torch.where(svalid, ssrc, C)
    d2 = torch.where(svalid, child2, C)
    p["means"] = _set_rows(_set_rows(p["means"], d1, pm + n1 * child_s), d2, pm + n2 * child_s)
    p["log_scales"] = _set_rows(_set_rows(p["log_scales"], d1, child_ls), d2, child_ls)
    for dst in (ssrc, child2):
        mu, nu = zero(mu, dst, svalid), zero(nu, dst, svalid)
    max2 = torch.amax(torch.exp(p["log_scales"]), dim=-1)
    op2 = torch.sigmoid(p["logit_opacities"])[:, 0]
    prune = alive & ((op2 < cfg["densify_min_opacity"])
                     | (max2 > ext * cfg["densify_prune_extent_ratio"]))
    alive = alive & ~prune
    return {"params": p, "mu": mu, "nu": nu, "alive": alive, "n_cloned": n_clone,
            "n_split": n_split, "n_pruned": int(prune.sum())}


def split_normals(capacity: int, seed: int, device) -> tuple:
    """The split noise of the trainer's first densify event: two (C, 3)
    standard normals from a generator on ``device`` seeded ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn((capacity, 3), generator=g, device=device) for _ in range(2))


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              keys: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """|got - want| of each leaf's norm over the larger of the reference's
    norm of that leaf and the median leaf's."""
    keys = list(want) if keys is None else list(keys)
    med = float(np.median([want[k] for k in want]))
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys}
