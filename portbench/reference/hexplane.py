"""The plain reference of 4D Gaussian Splatting (Wu et al., CVPR 2024, arXiv
2310.08528) for the benchmark, in plain PyTorch. It imports nothing of the
program; it extends ``reference/train.py`` (the static step, its renderer,
Adam and densify) and ``reference/deform.py`` by import.

The field (``field``): the configuration's scales, six planes a scale over
the pairs of (x, y, z, t) in ``itertools.combinations(range(4), 2)`` order,
held channel-last (R_j, R_i, C) under the program's names and sampled as
the K-Planes wrapper samples them, ``F.grid_sample(align_corners=True,
padding_mode="border")`` of the (1, C, R_j, R_i) view; a scale's feature is
1. times the six samples; the scales' features concatenated. The decoder:
Linear(2C, W) of the feature, then each head (pos 3, scales 3, rotations 4)
ReLU, Linear(W, W), ReLU, Linear(W, k), one by one, float32 with TF32 off.
The coordinates: x^ = (x - a_min) (2 / (a_max - a_min)) - 1 of the box, and
the view's time. The offsets apply before the activations: mean + dx,
quaternion + dr, log-scales + ds, handed to the static renderer as they
are.

A step (``reference_steps``): for each view of the batch the offsets of the
alive slots at the view's time (zero elsewhere), the static view loss and
its backward into the gaussians and the offsets, then the field's and
decoder's backward in row blocks with the offsets' gradients, into the
field and into the means through the field's coordinates; then the
regularizers (the spatial planes' and the time planes' mean squared second
difference along their rows, the time planes' mean |1 - P|), the scale
hinge, Adam of the six groups and of every field tensor on one shared step
counter, the planes at the grid rate and the decoder at the deformation
rate, both times the extent and decaying over the fine stage; the scale
ceiling.

``dtype`` bfloat16 (the control) rounds the planes, the coordinates and the
features to bfloat16 and runs the decoder and the renderer in bfloat16.
``faults`` (each a mechanism the model may not simplify): ``detach`` keeps
the means out of the field's coordinates, ``after`` adds the offsets after
the activations, ``no_reg`` drops the regularizers.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import deform as RD
from portbench.reference import train as RT

PAIRS = list(itertools.combinations(range(4), 2))
HEADS = (("pos_deform", 3), ("scales_deform", 3), ("rotations_deform", 4))
ROW_BLOCK = 1 << 18


def plane_names(spec: dict) -> List[str]:
    return [f"grids.{s}.{p}" for s in range(len(spec["multires"])) for p in range(len(PAIRS))]


def shapes(spec: dict) -> List[tuple]:
    """(name, shape) of every tensor: the planes, channel-last, then the
    decoder's; ``spec`` is the configuration's ``hexplane`` section."""
    C, W, res = spec["channels"], spec["net_width"], spec["resolution"]
    out = []
    for s, m in enumerate(spec["multires"]):
        r = [x * m for x in res[:3]] + [res[3]]
        for p, (i, j) in enumerate(PAIRS):
            out.append((f"grids.{s}.{p}", (r[j], r[i], C)))
    out += [("feature_out.0.weight", (W, C * len(spec["multires"]))),
            ("feature_out.0.bias", (W,))]
    for name, k in HEADS:
        out += [(f"{name}.1.weight", (W, W)), (f"{name}.1.bias", (W,)),
                (f"{name}.3.weight", (k, W)), (f"{name}.3.bias", (k,))]
    return out


def init_field(spec: dict, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The published initialisation from the generator ``g``: spatial
    planes uniform in ``init_range``, time planes ones; each linear's
    weight Xavier-uniform, its bias uniform in +-1/sqrt(fan_in)."""
    lo, hi = spec["init_range"]
    out = {}
    for name, shape in shapes(spec):
        if name.startswith("grids."):
            p = int(name.rsplit(".", 1)[1])
            out[name] = (torch.ones(shape, device=device) if 3 in PAIRS[p]
                         else lo + (hi - lo) * torch.rand(shape, generator=g, device=device))
        elif name.endswith(".weight"):
            bound = (6.0 / (shape[0] + shape[1])) ** 0.5
            out[name] = (torch.rand(shape, generator=g, device=device) * 2.0 - 1.0) * bound
            fan_in = shape[1]
        else:
            out[name] = ((torch.rand(shape, generator=g, device=device) * 2.0 - 1.0)
                         / fan_in ** 0.5)
    return out


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).float()


def field(net: Dict[str, torch.Tensor], spec: dict, pts: torch.Tensor,
          dtype=torch.float32) -> torch.Tensor:
    """The (R, 2C) feature of ``pts`` (R, 4) = (x^, t)."""
    pts = _round(pts, dtype)
    n = pts.shape[0]
    feats = []
    for s in range(len(spec["multires"])):
        interp = 1.0
        for p, (i, j) in enumerate(PAIRS):
            grid = _round(net[f"grids.{s}.{p}"], dtype).permute(2, 0, 1)[None]
            out = F.grid_sample(grid, pts[:, [i, j]].view(1, 1, n, 2), align_corners=True,
                                mode="bilinear", padding_mode="border")
            interp = interp * out.view(grid.shape[1], n).transpose(0, 1)
        feats.append(interp)
    return _round(torch.cat(feats, dim=-1), dtype)


def decoder(net: Dict[str, torch.Tensor], feat: torch.Tensor, dtype=torch.float32):
    """(dx, dr, ds) of the features, each head one by one."""
    with RD.float32_matmul():
        w = {k: v.to(dtype) for k, v in net.items() if not k.startswith("grids.")}
        h = F.linear(feat.to(dtype), w["feature_out.0.weight"], w["feature_out.0.bias"])
        out = {}
        for name, _ in HEADS:
            z = F.relu(F.linear(F.relu(h), w[f"{name}.1.weight"], w[f"{name}.1.bias"]))
            out[name] = F.linear(z, w[f"{name}.3.weight"], w[f"{name}.3.bias"]).float()
    return out["pos_deform"], out["rotations_deform"], out["scales_deform"]


def normalise(x: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    return (x - box[0]) * (2.0 / (box[1] - box[0])) - 1.0


def block_offsets(net, spec: dict, box: torch.Tensor, x: torch.Tensor, t: float,
                  dtype=torch.float32):
    """(dx, dr, ds) of the means ``x`` (R, 3) of one block at time ``t``."""
    pts = torch.cat([normalise(x, box), torch.full((x.shape[0], 1), float(t), device=x.device)],
                    dim=-1)
    return decoder(net, field(net, spec, pts, dtype), dtype)


def offsets(net, spec: dict, box: torch.Tensor, means: torch.Tensor, rows: torch.Tensor,
            t: float, dtype=torch.float32):
    """The (N, 3), (N, 4), (N, 3) offsets at time ``t``: the field and the
    decoder over the slots ``rows`` of ``means`` in row blocks, zero
    elsewhere, no gradient."""
    n = means.shape[0]
    out = [torch.zeros((n, k), device=means.device) for k in (3, 4, 3)]
    with torch.no_grad():
        for s in range(0, rows.numel(), ROW_BLOCK):
            r = rows[s:s + ROW_BLOCK]
            for o, v in zip(out, block_offsets(net, spec, box, means[r], t, dtype)):
                o[r] = v
    return out


def field_backward(net_leaves, spec: dict, box: torch.Tensor, means_leaf: torch.Tensor,
                   rows: torch.Tensor, t: float, grads: Sequence[torch.Tensor],
                   dtype=torch.float32, detach: bool = False) -> None:
    """Add the gradients of the offsets' gradients ``grads`` (N, .) into
    the field tensors' and the means' ``.grad`` (the means' only through the
    field's coordinates, none with ``detach``), recomputing block by
    block."""
    inputs = list(net_leaves.values()) + ([] if detach else [means_leaf])
    for s in range(0, rows.numel(), ROW_BLOCK):
        r = rows[s:s + ROW_BLOCK]
        x = means_leaf.detach()[r] if detach else means_leaf[r]
        outs = block_offsets(net_leaves, spec, box, x, t, dtype)
        torch.autograd.backward(list(outs), [g[r] for g in grads], inputs=inputs)


def deformed_params(p: Dict[str, torch.Tensor], offs, after: bool = False):
    """The raw parameters the static renderer takes: means + dx, quats +
    dr, log-scales + ds (before the activations); with ``after`` (a fault)
    Deformable 3D Gaussians' rule, after them."""
    if after:
        return RD.deformed_params(p, offs)
    dx, dr, ds = offs
    out = dict(p)
    out["means"] = p["means"] + dx
    out["quats"] = p["quats"] + dr
    out["log_scales"] = p["log_scales"] + ds
    return out


def _smoothness(plane: torch.Tensor) -> torch.Tensor:
    first = plane[1:] - plane[:-1]
    return torch.square(first[1:] - first[:-1]).mean()


def regularizer(net: Dict[str, torch.Tensor], spec: dict, sched: dict) -> torch.Tensor:
    """The three terms at the configuration's weights, summed over the
    scales."""
    space = time = l1 = 0.0
    for name in plane_names(spec):
        plane = net[name]
        if 3 in PAIRS[int(name.rsplit(".", 1)[1])]:
            time = time + _smoothness(plane)
            l1 = l1 + torch.abs(1.0 - plane).mean()
        else:
            space = space + _smoothness(plane)
    return (sched["plane_tv_weight"] * space + sched["time_smoothness_weight"] * time
            + sched["l1_time_planes"] * l1)


def rates(sched: dict, iteration: int, warmup: int, extent: float) -> Dict[str, float]:
    """The grid and deformation rates at the port's ``iteration``."""
    scale = extent if sched["lr_times_extent"] else 1.0
    fine = max(iteration - warmup, 0)
    return {kind: float(RD.exp_lr(a * scale, b * scale, sched["lr_max_steps"], fine))
            for kind, (a, b) in (("grid", sched["grid_lr"]),
                                 ("deformation", sched["deformation_lr"]))}


def reference_steps(init: Dict[str, np.ndarray], net0: Dict[str, torch.Tensor],
                    net_nu: Dict[str, torch.Tensor], spec: dict, sched: dict,
                    box: torch.Tensor, alive: np.ndarray, viewmats, Ks, targets,
                    times: Sequence[np.ndarray], batches: Sequence[np.ndarray], cfg: dict,
                    sh_degree: int, max_t: int, budgets, start_iter: int, adam_step: int,
                    warmup: int, device, dtype=torch.float32, faults=None) -> dict:
    """Follow the trainer's first ``len(batches)`` steps from the
    checkpoint's gaussians ``init`` (Adam mu 0, ``nu/<leaf>``) and the field
    ``net0`` (mu 0, ``net_nu``). ``times[i]`` holds the times of batch i's
    views. ``cfg``: ``reference_config``'s keys. Returns the losses, the
    first step's gradient norm of each leaf (the groups' and the field
    tensors'), each leaf's change after the last step, the first step's
    offsets of each view, and the pairs and intersections."""
    faults = faults or {}
    dev = device
    p = {k: torch.as_tensor(init[k], device=dev).float() for k in RT.PARAM_KEYS}
    net = {k: v.detach().clone() for k, v in net0.items()}
    p0 = {**{k: v.clone() for k, v in p.items()}, **{k: v.clone() for k, v in net.items()}}
    mu = {k: torch.zeros_like(v) for k, v in {**p, **net}.items()}
    nu = {k: torch.as_tensor(init["nu/" + k], device=dev).float() for k in RT.PARAM_KEYS}
    nu.update({k: v.detach().clone() for k, v in net_nu.items()})
    alive_t = torch.as_tensor(alive, device=dev)
    rows = torch.nonzero(alive_t).reshape(-1)
    b1, b2, eps = cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"]
    losses, grad_norms, pairs, isects, first_offsets = [], {}, [], [], []
    step = adam_step
    for i, views in enumerate(batches):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        nleaves = {k: v.detach().requires_grad_(True) for k, v in net.items()}
        total = 0.0
        for v, t in zip(list(views), list(times[i])):
            offs = offsets(net, spec, box, p["means"], rows, float(t), dtype)
            if i == 0:
                first_offsets.append([o.clone() for o in offs])
            oleaves = [o.requires_grad_(True) for o in offs]
            gt = torch.as_tensor(targets[v], device=dev).float() / 255.0
            loss, n_pairs, n_isect = RT.view_loss_and_backward(
                deformed_params(leaves, oleaves, faults.get("after", False)), alive_t,
                viewmats[v].to(dev), Ks[v].to(dev), gt, cfg, sh_degree, max_t, budgets,
                1.0 / len(views), dtype)
            field_backward(nleaves, spec, box, leaves["means"], rows, float(t),
                           [o.grad if o.grad is not None else torch.zeros_like(o)
                            for o in oleaves], dtype, faults.get("detach", False))
            total += loss
            pairs.append(n_pairs)
            isects.append(n_isect)
            del oleaves, offs
        reg = RT.scale_reg(leaves["log_scales"], alive_t, cfg["scale_reg_max_ratio"],
                           cfg["scale_reg_weight"])
        if not faults.get("no_reg", False):
            reg = reg + regularizer(nleaves, spec, sched)
        reg.backward()
        losses.append(total / len(views) + float(reg.detach()))
        grads = {k: (x.grad if x.grad is not None else torch.zeros_like(x))
                 for k, x in {**leaves, **nleaves}.items()}
        if i == 0:
            grad_norms = {k: float(torch.linalg.norm(g.double())) for k, g in grads.items()}
        with torch.no_grad():
            step += 1
            tt = torch.tensor(float(step), dtype=torch.float32)
            c1 = (1.0 - torch.tensor(b1, dtype=torch.float32) ** tt).to(dev)
            c2 = (1.0 - torch.tensor(b2, dtype=torch.float32) ** tt).to(dev)
            lrs = RT.group_lrs(cfg, start_iter + i)
            frates = rates(sched, start_iter + i, warmup, cfg["extent"])
            for k, g in grads.items():
                mu[k].mul_(b1).add_((1.0 - b1) * g)
                nu[k].mul_(b2).add_((1.0 - b2) * g * g)
                upd = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
                if k in p:
                    p[k] = p[k] - lrs[k] * upd
                else:
                    net[k] = net[k] - frates["grid" if k.startswith("grids.")
                                             else "deformation"] * upd
            e = torch.full((), float(cfg["extent"]), dtype=torch.float32, device=dev)
            p["log_scales"] = torch.clamp_max(p["log_scales"],
                                              torch.log(e * cfg["scale_clamp_ratio"] + 1e-9))
        del leaves, nleaves, grads
    change = {k: float(torch.linalg.norm((v - p0[k]).double()))
              for k, v in {**p, **net}.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "pairs": pairs, "isects": isects, "offsets": first_offsets}
