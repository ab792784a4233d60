"""The plain reference of Deformable 3D Gaussians (Yang et al., CVPR 2024,
arXiv 2309.13101) for the benchmark, in plain PyTorch. It imports nothing of
the program; it extends ``reference/train.py`` (the static step, its
renderer, Adam and densify) by import.

The MLP (``mlp``): gamma(p) = (p, sin(2^k p), cos(2^k p)), k < L, L 10 for
the position and 10 for the time (the code's embedder, no pi); D linears of
width W with ReLU, the encodings fed again in front of h after linear
``skip``; three heads (dx 3, dr 4, ds 3). It runs in row blocks, in float32
with TF32 off whatever the process has set, so that it fits beside the
program's state and reads the same in a control run that turns TF32 on for
the program. The offsets apply after the activations: mean + dx,
normalize(q) + dr (normalized again, as the program does; the published
rasterizer builds its matrix from the sum as it is), exp(log s) + ds, handed
to the static renderer as log|exp(log s) + ds|.

A step (``reference_steps``): for each view of the batch the offsets of the
alive slots at the view's time (zero elsewhere), the static view loss and
its backward into the gaussians and the offsets, then the MLP's backward in
row blocks with the offsets' gradients; the scale hinge, Adam of the six
groups and of every MLP tensor on one shared step counter, the MLP's rate
decaying exponentially, the scale ceiling.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import train as RT

HEADS = (("gaussian_warp", 3), ("gaussian_rotation", 4), ("gaussian_scaling", 3))
ROW_BLOCK = 1 << 17


@contextlib.contextmanager
def float32_matmul():
    """TF32 off for the block, whatever the process has set."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def shapes(spec: dict) -> List[tuple]:
    """(name, shape) of the network's tensors in the published order;
    ``spec``: depth, width, skip, multires_x, multires_t."""
    in_ch = 3 * (1 + 2 * spec["multires_x"]) + 1 + 2 * spec["multires_t"]
    out = []
    for i in range(spec["depth"]):
        fan_in = (in_ch if i == 0 else spec["width"] + in_ch if i == spec["skip"] + 1
                  else spec["width"])
        out += [(f"linear.{i}.weight", (spec["width"], fan_in)),
                (f"linear.{i}.bias", (spec["width"],))]
    for name, k in HEADS:
        out += [(f"{name}.weight", (k, spec["width"])), (f"{name}.bias", (k,))]
    return out


def init_net(spec: dict, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """``torch.nn.Linear``'s initialisation (uniform in +-1/sqrt(fan_in))
    from the generator ``g`` on ``device``."""
    out, fan_in = {}, None
    for name, shape in shapes(spec):
        if name.endswith(".weight"):
            fan_in = shape[1]
        out[name] = (torch.rand(shape, generator=g, device=device) * 2.0 - 1.0) / math.sqrt(
            fan_in)
    return out


def embed(p: torch.Tensor, multires: int) -> torch.Tensor:
    out = [p]
    for k in range(multires):
        out += [torch.sin(p * float(2 ** k)), torch.cos(p * float(2 ** k))]
    return torch.cat(out, dim=-1)


def mlp(net: Dict[str, torch.Tensor], spec: dict, x: torch.Tensor, t: float):
    """(dx, dr, ds) of positions ``x`` (R, 3) at time ``t``, one block."""
    with float32_matmul():
        x_emb = embed(x, spec["multires_x"])
        t_emb = embed(torch.full((x.shape[0], 1), float(t), device=x.device), spec["multires_t"])
        h = torch.cat([x_emb, t_emb], dim=-1)
        for i in range(spec["depth"]):
            h = F.relu(F.linear(h, net[f"linear.{i}.weight"], net[f"linear.{i}.bias"]))
            if i == spec["skip"]:
                h = torch.cat([x_emb, t_emb, h], -1)
        return tuple(F.linear(h, net[f"{n}.weight"], net[f"{n}.bias"]) for n, _ in HEADS)


def offsets(net, spec: dict, means: torch.Tensor, rows: torch.Tensor, t: float):
    """The (N, 3), (N, 4), (N, 3) offsets at time ``t``: the MLP over the
    slots ``rows`` of ``means`` in row blocks, zero elsewhere, no gradient."""
    n = means.shape[0]
    out = [torch.zeros((n, k), device=means.device) for _, k in HEADS]
    with torch.no_grad():
        for s in range(0, rows.numel(), ROW_BLOCK):
            r = rows[s:s + ROW_BLOCK]
            for o, v in zip(out, mlp(net, spec, means[r], t)):
                o[r] = v
    return out


def mlp_backward(net_leaves, spec: dict, means: torch.Tensor, rows: torch.Tensor, t: float,
                 grads: Sequence[torch.Tensor]) -> None:
    """Add the MLP tensors' gradients of the offsets' gradients ``grads``
    (N, .) into ``net_leaves``' ``.grad``, recomputing the MLP block by
    block."""
    leaves = list(net_leaves.values())
    for s in range(0, rows.numel(), ROW_BLOCK):
        r = rows[s:s + ROW_BLOCK]
        with float32_matmul():
            outs = mlp(net_leaves, spec, means[r].detach(), t)
            torch.autograd.backward(list(outs), [g[r] for g in grads], inputs=leaves)


def deformed_params(p: Dict[str, torch.Tensor], offs) -> Dict[str, torch.Tensor]:
    """The raw parameters the static renderer takes for the deformed
    gaussians: means + dx, normalize(q) + dr, log|exp(log s) + ds|."""
    dx, dr, ds = offs
    q = p["quats"]
    q1 = q / torch.clamp_min(torch.sqrt((q * q).sum(-1, keepdim=True)), 1e-12)
    out = dict(p)
    out["means"] = p["means"] + dx
    out["quats"] = q1 + dr
    out["log_scales"] = torch.log(torch.abs(torch.exp(p["log_scales"]) + ds))
    return out


def exp_lr(init: float, final: float, max_steps: int, iteration: int) -> float:
    progress = torch.clamp_max(torch.tensor(float(iteration), dtype=torch.float32)
                               / float(max_steps), 1.0)
    return float(init * torch.pow(torch.full_like(progress, final / init), progress))


def reference_steps(init: Dict[str, np.ndarray], net0: Dict[str, torch.Tensor],
                    net_nu: Dict[str, torch.Tensor], spec: dict, alive: np.ndarray, viewmats,
                    Ks, targets, times: Sequence[np.ndarray], batches: Sequence[np.ndarray],
                    cfg: dict, sh_degree: int, max_t: int, budgets, start_iter: int,
                    adam_step: int, device) -> dict:
    """Follow the trainer's first ``len(batches)`` steps from the checkpoint's
    gaussians ``init`` (Adam mu 0, ``nu/<leaf>``) and the network ``net0``
    (mu 0, ``net_nu``). ``times[i]`` holds the times (noise included) of
    batch i's views. ``cfg``: ``reference_config``'s keys and the MLP's
    ``deform_lr_init``, ``deform_lr_final``, ``deform_lr_max_steps``.
    Returns the losses, the first step's gradient norm of each leaf (the
    groups' and the MLP tensors'), each leaf's change after the last step,
    the first view's offsets, and the pairs and intersections."""
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
    losses, grad_norms, pairs, isects, first_offsets = [], {}, [], [], None
    step = adam_step
    for i, views in enumerate(batches):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        nleaves = {k: v.detach().requires_grad_(True) for k, v in net.items()}
        total = 0.0
        for v, t in zip(list(views), list(times[i])):
            offs = offsets(net, spec, p["means"], rows, float(t))
            if first_offsets is None:
                first_offsets = [o.clone() for o in offs]
            oleaves = [o.requires_grad_(True) for o in offs]
            gt = torch.as_tensor(targets[v], device=dev).float() / 255.0
            loss, n_pairs, n_isect = RT.view_loss_and_backward(
                deformed_params(leaves, oleaves), alive_t, viewmats[v].to(dev), Ks[v].to(dev),
                gt, cfg, sh_degree, max_t, budgets, 1.0 / len(views))
            mlp_backward(nleaves, spec, p["means"], rows, float(t),
                         [o.grad if o.grad is not None else torch.zeros_like(o)
                          for o in oleaves])
            total += loss
            pairs.append(n_pairs)
            isects.append(n_isect)
            del oleaves, offs
        reg = RT.scale_reg(leaves["log_scales"], alive_t, cfg["scale_reg_max_ratio"],
                           cfg["scale_reg_weight"])
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
            dlr = exp_lr(cfg["deform_lr_init"], cfg["deform_lr_final"],
                         cfg["deform_lr_max_steps"], start_iter + i)
            for k, g in grads.items():
                mu[k].mul_(b1).add_((1.0 - b1) * g)
                nu[k].mul_(b2).add_((1.0 - b2) * g * g)
                upd = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
                if k in p:
                    p[k] = p[k] - lrs[k] * upd
                else:
                    net[k] = net[k] - dlr * upd
            e = torch.full((), float(cfg["extent"]), dtype=torch.float32, device=dev)
            p["log_scales"] = torch.clamp_max(p["log_scales"],
                                              torch.log(e * cfg["scale_clamp_ratio"] + 1e-9))
        del leaves, nleaves, grads
    change = {k: float(torch.linalg.norm((v - p0[k]).double()))
              for k, v in {**p, **net}.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "pairs": pairs, "isects": isects, "offsets": first_offsets}
