"""The plain reference of Deformable 3D Gaussians (Yang et al., CVPR 2024,
arXiv 2309.13101; code ``github.com/ingra14m/Deformable-3D-Gaussians``) in
plain float32 PyTorch, written from the paper and its code, apart from the
port: it imports nothing of ``ops/`` or ``csrc/`` and no JAX.

- The encoding gamma(p) = (p, sin(2^k p), cos(2^k p)), k = 0 .. L-1, in the
  NeRF embedder's order; L 10 for the position, 10 for the time (real
  scenes): 63 + 21 = 84 channels.
- The MLP: D linears of width W with ReLU, the 84 channels concatenated in
  front of h after linear D // 2 (the code's ``skips``), three linear heads
  (dx 3, dr 4, ds 3) run one by one, as ``torch.nn.Linear`` computes them.
- The offsets after the activations: mean + dx, exp(log s) + ds,
  normalize(q) + dr; the position fed to gamma is detached.
- A training step: each view rendered by the caller's ``render_fn`` from
  the deformed gaussians at its time, the photometric loss (1 - lambda) L1
  + lambda (1 - SSIM) of the straight-through-clamped image with 3x3
  average-pool SSIM, the scale-ratio hinge on the canonical scales, one
  backward, Adam on the gaussians' six groups and on every MLP tensor with
  one shared step counter, the scale ceiling.

Departures from the published code, each kept because the port does the
same:
- the rotation: the published rasterizer builds its matrix from the sum
  normalize(q) + dr as it is; here, as in every quaternion the port renders,
  the sum is normalized again first;
- gamma has no pi: the paper writes sin(2^k pi p), the code's embedder
  (which this follows) has none;
- the densify accumulator is ||dL/d mean|| of the canonical means (equal to
  the deformed means' gradient, since mean' = mean + dx), summed into all
  three columns with a count a step, as the static port accumulates it.

``torch.backends.cuda.matmul.allow_tf32`` and ``cudnn.allow_tf32`` are set
False on import: the reference's matrix products are float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PARAM_KEYS = ("means", "quats", "log_scales", "logit_opacities", "features_dc",
              "features_rest")
HEAD_NAMES = ("gaussian_warp", "gaussian_rotation", "gaussian_scaling")


def embed(p: torch.Tensor, multires: int) -> torch.Tensor:
    """gamma(p), the code's ``get_embedder(multires)`` with log sampling:
    frequencies 2^0 .. 2^(multires-1), include_input."""
    freqs = 2.0 ** torch.linspace(0.0, multires - 1, multires)
    out = [p]
    for f in freqs.tolist():
        out.append(torch.sin(p * f))
        out.append(torch.cos(p * f))
    return torch.cat(out, dim=-1)


def depth_of(net: Dict[str, torch.Tensor]) -> Tuple[int, int]:
    """(D, the skip index) of a network's tensors."""
    D = sum(1 for k in net if k.startswith("linear.") and k.endswith(".weight"))
    W = net["linear.0.weight"].shape[0]
    skip = next(i - 1 for i in range(1, D) if net[f"linear.{i}.weight"].shape[1] != W)
    return D, skip


def deform_mlp(net: Dict[str, torch.Tensor], x: torch.Tensor, t: float, multires_x: int = 10,
               multires_t: int = 10):
    """(dx, dr, ds) of the positions ``x`` (R, 3), detached, at time ``t``:
    the published ``DeformNetwork.forward``."""
    D, skip = depth_of(net)
    x_emb = embed(x.detach(), multires_x)
    t_in = torch.full((x.shape[0], 1), float(t), dtype=x.dtype, device=x.device)
    t_emb = embed(t_in, multires_t)
    h = torch.cat([x_emb, t_emb], dim=-1)
    for i in range(D):
        h = F.relu(F.linear(h, net[f"linear.{i}.weight"], net[f"linear.{i}.bias"]))
        if i == skip:
            h = torch.cat([x_emb, t_emb, h], -1)
    return tuple(F.linear(h, net[f"{n}.weight"], net[f"{n}.bias"]) for n in HEAD_NAMES)


def deformed(means, quats, log_scales, dx, dr, ds):
    """(mean', unit quaternion', scale'): the offsets after the activations,
    the rotation's sum normalized again (a departure, above)."""
    q1 = quats / torch.clamp_min(torch.linalg.norm(quats, dim=-1, keepdim=True), 1e-12)
    q2 = q1 + dr
    q2 = q2 / torch.clamp_min(torch.linalg.norm(q2, dim=-1, keepdim=True), 1e-12)
    return means + dx, q2, torch.exp(log_scales) + ds


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


def exp_lr(init: float, final: float, max_steps: int, iteration: int) -> torch.Tensor:
    progress = torch.clamp_max(torch.tensor(float(iteration), dtype=torch.float32)
                               / float(max_steps), 1.0)
    return init * torch.pow(torch.full_like(progress, final / init), progress)


RenderFn = Callable[..., torch.Tensor]


def reference_step(p: Dict[str, torch.Tensor], net: Dict[str, torch.Tensor],
                   mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor], adam_step: int,
                   alive: torch.Tensor, views: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                                                torch.Tensor, float]],
                   render_fn: RenderFn, cfg: dict) -> dict:
    """One training step from the gaussians ``p`` (the six raw groups), the
    network ``net`` and the Adam moments ``mu``, ``nu`` (keyed by the
    groups' and the network's names) at the shared ``adam_step``. ``views``
    is (viewmat, K, target (H, W, 3) in [0, 1], t) a view; ``render_fn(means,
    unit_quats, scales, masked_logits (N,), sh (N, K, 3), viewmat, K)`` the
    image of deformed gaussians. ``cfg``: lambda_dssim, scale_reg_max_ratio,
    scale_reg_weight, adam_b1, adam_b2, adam_eps, the rates ``lrs`` (a dict
    over the groups and ``deform``), extent, scale_clamp_ratio,
    multires_x, multires_t. Returns the loss, every leaf's gradient, the
    offsets of each view and the new parameters, network and moments."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    wleaves = {k: v.detach().clone().requires_grad_(True) for k, v in net.items()}
    sh = torch.cat([leaves["features_dc"], leaves["features_rest"]], dim=1)
    logits = torch.where(alive[:, None], leaves["logit_opacities"],
                         torch.full_like(leaves["logit_opacities"], -20.0)).reshape(-1)
    total = torch.zeros(())
    offs: List[tuple] = []
    for viewmat, K, gt, t in views:
        dx, dr, ds = deform_mlp(wleaves, leaves["means"], t, cfg["multires_x"],
                                cfg["multires_t"])
        offs.append((dx.detach(), dr.detach(), ds.detach()))
        m2, q2, s2 = deformed(leaves["means"], leaves["quats"], leaves["log_scales"], dx, dr, ds)
        img = render_fn(m2, q2, s2, logits, sh, viewmat, K)
        total = total + photometric(img, gt, cfg["lambda_dssim"])
    reg = scale_reg(leaves["log_scales"], alive, cfg["scale_reg_max_ratio"],
                    cfg["scale_reg_weight"])
    loss = total / len(views) + reg
    names = list(leaves) + list(wleaves)
    tensors = list(leaves.values()) + list(wleaves.values())
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g for k, v, g in zip(names, tensors, grads)}
    b1, b2, eps = cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"]
    step = adam_step + 1
    tt = torch.tensor(float(step), dtype=torch.float32)
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** tt
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** tt
    new_p, new_net, new_mu, new_nu = {}, {}, {}, {}
    with torch.no_grad():
        for k in names:
            g = grads[k]
            m = b1 * mu[k] + (1.0 - b1) * g
            v = b2 * nu[k] + (1.0 - b2) * g * g
            lr = cfg["lrs"][k if k in PARAM_KEYS else "deform"]
            src = p[k] if k in PARAM_KEYS else net[k]
            out = src - lr * (m / c1) / (torch.sqrt(v / c2) + eps)
            (new_p if k in PARAM_KEYS else new_net)[k] = out
            new_mu[k], new_nu[k] = m, v
        ceil = torch.log(torch.tensor(cfg["extent"] * cfg["scale_clamp_ratio"] + 1e-9))
        new_p["log_scales"] = torch.clamp_max(new_p["log_scales"], ceil)
    return {"loss": float(loss.detach()), "grads": grads, "offsets": offs, "params": new_p,
            "net": new_net, "mu": new_mu, "nu": new_nu,
            "grad_norm_means": torch.linalg.norm(grads["means"], dim=-1)}


def init_net(depth: int = 8, width: int = 256, multires_x: int = 10, multires_t: int = 10,
             seed: int = 0) -> Dict[str, torch.Tensor]:
    """A network as ``torch.nn.Linear`` initialises one: weight and bias
    uniform in +-1/sqrt(fan_in), from a CPU generator seeded ``seed``, in
    the published module's order."""
    g = torch.Generator().manual_seed(int(seed))
    in_ch = 3 * (1 + 2 * multires_x) + 1 + 2 * multires_t
    skip = depth // 2
    shapes = []
    for i in range(depth):
        fan_in = in_ch if i == 0 else width + in_ch if i == skip + 1 else width
        shapes += [(f"linear.{i}.weight", (width, fan_in)), (f"linear.{i}.bias", (width,))]
    for name, k in zip(HEAD_NAMES, (3, 4, 3)):
        shapes += [(f"{name}.weight", (k, width)), (f"{name}.bias", (k,))]
    out, fan_in = {}, None
    for name, shape in shapes:
        if name.endswith(".weight"):
            fan_in = shape[1]
        out[name] = (torch.rand(shape, generator=g) * 2.0 - 1.0) / math.sqrt(fan_in)
    return out
