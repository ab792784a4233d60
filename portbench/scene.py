"""Seeded scenes, cameras and training checkpoints, made on the device.

A scene is a "true" population of gaussians on surfaces: ellipsoid shells
near the origin (the objects), a ground disc and a background dome around
the cameras, as a 360-degree capture holds them. The configuration fixes
the surfaces and the cameras; the seed draws the points, their attributes
and the noise, so every seed asks the same work in another arrangement. Scales are set as the 3DGS
initialisation sets them: the root mean square distance of each mean to its
three nearest neighbours (approximated, as the original ``simple-knn`` does,
among the neighbours in Morton order). Everything comes from one seed
through ``torch.Generator``s on the device, in a few large calls.
"""

from __future__ import annotations

import io
import json
import math
from typing import Dict, Tuple

import numpy as np
import torch

from portbench.reference import render as R

PARAM_KEYS = ("means", "quats", "log_scales", "logit_opacities", "features_dc",
              "features_rest")
SH_C0 = 0.28209479177387814


def generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for stream ``stream`` of ``seed`` (any
    non-negative integer, also above 2**32)."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def numpy_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), int(seed) >> 63, stream])


def _unit(x):
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-12)


def surface_points(n: int, layout: dict, g: torch.Generator, device) -> torch.Tensor:
    """(n, 3) means on the layout's surfaces, in the layout's proportions:
    the objects' shells (centres and semi-axes fixed by the layout, each
    shell's share by its area), the ground disc and the dome. The seed
    places the points, not the surfaces, so every seed asks the same work."""
    n_obj = int(n * layout["object_share"])
    n_ground = int(n * layout["ground_share"])
    n_dome = n - n_obj - n_ground
    centres = torch.tensor(layout["object_centres"], device=device)
    axes = torch.tensor(layout["object_axes"], device=device)
    a, b, c = axes.unbind(-1)
    area = (((a * b) ** 1.6 + (a * c) ** 1.6 + (b * c) ** 1.6) / 3) ** (1 / 1.6)
    which = torch.multinomial(area / area.sum(), n_obj, replacement=True, generator=g)
    d = _unit(torch.randn((n_obj, 3), generator=g, device=device))
    obj = centres[which] + d * axes[which]
    u = torch.rand((n_ground, 2), generator=g, device=device)
    rad = layout["ground_radius"] * torch.sqrt(u[:, 0])
    th = 2 * math.pi * u[:, 1]
    ground = torch.stack([rad * torch.cos(th), torch.full_like(rad, layout["ground_y"]),
                          rad * torch.sin(th)], -1)
    dome = _unit(torch.randn((n_dome, 3), generator=g, device=device)) * layout["dome_radius"]
    return torch.cat([obj, ground, dome])


def _morton(p: torch.Tensor) -> torch.Tensor:
    lo = p.amin(0)
    span = torch.clamp_min((p.amax(0) - lo).amax(), 1e-12)
    q = ((p - lo) / span * 1023).clamp(0, 1023).to(torch.int64)
    code = torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return code


def knn3_rms(p: torch.Tensor, window: int = 16, batch: int = 1 << 20) -> torch.Tensor:
    """sqrt(mean squared distance to the 3 nearest neighbours) of each
    point, the neighbours searched among the ``window`` points before and
    after it in Morton order."""
    order = torch.argsort(_morton(p))
    ps = p[order]
    n = ps.shape[0]
    out = torch.empty(n, dtype=p.dtype, device=p.device)
    offs = torch.cat([torch.arange(-window, 0), torch.arange(1, window + 1)]).to(p.device)
    for i in range(0, n, batch):
        idx = torch.arange(i, min(i + batch, n), device=p.device)
        nb = (idx[:, None] + offs[None, :]).clamp(0, n - 1)
        d2 = ((ps[nb] - ps[idx][:, None, :]) ** 2).sum(-1)
        d2 = torch.where(nb == idx[:, None], torch.full_like(d2, float("inf")), d2)
        out[idx] = torch.sqrt(torch.clamp_min(d2.topk(3, largest=False).values.mean(-1), 1e-14))
    res = torch.empty_like(out)
    res[order] = out
    return res


def true_scene(n: int, layout: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded true scene: (n, ...) float32 parameters on ``device``."""
    g = generator(device, seed, 1)
    means = surface_points(n, layout, g, device)
    scale = knn3_rms(means)
    freq = 1.0 + 2.0 * torch.rand((3, 3), generator=g, device=device)
    phase = 2 * math.pi * torch.rand((3,), generator=g, device=device)
    rgb = 0.5 + 0.35 * torch.sin(means @ freq + phase)
    rgb = rgb + 0.08 * torch.randn((n, 3), generator=g, device=device)
    op_mu, op_sd = layout["logit_opacity"]
    return {
        "means": means,
        "quats": torch.randn((n, 4), generator=g, device=device),
        "log_scales": torch.log(scale)[:, None].repeat(1, 3),
        "logit_opacities": op_mu + op_sd * torch.randn((n, 1), generator=g, device=device),
        "features_dc": ((rgb - 0.5) / SH_C0)[:, None, :],
        "features_rest": layout["sh_rest_sd"] * torch.randn((n, 15, 3), generator=g,
                                                            device=device),
    }


def noisy(scene: Dict[str, torch.Tensor], noise: dict, seed: int) -> Dict[str, torch.Tensor]:
    """The trainer's state: the true scene with seeded noise on the means
    (relative to each scale), the log scales, the DC colour and the opacity
    logits."""
    dev = scene["means"].device
    g = generator(dev, seed, 2)
    out = dict(scene)
    s = torch.exp(scene["log_scales"][:, :1])
    out["means"] = scene["means"] + noise["means_rel"] * s * torch.randn(
        scene["means"].shape, generator=g, device=dev)
    for k in ("log_scales", "features_dc", "logit_opacities"):
        out[k] = scene[k] + noise[k] * torch.randn(scene[k].shape, generator=g, device=dev)
    return out


def scene_extent(means: torch.Tensor, viewmats: torch.Tensor, sample: int = 200_000) -> float:
    """min(2 x median radius from the median centre, 2 x median camera
    depth) over a fixed subsample of the means: the trainer's extent rule."""
    step = max(1, means.shape[0] // sample)
    p = means[::step].double()
    centre = p.median(0).values
    med_r = float(torch.linalg.norm(p - centre, dim=-1).median())
    depths = []
    for vm in viewmats.double().to(p.device):
        z = p @ vm[2, :3] + vm[2, 3]
        z = z[z > 0]
        if z.numel():
            depths.append(float(z.median()))
    return float(min(2.0 * med_r, 2.0 * float(np.median(depths)) if depths else float("inf")))


def orbit_views(n: int, cams: dict) -> torch.Tensor:
    """(n, 4, 4) world-to-camera matrices on the host: evenly spread angles
    on the orbit, heights in a fixed low-discrepancy pattern within the
    height jitter, all looking at the origin."""
    out = []
    for i in range(n):
        a = 2 * math.pi * i / n
        h = cams["height"] + cams["height_jitter"] * (2 * ((i * 0.6180339887) % 1.0) - 1)
        eye = (cams["radius"] * math.sin(a), h, -cams["radius"] * math.cos(a))
        out.append(R.look_at(eye, (0.0, 0.0, 0.0)))
    return torch.stack(out)


def _look_at_np(eye: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    """(n, 4, 4) world-to-camera matrices from (n, 3) eyes to (n, 3)
    targets, world +y up: +z forward, +y down in the camera."""
    fwd = tgt - eye
    fwd /= np.linalg.norm(fwd, axis=-1, keepdims=True)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    down = np.cross(fwd, right)
    Rm = np.stack([right, down, fwd], axis=1)
    out = np.zeros((eye.shape[0], 4, 4))
    out[:, :3, :3] = Rm
    out[:, :3, 3] = -np.einsum("nij,nj->ni", Rm, eye)
    out[:, 3, 3] = 1.0
    return out


def path_views(n: int, cams: dict) -> np.ndarray:
    """(n, 4, 4) float32 numpy world-to-camera matrices of a viewer's
    continuous path: the orbit walked at a fixed angular step from a fixed
    starting angle, with a slow sway of height and target."""
    t = np.arange(n, dtype=np.float64)
    a = cams["path_start"] + cams["path_step"] * t
    h = cams["height"] + cams["height_jitter"] * np.sin(0.013 * t)
    eye = np.stack([cams["radius"] * np.sin(a), h, -cams["radius"] * np.cos(a)], -1)
    tgt = np.stack([cams["target_jitter"] * np.sin(0.007 * t), np.zeros(n),
                    cams["target_jitter"] * np.cos(0.011 * t)], -1)
    return _look_at_np(eye, tgt).astype(np.float32)


def targets(scene: Dict[str, torch.Tensor], viewmats, K, width: int, height: int,
            sh_degree: int) -> np.ndarray:
    """(V, H, W, 3) uint8 images of the true scene, rendered by the
    reference (tile cap 16, no class budgets)."""
    dev = scene["means"].device
    sh = torch.cat([scene["features_dc"], scene["features_rest"]], dim=1)
    out = np.empty((len(viewmats), height, width, 3), np.uint8)
    for i, vm in enumerate(viewmats):
        img, _, _ = R.render(scene["means"], scene["quats"], scene["log_scales"],
                             scene["logit_opacities"], sh, vm.to(dev), K.to(dev), width,
                             height, sh_degree)
        out[i] = torch.floor(torch.clamp(img, 0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy()
    return out


def checkpoint(state: Dict[str, torch.Tensor], capacity: int, iteration: int, extent: float,
               opt: dict, seed: int) -> Tuple[io.BytesIO, Dict[str, np.ndarray]]:
    """A training checkpoint of ``state`` (n alive gaussians in a buffer of
    ``capacity``) at ``iteration``, in the trainer's ``.npz`` layout, held in
    memory, and the host arrays the reference starts from. Adam: mu 0, nu
    the square of each group's assumed gradient RMS, step = iteration. The
    densify accumulators hold ``opt['accum_iters']`` iterations of seeded
    gradient norms (lognormal around a share of the threshold)."""
    dev = state["means"].device
    n = state["means"].shape[0]
    g = generator(dev, seed, 5)
    arrays: Dict[str, np.ndarray] = {}
    init: Dict[str, np.ndarray] = {}
    for k in PARAM_KEYS:
        v = state[k]
        full = torch.zeros((capacity,) + tuple(v.shape[1:]), dtype=torch.float32, device=dev)
        if k == "quats":
            full[:, 0] = 1.0
        if k == "log_scales":
            full[:] = -3.0
        full[:n] = v
        host = full.cpu().numpy()
        nu = np.full(host.shape, float(opt["nu_rms"][k]) ** 2, np.float32)
        arrays[f"params/{k}"] = host
        arrays[f"adam_mu/{k}"] = np.zeros_like(host)
        arrays[f"adam_nu/{k}"] = nu
        init[k] = host
        init["nu/" + k] = nu
    alive = np.zeros(capacity, bool)
    alive[:n] = True
    it = int(opt["accum_iters"])
    med = float(opt["accum_median"]) * float(opt["densify_grads_threshold"])
    a = med * torch.exp(float(opt["accum_sigma"]) * torch.randn((n,), generator=g, device=dev))
    accum = torch.zeros((capacity, 3), device=dev)
    accum[:n] = (it * a / math.sqrt(3.0))[:, None]
    arrays.update(alive=alive, xyz_grad_accum=accum.cpu().numpy(),
                  xyz_grad_count=np.where(alive, float(it), 0.0).astype(np.float32)[:, None],
                  max_radii2d=np.zeros(capacity, np.int32),
                  adam_step=np.int32(iteration), iteration=np.int32(iteration))
    arrays["meta_json"] = np.frombuffer(json.dumps({"scene_extent": extent}).encode(), np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    buf.seek(0)
    init["alive"] = alive
    return buf, init

