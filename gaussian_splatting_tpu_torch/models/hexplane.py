"""4D Gaussian Splatting (Wu et al., CVPR 2024, arXiv 2310.08528): a
multi-resolution HexPlane feature field over (x, y, z, t) and a small
decoder that map each canonical gaussian and a view's time to offsets of
its mean, log-scales and quaternion.

    x^  = 2 (x - a_min) / (a_max - a_min) - 1, the box set once from the
          initial points; q = (x^, t)
    f_s = prod over the six planes (i, j) of bilerp(P_s^ij, q_i, q_j),
          scales s = 1, 2 (64 s spatial cells, 150 time cells, 16 channels)
    h   = W_0 (f_1, f_2) + b_0                         32 -> 64, no activation
    dx, ds, dr = Linear(relu(Linear(relu(h))))         three heads: 3, 3, 4

The offsets apply before the activations: the renderer takes the mean
x + dx, the log-scales log s + ds and the quaternion q + dr, which it
normalises and exponentiates as for a static scene (Deformable 3D Gaussians,
``models/deform.py``, adds its offsets after them). The means are not
detached: the gradient reaches x through x + dx and through the field's
coordinates. Once a step the field takes three regularizers
(``regularizer``): the mean squared second difference along each plane's
rows (R_j) for the spatial planes (weight 2e-4) and the time planes (1e-3,
along t), and the mean |1 - P| of the time planes (1e-4).

The field is ``ops/hexplane.py::field`` (the kernel pair
``csrc/hexplane.cu`` on the card). Each plane is held channel-last, (R_j,
R_i, 16), the published (1, 16, R_j, R_i) parameter permuted. The decoder
runs float32 GEMMs (TF32 off, PyTorch's default), its three heads' hidden
layers as one (64, 192) GEMM and their outputs as one block-diagonal
(192, 10) GEMM. Tensor names follow the published module (``grids.<s>.<p>``,
``feature_out.0``, ``pos_deform.1`` and ``.3``, ``scales_deform``,
``rotations_deform``). ``HexPlaneState`` holds the tensors, their Adam
moments (the step counter is the gaussians') and the box. Spans:
``deform.field`` (the field's forward a view) and ``deform.field.bwd`` (its
backward, closed at the first plane's gradient), ``deform.mlp`` /
``deform.mlp.bwd`` (the decoder), ``step.deform_reg`` (the regularizers);
counter ``deform.rows`` (the rows through the field a view).

The widths, resolutions, weights and rates are the published dynerf
setting's, constants here as ``models/deform.py`` keeps its network shape.
The plain reference is ``models/hexplane_ref.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gaussian_splatting_tpu_torch._device import DeviceLike, resolve_device
from gaussian_splatting_tpu_torch.ops import hexplane as field_op
from gaussian_splatting_tpu_torch.training.optimizer import exp_lr_decay
from gaussian_splatting_tpu_torch.utils import profiling

CHANNELS = field_op.CHANNELS        # output_coordinate_dim
BASE_RES = 64                       # resolution [64, 64, 64, 150]
TIME_RES = 150
SCALES = (1, 2)                     # multires; time is not upsampled
WIDTH = 64                          # net_width; defor_depth 0
PAIRS = field_op.PAIRS
SPACE_PLANES = (0, 1, 3)            # xy, xz, yz
TIME_PLANES = (2, 4, 5)             # xt, yt, zt
HEADS = (("pos_deform", 3), ("scales_deform", 3), ("rotations_deform", 4))
INIT_RANGE = (0.1, 0.5)             # spatial planes; time planes start at 1
# The regularizers' weights: plane_tv_weight, time_smoothness_weight,
# l1_time_planes.
PLANE_TV_WEIGHT = 2e-4
TIME_SMOOTHNESS_WEIGHT = 1e-3
L1_TIME_PLANES_WEIGHT = 1e-4
# The rates, both times the scene extent (spatial_lr_scale), decaying over
# the fine stage's iterations (the port's iteration less deform_warmup).
GRID_LR = (1.6e-3, 1.6e-4)
DEFORMATION_LR = (1.6e-4, 1.6e-5)
LR_MAX_STEPS = 20_000

HEXPLANE_ON_MESH = (
    "4D Gaussian Splatting on a mesh: the sharded step has no HexPlane field yet (its planes "
    "and decoder replicated on every rank with an all-reduce of their gradients, the offsets "
    "of each rank's ZeRO rows); train with deform_field='hexplane' on one device")
HEXPLANE_SURFELS = (
    "4D Gaussian Splatting with surfels: the field's offsets move 3D gaussians through the "
    "static projection pair; the surfel pair takes none")
HEXPLANE_POSE = (
    "4D Gaussian Splatting with pose refinement: the field's coordinates and the pose "
    "corrections have not been trained together; refine poses on the static scene")


def resolution(scale: int, axis: int) -> int:
    """Cells along ``axis`` (0-2 space, 3 time) at scale ``scale``."""
    return TIME_RES if axis == 3 else BASE_RES * scale


def plane_name(s: int, p: int) -> str:
    return f"grids.{s}.{p}"


def plane_names() -> List[str]:
    return [plane_name(s, p) for s in range(len(SCALES)) for p in range(len(PAIRS))]


def shapes() -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every tensor: the twelve planes (channel-last),
    then the decoder's fourteen."""
    out = []
    for s, scale in enumerate(SCALES):
        for p, (i, j) in enumerate(PAIRS):
            out.append((plane_name(s, p),
                        (resolution(scale, j), resolution(scale, i), CHANNELS)))
    feat = CHANNELS * len(SCALES)
    out += [("feature_out.0.weight", (WIDTH, feat)), ("feature_out.0.bias", (WIDTH,))]
    for name, k in HEADS:
        out += [(f"{name}.1.weight", (WIDTH, WIDTH)), (f"{name}.1.bias", (WIDTH,)),
                (f"{name}.3.weight", (k, WIDTH)), (f"{name}.3.bias", (k,))]
    return out


def decoder_macs_per_row() -> int:
    """Multiply-adds of one row through the decoder: 14,976."""
    return sum(s[0] * s[1] for n, s in shapes() if n.endswith(".weight"))


def init_params(seed: int = 0, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The published initialisation, drawn on the host from a generator
    seeded ``seed`` in ``shapes()`` order: spatial planes uniform in
    INIT_RANGE, time planes ones; each linear's weight Xavier-uniform (the
    module's initialize_weights) and its bias as ``torch.nn.Linear``
    draws it (uniform in +-1/sqrt(fan_in))."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    out = {}
    lo, hi = INIT_RANGE
    for name, shape in shapes():
        if name.startswith("grids."):
            p = int(name.rsplit(".", 1)[1])
            out[name] = (torch.ones(shape) if 3 in PAIRS[p]
                         else lo + (hi - lo) * torch.rand(shape, generator=g))
        elif name.endswith(".weight"):
            bound = math.sqrt(6.0 / (shape[0] + shape[1]))
            out[name] = (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound
            fan_in = shape[1]
        else:
            out[name] = (torch.rand(shape, generator=g) * 2.0 - 1.0) / math.sqrt(fan_in)
    return {k: v.to(dev) for k, v in out.items()}


def normalise(x: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """x^ = (x - a_min) (2 / (a_max - a_min)) - 1 of ``box`` (2, 3) = (a_min,
    a_max)."""
    return (x - box[0]) * (2.0 / (box[1] - box[0])) - 1.0


def decoder(params: Dict[str, torch.Tensor], feat: torch.Tensor):
    """(dx (R, 3), ds (R, 3), dr (R, 4)) of the field's features (R, 32)."""
    h = F.linear(feat, params["feature_out.0.weight"], params["feature_out.0.bias"])
    w1 = torch.cat([params[f"{n}.1.weight"] for n, _ in HEADS])
    b1 = torch.cat([params[f"{n}.1.bias"] for n, _ in HEADS])
    # In place: each linear's backward reads its input, not its output.
    z = F.relu(F.linear(F.relu(h, inplace=True), w1, b1), inplace=True)
    w2 = torch.block_diag(*(params[f"{n}.3.weight"] for n, _ in HEADS))
    b2 = torch.cat([params[f"{n}.3.bias"] for n, _ in HEADS])
    out = F.linear(z, w2, b2)
    return out[:, :3], out[:, 3:6], out[:, 6:]


def offsets(params: Dict[str, torch.Tensor], box: torch.Tensor, means: torch.Tensor,
            rows: Optional[torch.Tensor], t):
    """The (N, 3), (N, 4), (N, 3) offsets (dx, dr, ds) of a buffer of N
    slots at time ``t``, to add before the activations: the field and the
    decoder over the slots ``rows`` (all where None) of ``means``, zero
    elsewhere. Differentiable in ``params`` and ``means``. Spans
    ``deform.field`` (+ ``.bwd``) and ``deform.mlp`` (+ ``.bwd``); counts
    ``deform.rows``."""
    n = means.shape[0]
    x = means if rows is None else means.index_select(0, rows)
    profiling.count("deform.rows", x.shape[0])
    planes = [params[k] for k in plane_names()]
    with profiling.annotate("deform.field"):
        mark = profiling.grad_span("deform.field.bwd")
        planes[0] = mark.input(planes[0])
        feat = mark.outputs(field_op.field(planes, normalise(x, box).contiguous(), t))
    with profiling.annotate("deform.mlp"):
        mark = profiling.grad_span("deform.mlp.bwd")
        dx, ds, dr = mark.outputs(*decoder(params, mark.input(feat)))
    if rows is None:
        return dx, dr, ds
    out = torch.cat([dx, dr, ds], dim=1)
    out = out.new_zeros((n, 10)).index_copy(0, rows, out)
    return out[:, :3], out[:, 3:7], out[:, 7:]


def deformed(means: torch.Tensor, quats: torch.Tensor, log_scales: torch.Tensor, offs):
    """The raw (means, quats, log_scales) the renderer takes for the
    deformed gaussians: x + dx, q + dr, log s + ds (before the
    activations)."""
    dx, dr, ds = offs
    return means + dx, quats + dr, log_scales + ds


def _smoothness(plane: torch.Tensor) -> torch.Tensor:
    """compute_plane_smoothness: the mean squared second difference along
    the plane's rows (R_j, dim 0 of the channel-last plane)."""
    first = plane[1:] - plane[:-1]
    return torch.square(first[1:] - first[:-1]).mean()


def regularizer(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The field's three regularizers at the published weights, summed over
    the scales in the published order."""
    tv = ts = l1 = 0.0
    for s in range(len(SCALES)):
        for p in SPACE_PLANES:
            tv = tv + _smoothness(params[plane_name(s, p)])
    for s in range(len(SCALES)):
        for p in TIME_PLANES:
            ts = ts + _smoothness(params[plane_name(s, p)])
    for s in range(len(SCALES)):
        for p in TIME_PLANES:
            l1 = l1 + torch.abs(1.0 - params[plane_name(s, p)]).mean()
    return PLANE_TV_WEIGHT * tv + TIME_SMOOTHNESS_WEIGHT * ts + L1_TIME_PLANES_WEIGHT * l1


@dataclasses.dataclass
class HexPlaneState:
    """The field's planes and decoder, their Adam moments (the step counter
    is the gaussians'), and the box (2, 3) = (a_min, a_max)."""

    params: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    box: torch.Tensor


def box_of(points: torch.Tensor) -> torch.Tensor:
    """The (2, 3) box (a_min, a_max) of the initial points (N, 3)."""
    pts = torch.as_tensor(points, dtype=torch.float32)
    return torch.stack([pts.min(0).values, pts.max(0).values])


def hexplane_state_init(box: torch.Tensor, seed: int = 0, device: DeviceLike = None
                        ) -> HexPlaneState:
    dev = resolve_device(device)
    params = init_params(seed, dev)
    return HexPlaneState(params=params, mu={k: torch.zeros_like(v) for k, v in params.items()},
                         nu={k: torch.zeros_like(v) for k, v in params.items()},
                         box=torch.as_tensor(box, dtype=torch.float32, device=dev).reshape(2, 3))


def lr_schedule(config, iteration: torch.Tensor, extent: float) -> Dict[str, torch.Tensor]:
    """The rate of every tensor by name: the planes' GRID_LR
    and the decoder's DEFORMATION_LR, each times ``extent`` and decaying
    exponentially over LR_MAX_STEPS of the fine stage (the iteration less
    ``config.deform_warmup``)."""
    fine = torch.clamp_min(iteration - int(config.deform_warmup), 0)
    glr = exp_lr_decay(fine, GRID_LR[0] * extent, GRID_LR[1] * extent, LR_MAX_STEPS)
    dlr = exp_lr_decay(fine, DEFORMATION_LR[0] * extent, DEFORMATION_LR[1] * extent,
                       LR_MAX_STEPS)
    return {n: glr if n.startswith("grids.") else dlr for n, _ in shapes()}


def to_numpy(state: HexPlaneState) -> Dict[str, np.ndarray]:
    """The checkpoint's arrays: ``hexplane/params/<name>``,
    ``hexplane/adam_mu/<name>``, ``hexplane/adam_nu/<name>`` and
    ``hexplane/box``."""
    out = {"hexplane/box": state.box.detach().cpu().numpy()}
    for k in state.params:
        out[f"hexplane/params/{k}"] = state.params[k].detach().cpu().numpy()
        out[f"hexplane/adam_mu/{k}"] = state.mu[k].detach().cpu().numpy()
        out[f"hexplane/adam_nu/{k}"] = state.nu[k].detach().cpu().numpy()
    return out


def from_numpy(arrays: Dict[str, np.ndarray], device: DeviceLike = None
               ) -> Optional[HexPlaneState]:
    """The ``HexPlaneState`` in a checkpoint's arrays, or None without one."""
    if "hexplane/box" not in arrays:
        return None
    dev = resolve_device(device)

    def tab(prefix):
        return {n: torch.as_tensor(np.asarray(arrays[prefix + n], np.float32), device=dev)
                for n, _ in shapes()}

    return HexPlaneState(params=tab("hexplane/params/"), mu=tab("hexplane/adam_mu/"),
                         nu=tab("hexplane/adam_nu/"),
                         box=torch.as_tensor(np.asarray(arrays["hexplane/box"], np.float32),
                                             device=dev))
