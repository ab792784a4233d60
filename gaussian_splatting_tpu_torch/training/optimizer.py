"""Adam with per-parameter-group learning rates and spliceable moments
(counterpart of ``gaussian_splatting_tpu/training/optimizer.py``).

Plain tensor code rather than ``torch.optim.Adam``: densification splices
moment rows of reused slots, and ``torch.optim.Adam`` keeps a step counter
per parameter where this optimizer keeps one shared counter (the groups
step in lockstep, so it is equivalent, including fresh rows inheriting the
global bias correction). The update is
``p - lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``, eps 1e-15,
written once in plain PyTorch, in ``adam_step``, and once for the card, in
``csrc/adam.cu``: ``adam_multi`` updates a list of tensors (the six groups,
the pose deltas, the deformation network's tensors) in one launch of that
kernel on CUDA tensors, bit for bit ``adam_step``'s result, and through
``adam_step`` on CPU tensors. The test-time pose alignment, whose bias
corrections are Python numbers, calls ``adam_step`` itself.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from gaussian_splatting_tpu_torch.models.gaussians import PARAM_KEYS, GaussianParams
from gaussian_splatting_tpu_torch.ops import _build
from gaussian_splatting_tpu_torch.utils import profiling

# csrc/adam.cu's kChunk (the elements a block updates; the kernel refuses a
# launch planned with another) and kMaxSegments (the tensors a launch takes).
ADAM_CHUNK = 4096
ADAM_MAX_SEGMENTS = 32


@dataclasses.dataclass
class AdamState:
    mu: GaussianParams
    nu: GaussianParams
    step: torch.Tensor  # () int32


def adam_init(params: GaussianParams) -> AdamState:
    def zeros():
        return GaussianParams(**{k: torch.zeros_like(getattr(params, k))
                                 for k in PARAM_KEYS})

    return AdamState(mu=zeros(), nu=zeros(),
                     step=torch.zeros((), dtype=torch.int32, device=params.means.device))


def group_lrs(config, xyz_lr) -> GaussianParams:
    """Per-group learning rates, GaussianParams-shaped; ``xyz_lr`` follows
    the exponential decay schedule."""
    return GaussianParams(
        means=xyz_lr,
        quats=config.lr_rotation,
        log_scales=config.lr_scaling,
        logit_opacities=config.lr_opacity,
        features_dc=config.lr_features_dc,
        features_rest=config.lr_features_rest,
    )


def adam_bias_corrections(step: torch.Tensor, b1: float, b2: float):
    """(1 - b1^t, 1 - b2^t) in float32 for the step counter t."""
    t = step.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=step.device)
    return 1.0 - (one * b1) ** t, 1.0 - (one * b2) ** t


def adam_step(param: torch.Tensor, grad: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
              lr, c1, c2, b1: float, b2: float, eps: float) -> None:
    """One Adam update of ``param`` and its moments ``mu``, ``nu``, in place,
    at rate ``lr`` with the bias corrections ``c1``, ``c2``
    (``adam_bias_corrections`` of the shared step counter)."""
    mu.mul_(b1).add_((1.0 - b1) * grad)
    nu.mul_(b2).add_((1.0 - b2) * grad * grad)
    param.sub_(lr * (mu / c1) / (torch.sqrt(nu / c2) + eps))


class _Segment(ctypes.Structure):
    """One tensor of a launch, laid out as ``csrc/adam.cu``'s ``Segment``."""

    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p), ("m", ctypes.c_void_p),
                ("v", ctypes.c_void_p), ("lr_ptr", ctypes.c_void_p), ("n", ctypes.c_int64),
                ("first_block", ctypes.c_int64), ("lr", ctypes.c_float), ("vec", ctypes.c_int)]


def plan_adam_launches(numels: Sequence[int]) -> List[Tuple[List[int], List[int], int]]:
    """The launches of ``csrc/adam.cu`` over tensors of ``numels`` elements,
    in order: ``(tensors, first blocks, blocks)`` with the indices of the
    launch's tensors (empty ones left out, at most ``ADAM_MAX_SEGMENTS``),
    the block each starts at, and the blocks of ``ADAM_CHUNK`` elements the
    launch takes."""
    out, idx, first, blocks = [], [], [], 0
    for i, n in enumerate(numels):
        if n == 0:
            continue
        if len(idx) == ADAM_MAX_SEGMENTS:
            out.append((idx, first, blocks))
            idx, first, blocks = [], [], 0
        idx.append(i)
        first.append(blocks)
        blocks += -(-n // ADAM_CHUNK)
    if idx:
        out.append((idx, first, blocks))
    return out


def _check_adam_args(params, grads, mus, nus, lrs, c1, c2) -> Optional[torch.device]:
    """The device of ``adam_multi``'s tensors (None for no tensor); raises
    ``ValueError`` on anything neither route takes."""
    n = len(params)
    if not len(grads) == len(mus) == len(nus) == len(lrs) == n:
        raise ValueError(f"adam_multi takes as many grads, mus, nus and lrs as params, got "
                         f"{n}, {len(grads)}, {len(mus)}, {len(nus)}, {len(lrs)}")
    if n == 0:
        return None
    dev = params[0].device if isinstance(params[0], torch.Tensor) else None
    for i, row in enumerate(zip(params, grads, mus, nus)):
        for name, x in zip(("param", "grad", "mu", "nu"), row):
            if not isinstance(x, torch.Tensor):
                raise ValueError(f"adam_multi: {name} {i} is missing")
            if x.dtype != torch.float32:
                raise ValueError(f"adam_multi: {name} {i} is {x.dtype}, not float32")
            if x.shape != row[0].shape:
                raise ValueError(f"adam_multi: {name} {i} has shape {tuple(x.shape)}, its "
                                 f"param {tuple(row[0].shape)}")
            if x.device != dev:
                raise ValueError(f"adam_multi: {name} {i} is on {x.device}, not {dev}")
        if row[0].numel() and len({x.data_ptr() for x in row}) < 4:
            raise ValueError(f"adam_multi: the param, grad and moments of {i} share memory")
        lr = lrs[i]
        if isinstance(lr, torch.Tensor):
            if lr.dim() != 0 or lr.dtype != torch.float32 or lr.device != dev:
                raise ValueError(f"adam_multi: rate {i} must be a number or a 0-dim float32 "
                                 f"tensor on {dev}")
        elif not isinstance(lr, (int, float)) or isinstance(lr, bool):
            raise ValueError(f"adam_multi: rate {i} is a {type(lr).__name__}")
    for name, c in (("c1", c1), ("c2", c2)):
        if (not isinstance(c, torch.Tensor) or c.dim() != 0 or c.dtype != torch.float32
                or c.device != dev):
            raise ValueError(f"adam_multi: {name} must be a 0-dim float32 tensor on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"adam_multi runs on CUDA or CPU tensors, not {dev}")
    return dev


def _check_kernel_layout(params, grads, mus, nus) -> None:
    """Raises ``ValueError`` unless every tensor is contiguous, as the
    kernel reads them (the plain route takes any strides)."""
    for i, row in enumerate(zip(params, grads, mus, nus)):
        for name, x in zip(("param", "grad", "mu", "nu"), row):
            if not x.is_contiguous():
                raise ValueError(f"adam_multi: {name} {i} is not contiguous")


def _adam_cuda(params, grads, mus, nus, lrs, c1, c2, b1, b2, eps) -> None:
    """``adam_multi`` on the card: ``csrc/adam.cu``, one launch for up to
    ``ADAM_MAX_SEGMENTS`` tensors."""
    fn = _build.load("adam").gs_adam
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
                   ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    numels = [p.numel() for p in params]
    with torch.cuda.device(params[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for idx, first, blocks in plan_adam_launches(numels):
            segs = (_Segment * len(idx))()
            for j, (i, f) in enumerate(zip(idx, first)):
                ptrs = [x.data_ptr() for x in (params[i], grads[i], mus[i], nus[i])]
                lr = lrs[i]
                on_device = isinstance(lr, torch.Tensor)
                segs[j] = _Segment(*ptrs, lr.data_ptr() if on_device else None, numels[i], f,
                                   0.0 if on_device else float(lr),
                                   int(all(q % 16 == 0 for q in ptrs)))
            rc = fn(segs, len(idx), blocks, ADAM_CHUNK, c1.data_ptr(), c2.data_ptr(),
                    float(b1), float(b2), float(eps), stream)
            if rc != 0:
                raise RuntimeError(f"adam kernel launch failed: cudaError {rc}")
            profiling.count("launch.adam")


def adam_multi(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor], lrs: Sequence,
               c1: torch.Tensor, c2: torch.Tensor, b1: float, b2: float, eps: float) -> None:
    """``adam_step`` of every ``(params[i], grads[i], mus[i], nus[i])`` at
    rate ``lrs[i]`` (a number, or a 0-dim float32 tensor on the tensors'
    device), in place, with the bias corrections ``c1``, ``c2`` (0-dim
    float32 tensors there). Every tensor is float32, of its param's shape,
    on one device, and the four of a row are distinct; anything else raises
    ``ValueError``. CUDA tensors take one launch of ``csrc/adam.cu``
    (counter ``launch.adam``), bit for bit ``adam_step``'s result on the
    card, and must be contiguous; CPU tensors take ``adam_step`` one by
    one."""
    dev = _check_adam_args(params, grads, mus, nus, lrs, c1, c2)
    if dev is None:
        return
    if dev.type == "cuda":
        _check_kernel_layout(params, grads, mus, nus)
        _adam_cuda(params, grads, mus, nus, lrs, c1, c2, b1, b2, eps)
        return
    for p, g, m, v, lr in zip(params, grads, mus, nus, lrs):
        adam_step(p, g, m, v, lr, c1, c2, b1, b2, eps)


@torch.no_grad()
def adam_update(grads: GaussianParams, state: AdamState, params: GaussianParams,
                lrs: GaussianParams, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-15):
    """One Adam step of every group, in place and in one ``adam_multi``:
    ``params``, ``state.mu``, ``state.nu`` and ``state.step`` are updated
    where they lie (no copies of the 1M-row tensors) and returned as
    ``(params, state)``."""
    state.step += 1
    c1, c2 = adam_bias_corrections(state.step, b1, b2)
    lists = [[getattr(g, k) for k in PARAM_KEYS] for g in (params, grads, state.mu, state.nu, lrs)]
    adam_multi(*lists, c1, c2, b1, b2, eps)
    return params, state


def exp_lr_decay(iteration: torch.Tensor, init: float, final: float,
                 max_steps: int) -> torch.Tensor:
    """The rate at ``iteration`` of an exponential decay from ``init`` to
    ``final`` over ``max_steps``, held at ``final`` after."""
    progress = torch.clamp_max(iteration.to(torch.float32) / float(max_steps), 1.0)
    return init * torch.pow(torch.full_like(progress, final / init), progress)


def xyz_lr_schedule(config, iteration: torch.Tensor) -> torch.Tensor:
    """Exponential decay from position_lr_init to position_lr_final over
    position_lr_max_steps."""
    return exp_lr_decay(iteration, config.position_lr_init, config.position_lr_final,
                        config.position_lr_max_steps)
