"""Rasterizer facade: backend selection and render caching (counterpart of
``gaussian_splatting_tpu/ops/facade.py``).

Backend ``"auto"`` resolves to ``"cuda"`` (binning + the hand-written
kernels); ``"ref"`` is the PyTorch oracle. The render cache returns an
earlier result when the view matrix is within ``cache_view_eps`` (Frobenius
norm) of a cached one at the same time; it holds the last 32 views. The
facade serves interactive and evaluation use, so it renders without
autograd. A deforming scene (Deformable 3D Gaussians, ``models/deform.py``)
renders at a time ``t``: the deformation network (``deform``, a
``DeformState``) runs its forward over every row of the parameters given.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from gaussian_splatting_tpu_torch._device import DeviceLike, resolve_device
from gaussian_splatting_tpu_torch.ops.render import (
    RenderOut,
    compose_render_mode,
    render,
    resolve_backend,
)
from gaussian_splatting_tpu_torch.utils import profiling

_CACHE_SIZE = 32


class GaussianRasterizer:
    def __init__(
        self,
        width: int,
        height: int,
        tile_size: int = 16,
        backend: str = "auto",
        enable_caching: bool = False,
        cache_view_eps: float = 0.01,
        sh_degree: int = 3,
        device: DeviceLike = None,
        deform=None,
    ):
        self.device = resolve_device(device)
        self.deform = deform
        self.backend = resolve_backend(backend)
        self.width = width
        self.height = height
        self.tile_size = tile_size
        self.sh_degree = sh_degree
        self.enable_caching = enable_caching
        self.cache_view_eps = cache_view_eps
        self._cache: List = []  # [(viewmat np, t, RenderOut)]
        self.cache_hits = 0
        self.cache_misses = 0

    def _cache_lookup(self, viewmat: np.ndarray, t) -> Optional[RenderOut]:
        for vm, tc, out in self._cache:
            if tc == t and np.linalg.norm(vm - viewmat) < self.cache_view_eps:
                self.cache_hits += 1
                return out
        self.cache_misses += 1
        return None

    def render_single(self, params, viewpoint: Dict, bg=None,
                      t: Optional[float] = None) -> RenderOut:
        """params: a GaussianParams, or a dict with means3D / scales (raw
        log) / rotations / opacities (raw logit) / shs; viewpoint: a dict
        with world_view_transform (4, 4) and K (3, 3). With a time ``t`` the
        gaussians deform by the rasterizer's ``deform`` network at t."""
        with profiling.annotate("render.frame"):
            return self._render_single(params, viewpoint, bg, t)

    def _render_single(self, params, viewpoint: Dict, bg, t) -> RenderOut:
        deform = self.deform
        vm = viewpoint["world_view_transform"]
        viewmat = (vm.detach().cpu().numpy() if torch.is_tensor(vm)
                   else np.asarray(vm)).astype(np.float32)
        if t is not None and deform is None:
            raise ValueError("render_single: a time t needs the rasterizer's deformation "
                             "network (GaussianRasterizer(deform=...))")
        t = None if t is None else float(t)
        if self.enable_caching:
            hit = self._cache_lookup(viewmat, t)
            if hit is not None:
                return hit
        means, quats, log_scales, logit_op, sh = _unpack_params(params)
        if bg is None:
            bg = torch.zeros((3,), dtype=torch.float32)
        with torch.no_grad():
            offsets = None
            if t is not None:
                from gaussian_splatting_tpu_torch.models.deform import offsets as deform_offsets

                offsets = deform_offsets(deform.params, deform.spec,
                                         torch.as_tensor(means, dtype=torch.float32,
                                                         device=self.device), None, t)
            out = render(means, quats, log_scales, logit_op, sh, viewmat,
                         viewpoint["K"], self.width, self.height,
                         sh_degree=self.sh_degree, bg=bg, backend=self.backend,
                         tile_size=self.tile_size, offsets=offsets, device=self.device)
        if self.enable_caching:
            self._cache.append((viewmat, t, out))
            if len(self._cache) > _CACHE_SIZE:
                self._cache.pop(0)
        return out

    def render_batch(self, params, viewpoints: List[Dict], bg=None) -> List[RenderOut]:
        """Render each viewpoint in turn."""
        return [self.render_single(params, vp, bg=bg) for vp in viewpoints]

    def render_with_depth(self, params, viewpoint: Dict, bg=None,
                          render_mode: str = "RGB+ED") -> Dict:
        out = self.render_single(params, viewpoint, bg=bg)
        return {
            "render": compose_render_mode(render_mode, out.render, out.alpha, out.depth),
            "alpha": out.alpha,
            "depth": out.depth,
            "means2d": out.means2d,
            "radii": out.radii,
            "visibility_filter": out.visibility,
        }

    def cache_stats(self) -> Dict[str, int]:
        return {"hits": self.cache_hits, "misses": self.cache_misses}


def _unpack_params(params):
    from gaussian_splatting_tpu_torch.models.gaussians import GaussianParams

    if isinstance(params, GaussianParams):
        return (params.means, params.quats, params.log_scales,
                params.logit_opacities, params.sh_coeffs)

    def get(*names):
        for nm in names:
            if nm in params:
                return params[nm]
        raise KeyError(f"params need one of {names}")

    return (get("means3D", "means"), get("rotations", "quats"),
            get("scales", "log_scales"), get("opacities", "logit_opacities"),
            get("shs", "sh_coeffs"))
