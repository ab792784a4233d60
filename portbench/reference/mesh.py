"""The plain reference of a training step on a mesh whose model axis splits
the image into bands of tile rows (``parallel/sharded_step.py``), in plain
PyTorch. It imports nothing of the program; it extends
``reference/train.py`` by import.

On such a mesh each band is binned and blended on its own against every
gaussian: the screen-space means shifted up by the band's first row, an
image of the band's height, the tile cap and the class budgets applied
within the band (a footprint cut by the band's edge falls into a smaller
class, and a gaussian capped at ``max_t`` tiles keeps up to ``max_t`` in
each band). So where a budget or the cap binds, the mesh's image is not the
single image's. This reference renders the bands so, stitches them, takes
the loss of the stitched image (the program's SSIM across band edges,
through its halo rows, is the whole image's) and backpropagates band by
band. The class budgets are worked out again from the bands' footprints, as
the trainer measures them on such a mesh; the tile cap from the whole
image's.
"""

from __future__ import annotations

import functools
import importlib.util
from typing import List

import numpy as np
import torch

from portbench.reference import render as R
from portbench.reference import train as RT


def band_height(height: int, ts: int, bands: int) -> int:
    """Rows of each band: whole tiles, the tile rows split evenly."""
    return R.cdiv(R.cdiv(height, ts), bands) * ts


def _shifted(s: R.Screen, y0: int) -> R.Screen:
    shift = torch.tensor([0.0, float(y0)], dtype=s.means2d.dtype, device=s.means2d.device)
    return s._replace(means2d=s.means2d - shift)


def band_footprint_counts(params, alive: torch.Tensor, viewmats, Ks, width: int, height: int,
                          ts: int, bands: int) -> List[np.ndarray]:
    """``RT.footprint_counts`` with each measured view's footprints clipped
    to each band: one array a view and band."""
    bh = band_height(height, ts, bands)
    out = []
    alive_np = alive.cpu().numpy()
    with torch.no_grad():
        for i in RT.measured_views(len(viewmats)):
            s = R.project(params["means"], params["quats"], params["log_scales"],
                          params["logit_opacities"], RT.sh_coeffs(params), viewmats[i], Ks[i],
                          width, height, 0, opacity_radius=False)
            for m in range(bands):
                nt = RT.tile_counts_host(_shifted(s, m * bh), alive_np, width, bh, ts)
                if len(nt):
                    out.append(nt)
    return out


def view_loss_and_backward_bands(p, alive, viewmat, K, gt, cfg, sh_degree, max_t, budgets,
                                 scale: float, dtype=torch.float32, bands: int = 2):
    """``RT.view_loss_and_backward`` of a view rendered band by band.
    Returns (loss, pairs, n_isect), the pairs and intersections summed over
    the bands."""
    W, H, ts, chunk = cfg["width"], cfg["height"], cfg["tile_size"], cfg["raster_chunk"]
    bh = band_height(H, ts, bands)
    s = R.project(p["means"], p["quats"], p["log_scales"],
                  R.masked_logits(p["logit_opacities"], alive), RT.sh_coeffs(p), viewmat, K,
                  W, H, sh_degree, dtype)
    binned, parts, pairs, n_isect = [], [], 0, 0
    for m in range(bands):
        sb = _shifted(s, m * bh)
        b = R.bin_view(sb, W, bh, ts, max_t, budgets)
        img, n = R.blend(b, sb, W, bh, ts, chunk, dtype)
        binned.append(b)
        parts.append(img)
        pairs += n
        n_isect += int(b.n_isect)
    img = torch.cat(parts)[:H].float().detach().requires_grad_(True)
    loss = RT.photometric(img, gt, cfg["lambda_dssim"])
    (d_img,) = torch.autograd.grad(loss * scale, img)
    pad = torch.zeros((bands * bh, W, 3), dtype=d_img.dtype, device=d_img.device)
    pad[:H] = d_img
    outs = (s.means2d, s.conics, s.colors, s.opac)
    grads = [torch.zeros_like(o) for o in outs]
    for m, b in enumerate(binned):
        sb = _shifted(R.Screen(*(t.detach() for t in outs), s.depths.detach(), s.radii), m * bh)
        leaves = [t.requires_grad_(True) for t in sb[:4]]
        R.blend_backward(b, sb, pad[m * bh:(m + 1) * bh], W, bh, ts, chunk, dtype)
        for g, leaf in zip(grads, leaves):
            if leaf.grad is not None:
                g += leaf.grad
    torch.autograd.backward(list(outs), grads)
    return float(loss.detach()), pairs, n_isect


def banded_reference(bands: int):
    """A private instance of ``reference/train.py`` whose
    ``reference_steps`` renders each view in ``bands`` bands: the static
    step's own loop, with the view function replaced in this instance only,
    so the shared module and its other callers are never touched."""
    spec = importlib.util.find_spec(RT.__name__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.view_loss_and_backward = functools.partial(view_loss_and_backward_bands, bands=bands)
    return mod
