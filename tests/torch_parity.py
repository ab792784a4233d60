"""Shared inputs for the PyTorch-port parity tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both the JAX function
and its PyTorch counterpart (on the CPU), so each comparison sees the same
float32 values.
"""

import jax.numpy as jnp
import numpy as np
import torch

def to_jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def to_torch(*arrays):
    return tuple(torch.as_tensor(np.array(a)) for a in arrays)


def screen_gaussians(rng, n, width, height, radius_scale=1.0, opacity_range=(0.2, 0.9)):
    """Screen-space gaussians as ``tests/test_rasterize_pallas.py``'s
    ``_screen_gaussians`` makes them, as numpy arrays: (means2d, conics,
    colors, opacities, depths) float32 and radii int32."""
    means2d = rng.uniform([0, 0], [width, height], size=(n, 2))
    L = rng.normal(size=(n, 2, 2)) * 1.5 * radius_scale
    cov = L @ np.swapaxes(L, 1, 2) + np.eye(2)[None] * 1.0
    inv = np.linalg.inv(cov)
    conics = np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], axis=1)
    colors = rng.uniform(size=(n, 3))
    opac = rng.uniform(*opacity_range, size=(n,))
    depths = rng.uniform(1.0, 10.0, size=(n,))
    lam = np.linalg.eigvalsh(cov).max(axis=1)
    radii = np.ceil(3 * np.sqrt(lam)).astype(np.int32)
    return tuple(a.astype(np.float32) for a in (means2d, conics, colors, opac, depths)) + (radii,)


def scene_3d(rng, n, sh_rest_scale=0.05):
    """Raw 3D gaussian parameters (means, quats, log_scales, logit_opacities,
    sh_coeffs with 16 bases) around the origin, float32 numpy."""
    means = rng.normal(size=(n, 3)) * 0.8
    quats = rng.normal(size=(n, 4))
    log_scales = np.log(rng.uniform(0.05, 0.3, size=(n, 3)))
    logit_op = rng.normal(size=(n, 1))
    dc = (rng.uniform(size=(n, 1, 3)) - 0.5) / 0.28209479177387814
    sh = np.concatenate([dc, rng.normal(size=(n, 15, 3)) * sh_rest_scale], axis=1)
    return tuple(a.astype(np.float32) for a in (means, quats, log_scales, logit_op, sh))
