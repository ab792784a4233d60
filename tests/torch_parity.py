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


PARAM_KEYS = ("means", "quats", "log_scales", "logit_opacities", "features_dc",
              "features_rest")
# Fields of the port's TrainingConfig the JAX package has no counterpart of:
# Deformable 3D Gaussians (models/deform.py) exists in the port only.
PORT_ONLY_FIELDS = (
    "deform", "deform_warmup")


def train_state_arrays(rng, n, n_views=0, moments=False, iteration=0):
    """A training state as numpy arrays under the checkpoint keys: the
    ``scene_3d`` parameters split into dc/rest, some dead slots, nonzero
    accumulators and, when asked, nonzero Adam moments and pose rows."""
    means, quats, log_scales, logit_op, sh = scene_3d(rng, n)
    params = {"means": means, "quats": quats, "log_scales": log_scales,
              "logit_opacities": logit_op, "features_dc": sh[:, :1],
              "features_rest": sh[:, 1:]}
    arrays = {f"params/{k}": v for k, v in params.items()}
    for k, v in params.items():
        mu = rng.normal(size=v.shape) * 1e-3 if moments else np.zeros(v.shape)
        nu = rng.uniform(size=v.shape) * 1e-6 if moments else np.zeros(v.shape)
        arrays[f"adam_mu/{k}"] = mu.astype(np.float32)
        arrays[f"adam_nu/{k}"] = nu.astype(np.float32)
    alive = np.ones((n,), bool)
    alive[::7] = False
    arrays.update(alive=alive,
                  xyz_grad_accum=rng.uniform(size=(n, 3)).astype(np.float32),
                  xyz_grad_count=np.full((n, 1), 3.0, np.float32),
                  max_radii2d=rng.integers(0, 5, size=(n,)).astype(np.int32),
                  adam_step=np.asarray(3 if moments else 0, np.int32),
                  iteration=np.asarray(iteration, np.int32))
    if n_views:
        arrays["poses/deltas"] = (rng.normal(size=(n_views, 6)) * 1e-3).astype(np.float32)
        arrays["poses/mu"] = np.zeros((n_views, 6), np.float32)
        arrays["poses/nu"] = np.zeros((n_views, 6), np.float32)
    return arrays


def jax_train_state(arrays):
    """The JAX package's TrainState from ``train_state_arrays``-style
    arrays."""
    from gaussian_splatting_tpu.models.gaussians import GaussianParams, GaussianState
    from gaussian_splatting_tpu.training.optimizer import AdamState
    from gaussian_splatting_tpu.training.step import PoseState, TrainState

    def group(prefix):
        return GaussianParams(**{k: jnp.asarray(arrays[f"{prefix}/{k}"]) for k in PARAM_KEYS})

    gauss = GaussianState(params=group("params"), alive=jnp.asarray(arrays["alive"]),
                          xyz_grad_accum=jnp.asarray(arrays["xyz_grad_accum"]),
                          xyz_grad_count=jnp.asarray(arrays["xyz_grad_count"]),
                          max_radii2d=jnp.asarray(arrays["max_radii2d"]))
    poses = (PoseState(*(jnp.asarray(arrays[f"poses/{k}"]) for k in ("deltas", "mu", "nu")))
             if "poses/deltas" in arrays else None)
    return TrainState(gauss=gauss,
                      opt=AdamState(mu=group("adam_mu"), nu=group("adam_nu"),
                                    step=jnp.asarray(arrays["adam_step"])),
                      iteration=jnp.asarray(arrays["iteration"]), poses=poses)


def jax_train_state_arrays(state):
    """The inverse of ``jax_train_state``."""
    out = {}
    for k in PARAM_KEYS:
        out[f"params/{k}"] = np.asarray(getattr(state.gauss.params, k))
        out[f"adam_mu/{k}"] = np.asarray(getattr(state.opt.mu, k))
        out[f"adam_nu/{k}"] = np.asarray(getattr(state.opt.nu, k))
    for k in ("alive", "xyz_grad_accum", "xyz_grad_count", "max_radii2d"):
        out[k] = np.asarray(getattr(state.gauss, k))
    out["adam_step"] = np.asarray(state.opt.step)
    out["iteration"] = np.asarray(state.iteration)
    if state.poses is not None:
        for k in ("deltas", "mu", "nu"):
            out[f"poses/{k}"] = np.asarray(getattr(state.poses, k))
    return out
