"""PyTorch port, ``ops/projection.py`` against the JAX ``project_gaussians``
on the same inputs: radii equal, the float outputs at rtol 1e-5."""

import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.core.cameras import look_at, make_intrinsics
from gaussian_splatting_tpu.ops.projection import project_gaussians as j_project
from gaussian_splatting_tpu_torch.ops.projection import project_gaussians as t_project
from torch_parity import to_jax, to_torch


def _scene(rng, n=150):
    """Gaussians around the origin seen from z = -4, with some pushed behind
    the camera and some far off screen."""
    means = rng.normal(size=(n, 3)) * 0.8
    means[:10, 2] = rng.uniform(-9.0, -5.0, size=10)          # behind the camera
    means[10:20, 0] = rng.choice([-1, 1], 10) * rng.uniform(8.0, 20.0, 10)  # off screen
    quats = rng.normal(size=(n, 4))
    scales = rng.uniform(0.02, 0.3, size=(n, 3))
    opac = rng.uniform(0.001, 0.99, size=(n,))
    view = np.asarray(look_at((0.5, -0.3, -4.0), (0.0, 0.0, 0.0)))
    K = np.asarray(make_intrinsics(64, 48, focal_px=60.0))
    return tuple(a.astype(np.float32) for a in (means, quats, scales, opac, view, K))


@pytest.mark.parametrize("with_opacities", [False, True])
def test_project_gaussians_matches_jax(rng, with_opacities):
    means, quats, scales, opac, view, K = _scene(rng)
    j_op = to_jax(opac)[0] if with_opacities else None
    t_op = to_torch(opac)[0] if with_opacities else None
    jp = j_project(*to_jax(means, quats, scales, view, K), 64, 48, opacities=j_op)
    tp = t_project(*to_torch(means, quats, scales, view, K), 64, 48, opacities=t_op)

    radii = tp.radii.numpy()
    assert tp.radii.dtype == torch.int32
    np.testing.assert_array_equal(radii, np.asarray(jp.radii))
    assert (radii[:10] == 0).all()                  # behind the camera: culled
    assert (radii[10:20] == 0).sum() > 0            # some off screen: culled
    assert (radii > 0).sum() > 50
    for name in ("means2d", "conics", "depths", "compensations"):
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                   rtol=1e-5, err_msg=name)


def test_opacity_aware_radii_shrink(rng):
    """Opacity-aware radii never exceed the 3-sigma radii and shrink for
    faint gaussians, as in the JAX function."""
    means, quats, scales, opac, view, K = _scene(rng)
    args = to_torch(means, quats, scales, view, K)
    r3 = t_project(*args, 64, 48).radii.numpy()
    ro = t_project(*args, 64, 48, opacities=to_torch(opac)[0]).radii.numpy()
    assert (ro <= r3).all() and (ro < r3).any()


def test_compute_cov3d_matches_jax(rng):
    from gaussian_splatting_tpu.ops.projection import compute_cov3d as j_cov
    from gaussian_splatting_tpu_torch.ops.projection import compute_cov3d as t_cov

    q = rng.normal(size=(40, 4)).astype(np.float32)
    s = rng.uniform(0.05, 0.5, size=(40, 3)).astype(np.float32)
    np.testing.assert_allclose(t_cov(*to_torch(q, s)).numpy(), np.asarray(j_cov(*to_jax(q, s))),
                               rtol=1e-5, atol=1e-7)
