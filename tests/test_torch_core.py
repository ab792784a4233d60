"""PyTorch port, ``core/``: activations, quaternions, spherical harmonics,
cameras and the SE(3) rotation angle against the JAX package on the same numpy inputs: rtol 1e-6,
plus atol 1e-6 (a few float32 ulps of the O(1) terms) for values that
cancel to near zero, where rtol alone would compare rounding noise."""

import numpy as np
import pytest

import gaussian_splatting_tpu.core.activations as j_act
import gaussian_splatting_tpu.core.cameras as j_cam
import gaussian_splatting_tpu.core.quaternions as j_quat
import gaussian_splatting_tpu.core.se3 as j_se3
import gaussian_splatting_tpu.core.sh as j_sh
import gaussian_splatting_tpu_torch.core.activations as t_act
import gaussian_splatting_tpu_torch.core.cameras as t_cam
import gaussian_splatting_tpu_torch.core.quaternions as t_quat
import gaussian_splatting_tpu_torch.core.se3 as t_se3
import gaussian_splatting_tpu_torch.core.sh as t_sh
from torch_parity import to_jax, to_torch


def _close(t_out, j_out, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["scale_activation", "scale_inverse_activation",
                                  "opacity_activation", "opacity_inverse_activation"])
def test_activations(rng, name):
    x = rng.uniform(-4.0, 4.0, size=(64, 3)).astype(np.float32)
    if "inverse" in name:
        x = np.abs(x) / 4.0  # scales > 0, opacities in [0, 1]
    _close(getattr(t_act, name)(*to_torch(x)), getattr(j_act, name)(*to_jax(x)))


def test_quat_normalize_and_rotmat(rng):
    q = rng.normal(size=(50, 4)).astype(np.float32)
    _close(t_quat.quat_normalize(*to_torch(q)), j_quat.quat_normalize(*to_jax(q)))
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    _close(t_quat.quat_to_rotmat(*to_torch(qn)), j_quat.quat_to_rotmat(*to_jax(qn)))


def test_rotmat_to_quat(rng):
    q = rng.normal(size=(50, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = np.asarray(j_quat.quat_to_rotmat(*to_jax(q.astype(np.float32))))
    t_q = t_quat.rotmat_to_quat(*to_torch(R))
    _close(t_q, j_quat.rotmat_to_quat(*to_jax(R)))
    # Round trip up to sign (canonical w >= 0).
    np.testing.assert_allclose(np.abs((t_q.numpy() * q).sum(-1)), 1.0, atol=1e-5)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_and_color(rng, degree):
    coeffs = rng.normal(size=(40, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(40, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    _close(t_sh.eval_sh(degree, *to_torch(coeffs, dirs)),
           j_sh.eval_sh(degree, *to_jax(coeffs, dirs)))
    _close(t_sh.sh_to_color(degree, *to_torch(coeffs, dirs)),
           j_sh.sh_to_color(degree, *to_jax(coeffs, dirs)))


def test_rgb_sh0_roundtrip(rng):
    rgb = rng.uniform(size=(30, 3)).astype(np.float32)
    sh0 = t_sh.rgb_to_sh0(*to_torch(rgb))
    _close(sh0, j_sh.rgb_to_sh0(*to_jax(rgb)))
    _close(t_sh.sh0_to_rgb(sh0), j_sh.sh0_to_rgb(*to_jax(sh0.numpy())))


@pytest.mark.parametrize("eye,target", [((0.5, -0.3, -4.0), (0.0, 0.0, 0.0)),
                                        ((3.0, 1.0, 2.0), (0.2, -0.1, 0.4))])
def test_look_at(eye, target):
    _close(t_cam.look_at(eye, target, device="cpu"), j_cam.look_at(eye, target))


@pytest.mark.parametrize("kw", [{}, {"focal_px": 321.0}, {"focal_35mm": 28.0}])
def test_make_intrinsics(kw):
    _close(t_cam.make_intrinsics(64, 48, device="cpu", **kw),
           j_cam.make_intrinsics(64, 48, **kw))


def test_camera_properties():
    view_np = np.asarray(j_cam.look_at((1.0, 2.0, -3.0), (0.0, 0.0, 0.0)))
    K_np = np.asarray(j_cam.make_intrinsics(64, 48))
    jc = j_cam.Camera(*to_jax(view_np, K_np), 64, 48)
    tc = t_cam.Camera(*to_torch(view_np, K_np), 64, 48)
    _close(tc.position, jc.position)
    _close(tc.cam_to_world, jc.cam_to_world)
    assert tc.focal[0] == float(jc.focal[0]) and tc.focal[1] == float(jc.focal[1])
    assert t_cam.focal_from_heuristic(64, 48) == j_cam.focal_from_heuristic(64, 48)


def test_projection_matrix_and_rotation_angle(rng):
    K_np = np.stack([np.asarray(j_cam.make_intrinsics(64, 48)),
                     np.asarray(j_cam.make_intrinsics(40, 30, focal_px=33.0))])
    _close(t_cam.projection_matrix(*to_torch(K_np), 64, 48),
           j_cam.projection_matrix(*to_jax(K_np), 64, 48))
    q = rng.normal(size=(30, 4)).astype(np.float32)
    R = np.asarray(j_quat.quat_to_rotmat(*to_jax(q / np.linalg.norm(q, axis=-1, keepdims=True))))
    _close(t_se3.se3_log_rot_angle(*to_torch(R)), j_se3.se3_log_rot_angle(*to_jax(R)),
           rtol=1e-5, atol=1e-5)
