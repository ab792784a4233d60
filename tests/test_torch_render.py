"""PyTorch port, the whole render slice: projection -> SH -> binning ->
pack -> forward, against the JAX package's ``render(backend="pallas")``
(Pallas in interpret mode), plus the facade with its cache and loading a
JAX checkpoint.

Images are compared at atol 1e-4: projection and SH run in float32 in
another operation order, and those differences pass through the blend
(measured maximum over three seeds of the 150-gaussian scene, classic and
antialiased: 3.0e-7 on RGB, 3.6e-7 on alpha, 1.7e-6 on depth). Expected depth
(``ED``: depth / alpha) divides by alpha, so it is compared where alpha is
at least 0.05.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.core.cameras import look_at, make_intrinsics
from gaussian_splatting_tpu.ops.facade import GaussianRasterizer as JRasterizer
from gaussian_splatting_tpu.ops.render import render as j_render
from gaussian_splatting_tpu_torch.models.gaussians import GaussianParams, state_from_numpy
from gaussian_splatting_tpu_torch.ops.facade import GaussianRasterizer as TRasterizer
from gaussian_splatting_tpu_torch.ops.render import render as t_render
from gaussian_splatting_tpu_torch.training.checkpoint import load_checkpoint
from torch_parity import scene_3d, to_jax, to_torch

W, H = 64, 48
MODES = ["RGB", "D", "ED", "RGB+D", "RGB+ED"]


def _camera(eye=(0.5, -0.3, -4.0)):
    view = np.asarray(look_at(eye, (0.0, 0.0, 0.0)))
    K = np.asarray(make_intrinsics(W, H, focal_px=60.0))
    return view, K


def _assert_render_close(t_out, j_out, mode):
    t_r, j_r = t_out.render.numpy(), np.asarray(j_out.render)
    assert t_r.shape == j_r.shape
    alpha = np.asarray(j_out.alpha)
    np.testing.assert_allclose(t_out.alpha.numpy(), alpha, atol=1e-4)
    np.testing.assert_allclose(t_out.depth.numpy(), np.asarray(j_out.depth), atol=1e-4)
    if "ED" in mode:
        ok = alpha >= 0.05
        np.testing.assert_allclose(t_r[ok], j_r[ok], atol=1e-4, rtol=1e-5)
    else:
        np.testing.assert_allclose(t_r, j_r, atol=1e-4)
    np.testing.assert_array_equal(t_out.radii.numpy(), np.asarray(j_out.radii))
    np.testing.assert_allclose(t_out.means2d.numpy(), np.asarray(j_out.means2d), rtol=1e-5)


@pytest.mark.parametrize("rasterize_mode", ["classic", "antialiased"])
@pytest.mark.parametrize("mode", MODES)
def test_render_slice_matches_jax_pallas(rng, mode, rasterize_mode):
    params = scene_3d(rng, 150)
    view, K = _camera()
    bg = np.asarray([0.3, 0.1, 0.6], np.float32)
    kw = dict(sh_degree=3, render_mode=mode, tile_size=16, raster_chunk=128,
              rasterize_mode=rasterize_mode, with_stats=True)
    j_out = j_render(*to_jax(*params, view, K), W, H, bg=jnp.asarray(bg),
                     backend="pallas", **kw)
    t_out = t_render(*to_torch(*params, view, K), W, H, bg=torch.as_tensor(bg),
                     backend="cuda", device="cpu", **kw)
    _assert_render_close(t_out, j_out, mode)
    assert float(t_out.alpha.max()) > 0.5
    assert {k: int(v) for k, v in t_out.stats.items()} == \
        {k: int(v) for k, v in j_out.stats.items()}


def test_ref_backend_matches_jax_ref(rng):
    params = scene_3d(rng, 80)
    view, K = _camera((1.0, 0.5, -3.5))
    j_out = j_render(*to_jax(*params, view, K), W, H, backend="ref", render_mode="RGB+D")
    t_out = t_render(*to_torch(*params, view, K), W, H, backend="ref", render_mode="RGB+D",
                     device="cpu")
    _assert_render_close(t_out, j_out, "RGB+D")


def _facade_params(params):
    means, quats, log_scales, logit_op, sh = params
    return {"means3D": means, "rotations": quats, "scales": log_scales,
            "opacities": logit_op, "shs": sh}


def test_facade_cache_matches_jax_facade(rng):
    params = scene_3d(rng, 100)
    view, K = _camera()
    vp = {"world_view_transform": view, "K": K}
    jr = JRasterizer(W, H, backend="pallas", enable_caching=True)
    tr = TRasterizer(W, H, backend="auto", enable_caching=True, device="cpu")
    assert tr.backend == "cuda"
    j_out = jr.render_single(_facade_params(to_jax(*params)), vp)
    t_params = _facade_params(to_torch(*params))
    t_out = tr.render_single(t_params, vp)
    _assert_render_close(t_out, j_out, "RGB")
    near = {"world_view_transform": view + 1e-3, "K": K}
    t_again = tr.render_single(t_params, near)   # within cache_view_eps: a hit
    assert t_again is t_out and tr.cache_stats() == {"hits": 1, "misses": 1}
    far = {"world_view_transform": np.asarray(look_at((2.0, 0.0, -3.0), (0, 0, 0))), "K": K}
    tr.render_single(t_params, far)
    assert tr.cache_stats() == {"hits": 1, "misses": 2}


def test_facade_render_with_depth_modes(rng):
    params = scene_3d(rng, 40)
    view, K = _camera()
    tr = TRasterizer(W, H, device="cpu")
    p = GaussianParams(*to_torch(params[0], params[1], params[2], params[3]),
                       features_dc=to_torch(params[4][:, :1])[0],
                       features_rest=to_torch(params[4][:, 1:])[0])
    for mode, ch in [("RGB", 3), ("D", 1), ("ED", 1), ("RGB+D", 4), ("RGB+ED", 4)]:
        out = tr.render_with_depth(p, {"world_view_transform": view, "K": K},
                                   render_mode=mode)
        assert out["render"].shape == (H, W, ch), mode
        assert "visibility_filter" in out and "radii" in out


def test_load_jax_checkpoint_renders_the_same_image(rng, tmp_path):
    from gaussian_splatting_tpu.models.gaussians import init_from_points
    from gaussian_splatting_tpu.training.checkpoint import save_checkpoint
    from gaussian_splatting_tpu.training.optimizer import adam_init
    from gaussian_splatting_tpu.training.step import TrainState

    pts = (rng.normal(size=(120, 3)) * 0.7).astype(np.float32)
    cols = rng.uniform(size=(120, 3)).astype(np.float32)
    js = init_from_points(pts, cols, 100, capacity=128, init_opacity=0.6)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, TrainState(gauss=js, opt=adam_init(js.params),
                                     iteration=jnp.int32(7)),
                    extra={"scene_extent": 1.5})

    train_state, meta = load_checkpoint(path, device="cpu")
    state = train_state.gauss
    assert meta == {"scene_extent": 1.5} and int(train_state.iteration) == 7
    assert state.capacity == 128 and int(state.n_alive()) == 100
    for k in ("means", "quats", "log_scales", "logit_opacities", "features_dc",
              "features_rest"):
        np.testing.assert_array_equal(getattr(state.params, k).numpy(),
                                      np.asarray(getattr(js.params, k)))

    view, K = _camera()
    jp = js.params
    j_out = j_render(jp.means, jp.quats, jp.log_scales, jp.masked_opacities(js.alive),
                     jp.sh_coeffs, *to_jax(view, K), W, H, backend="pallas")
    tp = state.params
    t_out = t_render(tp.means, tp.quats, tp.log_scales, tp.masked_opacities(state.alive),
                     tp.sh_coeffs, *to_torch(view, K), W, H, backend="cuda", device="cpu")
    _assert_render_close(t_out, j_out, "RGB")
    assert float(t_out.alpha.max()) > 0.3


def test_state_from_numpy_defaults_and_checks(rng):
    n = 5
    arrays = {"means": np.zeros((n, 3)), "quats": np.tile([1.0, 0, 0, 0], (n, 1)),
              "log_scales": np.zeros((n, 3)), "logit_opacities": np.zeros((n, 1)),
              "features_dc": np.zeros((n, 1, 3)), "features_rest": np.zeros((n, 15, 3))}
    s = state_from_numpy(arrays, device="cpu")
    assert s.alive.all() and s.params.means.dtype == torch.float32
    assert s.max_radii2d.dtype == torch.int32 and s.params.sh_coeffs.shape == (n, 16, 3)
    with pytest.raises(KeyError):
        state_from_numpy({k: v for k, v in arrays.items() if k != "quats"}, device="cpu")
    with pytest.raises(ValueError):
        state_from_numpy({**arrays, "means": np.zeros((n + 1, 3))}, device="cpu")
