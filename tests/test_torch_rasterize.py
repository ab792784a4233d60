"""PyTorch port, ``ops/rasterize_cuda.py`` and ``ops/rasterize_ref.py``
against the JAX package. On the CPU the port's rasterizer runs the plain
versions of its kernels; the JAX side runs its Pallas kernels in interpret
mode. Tolerances are those of ``tests/test_rasterize_pallas.py:111-113``."""

import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops.rasterize_pallas import rasterize_tiled as j_raster
from gaussian_splatting_tpu.ops.rasterize_ref import rasterize_reference as j_oracle
from gaussian_splatting_tpu_torch.ops import rasterize_cuda
from gaussian_splatting_tpu_torch.ops.rasterize_cuda import rasterize_tiled as t_raster
from gaussian_splatting_tpu_torch.ops.rasterize_ref import rasterize_reference as t_oracle
from torch_parity import screen_gaussians, to_jax, to_torch

STAT_KEYS = {"n_isect", "n_dropped", "n_budget_dropped", "n_grad_dropped"}


def _assert_images(t_out, j_out):
    (ti, ta, td), (ji, ja, jd) = t_out[:3], j_out[:3]
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)


@pytest.mark.parametrize("shape,tile_size", [((64, 48), 16), ((40, 24), 16),
                                             ((40, 24), 8), ((72, 40), 32)])
def test_rasterize_tiled_matches_jax_pallas(rng, shape, tile_size):
    width, height = shape
    args = screen_gaussians(rng, 120, width, height)
    j_out = j_raster(*to_jax(*args), width, height, tile_size=tile_size, chunk=128,
                     interpret=True, with_stats=True)
    t_out = t_raster(*to_torch(*args), width, height, tile_size=tile_size, chunk=128,
                     with_stats=True)
    assert t_out[0].shape == (height, width, 3)
    _assert_images(t_out, j_out)
    assert set(t_out[3]) == STAT_KEYS
    assert {k: int(v) for k, v in t_out[3].items()} == {k: int(v) for k, v in j_out[3].items()}


def test_rasterize_tiled_background_and_grad_drop_bound(rng):
    """bg blends by 1 - alpha; a heavy-overlap scene overflows the dense
    gradient-buffer bound (8N) and reports the same n_grad_dropped."""
    width, height = 64, 48
    args = screen_gaussians(rng, 30, width, height, radius_scale=20.0,
                            opacity_range=(0.05, 0.12))
    bg = np.asarray([0.2, 0.5, 0.7], np.float32)
    j_out = j_raster(*to_jax(*args), width, height, bg=to_jax(bg)[0], chunk=128,
                     interpret=True, with_stats=True)
    t_out = t_raster(*to_torch(*args), width, height, bg=to_torch(bg)[0], chunk=128,
                     with_stats=True)
    _assert_images(t_out, j_out)
    assert int(t_out[3]["n_grad_dropped"]) == int(j_out[3]["n_grad_dropped"]) > 0


def _chunk_carry_scene():
    """One 16x16 tile, every entry centred on pixel (8, 8) (alpha = opacity
    there): 127 entries of alpha 0.02, one of 0.999 that would push T below
    1e-4, then 9 red entries of alpha 0.5 in the next 128-entry chunk."""
    n = 137
    means2d = np.full((n, 2), 8.5, np.float32)
    conics = np.tile(np.asarray([[1.0, 0.0, 1.0]], np.float32), (n, 1))
    opac = np.full((n,), 0.02, np.float32)
    opac[127] = 0.9995
    opac[128:] = 0.5
    colors = np.zeros((n, 3), np.float32)
    colors[:128, 1] = 1.0
    colors[128:, 0] = 1.0
    depths = (1.0 + 0.01 * np.arange(n)).astype(np.float32)
    radii = np.full((n,), 3, np.int32)
    return means2d, conics, colors, opac, depths, radii


def test_chunk_carried_stop_rule_matches_jax_pallas_not_oracle():
    """The TPU kernel restarts a pixel stopped in one chunk from the
    transmittance of its last counted entry in the next chunk; the oracle
    stops for good. The port follows the kernel."""
    args = _chunk_carry_scene()
    j_img, j_alpha, _ = j_raster(*to_jax(*args), 16, 16, tile_size=16, chunk=128,
                                 interpret=True)
    t_img, t_alpha, _ = t_raster(*to_torch(*args), 16, 16, tile_size=16, chunk=128)
    o = t_oracle(*to_torch(*args), 16, 16, tile_size=16)
    red, alpha = float(t_img[8, 8, 0]), float(t_alpha[8, 8])
    np.testing.assert_allclose(red, 0.0767, atol=2e-4)
    np.testing.assert_allclose(alpha, 0.99985, atol=2e-5)
    np.testing.assert_allclose(red, float(j_img[8, 8, 0]), atol=1e-5)
    np.testing.assert_allclose(alpha, float(j_alpha[8, 8]), atol=1e-5)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-5)
    assert float(o.image[8, 8, 0]) == 0.0 and float(o.alpha[8, 8]) < 0.93


@pytest.mark.parametrize("tile_size", [16, None])
def test_oracle_matches_jax_oracle(rng, tile_size):
    width, height = 48, 40
    args = screen_gaussians(rng, 60, width, height)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    j = j_oracle(*to_jax(*args), width, height, bg=to_jax(bg)[0], tile_size=tile_size)
    t = t_oracle(*to_torch(*args), width, height, bg=to_torch(bg)[0], tile_size=tile_size)
    for name in ("image", "alpha", "depth"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   atol=1e-5, err_msg=name)


def test_plain_forward_counts_evaluated_pairs(rng):
    """fwd_tiles_plain's pair count: every entry of every tile for every
    pixel when nothing saturates (low opacity), fewer once pixels stop."""
    width, height = 32, 32
    args = to_torch(*screen_gaussians(rng, 40, width, height, opacity_range=(0.05, 0.1)))
    b = rasterize_cuda.isect_and_sort(*args, width, height, 16, 128, 16)
    _, pairs = rasterize_cuda.fwd_tiles_plain(b.tile_starts, b.counts, b.sorted_soa,
                                              16, 2, 128)
    assert int(pairs) == int(b.n_isect) * 256
    m, c, col, o, d, r = _chunk_carry_scene()
    sat = to_torch(m[:20], c[:20], col[:20], np.full(20, 0.9, np.float32), d[:20], r[:20])
    b = rasterize_cuda.isect_and_sort(*sat, 16, 16, 16, 128, 16)
    _, pairs = rasterize_cuda.fwd_tiles_plain(b.tile_starts, b.counts, b.sorted_soa,
                                              16, 1, 128)
    assert int(pairs) < int(b.n_isect) * 256


def test_backward_raises_until_the_training_slice(rng):
    args = [t.requires_grad_(t.is_floating_point())
            for t in to_torch(*screen_gaussians(rng, 20, 32, 32))]
    img, alpha, depth = t_raster(*args, 32, 32, chunk=128)
    assert img.requires_grad
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        img.sum().backward()


def test_fwd_tiles_checks_arguments():
    starts = torch.zeros(3, dtype=torch.int32)
    counts = torch.zeros(2, dtype=torch.int32)
    soa = torch.zeros((16, 8), dtype=torch.float32)
    with pytest.raises(ValueError):
        rasterize_cuda.fwd_tiles(starts[:2], counts, soa, 16, 2, 128)
    with pytest.raises(ValueError):
        rasterize_cuda.fwd_tiles(starts, counts, soa.double(), 16, 2, 128)
    with pytest.raises(ValueError):
        rasterize_cuda.fwd_tiles(starts, counts, soa, 16, 2, 4096)
    assert rasterize_cuda.fwd_tiles(starts, counts, soa, 16, 2, 128).abs().sum() == 0
