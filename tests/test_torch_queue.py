"""PyTorch port, the queue path: ``rasterize_tiled(queue=True)`` (CUDA
kernels 6 and 7, their plain versions on the CPU) against the JAX
``queue=True`` rasterizer in interpret mode, and against the port's own
loop path, which it must equal bit for bit on the CPU (the JAX test
``tests/test_rasterize_pallas.py:651`` asks the same of the TPU kernels).
Image tolerances are those of ``tests/test_rasterize_pallas.py:111-113``,
gradient tolerances those of ``:182``."""

import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops.rasterize_pallas import rasterize_tiled as j_raster
from gaussian_splatting_tpu_torch.ops import rasterize_cuda, tiling
from gaussian_splatting_tpu_torch.ops.rasterize_cuda import rasterize_tiled as t_raster
from torch_parity import screen_gaussians, to_jax, to_torch

W = H = 48
NAMES = ("means2d", "conics", "colors", "opacities", "depths")


def _t_run(args, **kw):
    """The port's image and gradients of sum(img^2) + sum(alpha)."""
    xs = [x.requires_grad_(True) for x in to_torch(*args[:5])]
    img, alpha, _ = t_raster(*xs, torch.as_tensor(args[5]), W, H, tile_size=16, chunk=128,
                             **kw)
    ((img * img).sum() + alpha.sum()).backward()
    return img.detach().numpy(), [x.grad.numpy() for x in xs]


def test_queue_matches_jax_queue(rng):
    import jax
    import jax.numpy as jnp

    args = screen_gaussians(rng, 120, W, H)
    radii = jnp.asarray(args[5])

    def j_loss(*a):
        img, alpha, _ = j_raster(*a, radii, W, H, tile_size=16, chunk=128, interpret=True,
                                 queue=True)
        return jnp.sum(img * img) + jnp.sum(alpha), img

    (_, j_img), j_g = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3, 4),
                                         has_aux=True)(*to_jax(*args[:5]))
    t_img, t_g = _t_run(args, queue=True)
    np.testing.assert_allclose(t_img, np.asarray(j_img), atol=1e-5)
    for name, tg, jg in zip(NAMES, t_g, j_g):
        jg = np.asarray(jg)
        assert np.isfinite(tg).all(), name
        np.testing.assert_allclose(tg, jg, atol=2e-4 * (np.abs(jg).max() + 1e-8), rtol=1e-3,
                                   err_msg=name)


@pytest.mark.parametrize("buckets", [0, 2])
def test_queue_is_the_loop_bit_for_bit(rng, buckets):
    """Same image and gradients, bit for bit, with the dense and the bucket
    layout (whose segments have gaps between them)."""
    args = screen_gaussians(rng, 120, W, H)
    l_img, l_g = _t_run(args, sort_buckets=buckets)
    q_img, q_g = _t_run(args, sort_buckets=buckets, queue=True)
    np.testing.assert_array_equal(q_img, l_img)
    for name, a, b in zip(NAMES, q_g, l_g):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("buckets,frac", [(0, 1.0), (0, 0.05), (2, 1.0)])
def test_grad_meta_queue_equals_loop(rng, buckets, frac):
    args = to_torch(*screen_gaussians(rng, 150, 64, 48))
    loop = rasterize_cuda.rasterize_grad_meta(*args, 64, 48, chunk=128, grad_buffer_frac=frac,
                                              sort_buckets=buckets)
    queue = rasterize_cuda.rasterize_grad_meta(*args, 64, 48, chunk=128, grad_buffer_frac=frac,
                                               sort_buckets=buckets, queue=True)
    assert queue == loop and loop[0] > 0
    assert (loop[1] > 0) == (frac < 1.0)


def test_plain_queue_versions_check_the_queue(rng):
    """The plain versions read the queue: a queue that names another tile
    for a work item, or another chunk count, is refused."""
    args = to_torch(*screen_gaussians(rng, 60, 32, 32))
    b = tiling.isect_and_sort(*args, 32, 32, 16, 128, 16)
    T = b.counts.shape[0]
    w_cap = 60 * 16 // 128 + T
    wtile, cum, n_work = tiling.chunk_queue(b.counts, 128, w_cap)
    n_work = n_work.reshape(1)
    good = rasterize_cuda.fwd_tiles_q(wtile, cum, b.tile_starts, b.counts, n_work,
                                      b.sorted_soa, 16, 2, 128)
    assert torch.equal(good, rasterize_cuda.fwd_tiles(b.tile_starts, b.counts, b.sorted_soa,
                                                      16, 2, 128))
    nw = int(n_work)
    bad_tile = wtile.clone()
    bad_tile[nw - 1] = (int(wtile[nw - 1]) + 1) % T
    bad_cum = cum.clone()
    bad_cum[1:] += 1
    for wt, cu, nv in ((bad_tile, cum, n_work), (wtile, bad_cum, n_work),
                       (wtile, cum, n_work - 1), (wtile[:nw - 1], cum, n_work)):
        with pytest.raises(ValueError, match="queue"):
            rasterize_cuda.fwd_tiles_q(wt.contiguous(), cu, b.tile_starts, b.counts, nv,
                                       b.sorted_soa, 16, 2, 128)
    with pytest.raises(ValueError):
        rasterize_cuda.fwd_tiles_q(wtile.long(), cum, b.tile_starts, b.counts, n_work,
                                   b.sorted_soa, 16, 2, 128)
    out = torch.ones((T, 8, 256))
    with pytest.raises(ValueError, match="queue"):
        rasterize_cuda.bwd_tiles_q(bad_tile, cum, b.tile_starts, b.counts, n_work,
                                   b.sorted_soa, out, out, 16, 2, 128, 60, 1024)
