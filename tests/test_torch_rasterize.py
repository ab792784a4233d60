"""PyTorch port, ``ops/rasterize_cuda.py`` and ``ops/rasterize_ref.py``
against the JAX package, forward and backward. On the CPU the port's
rasterizer runs the plain versions of its kernels; the JAX side runs its
Pallas kernels in interpret mode. Image tolerances are those of
``tests/test_rasterize_pallas.py:111-113``, gradient tolerances those of
``tests/test_rasterize_pallas.py:182``."""

import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops.rasterize_pallas import rasterize_tiled as j_raster
from gaussian_splatting_tpu.ops.rasterize_ref import rasterize_reference as j_oracle
from gaussian_splatting_tpu_torch.ops import rasterize_cuda, tiling
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


def _grad_loss(img, alpha, depth, timg, with_depth):
    """The loss of ``tests/test_rasterize_pallas.py:161-164`` (without its
    depth term when the depth output is declared non-differentiable)."""
    loss = ((img - timg) ** 2).sum() + 0.3 * (alpha ** 2).sum()
    return loss + 0.05 * (depth ** 2).sum() if with_depth else loss


@pytest.mark.parametrize("depth_grad", [True, False])
def test_gradients_match_jax_pallas_and_oracle(rng, depth_grad):
    """The backward (kernel 3's plain version + the reduce) against the JAX
    ``rasterize_tiled(interpret=True)`` gradients and against autograd
    through the port's oracle, at the tolerance of
    ``tests/test_rasterize_pallas.py:182`` (atol 2e-4 of the largest
    gradient, rtol 1e-3: the tiled and oracle stop rules differ at
    pixels whose transmittance lands at 1e-4)."""
    import jax
    import jax.numpy as jnp

    width, height = 48, 32
    args = screen_gaussians(rng, 60, width, height)
    timg = rng.uniform(size=(height, width, 3)).astype(np.float32)
    radii = args[5]

    def j_loss(*a):
        img, alpha, depth = j_raster(*a, jnp.asarray(radii), width, height, tile_size=16,
                                     chunk=128, interpret=True, depth_grad=depth_grad)
        return _grad_loss(img, alpha, depth, jnp.asarray(timg), depth_grad)

    j_g = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(*to_jax(*args[:5]))

    def t_grads(fn):
        xs = [x.requires_grad_(True) for x in to_torch(*args[:5])]
        _grad_loss(*fn(xs), torch.as_tensor(timg), depth_grad).backward()
        return [np.zeros(x.shape, np.float32) if x.grad is None else x.grad.numpy()
                for x in xs]

    t_g = t_grads(lambda xs: t_raster(*xs, torch.as_tensor(radii), width, height,
                                      tile_size=16, chunk=128, depth_grad=depth_grad))
    o_g = t_grads(lambda xs: t_oracle(*xs, torch.as_tensor(radii), width, height,
                                      tile_size=16)[:3])
    names = ["means2d", "conics", "colors", "opacities", "depths"]
    for name, tg, jg, og in zip(names, t_g, j_g, o_g):
        jg = np.asarray(jg)
        assert np.isfinite(tg).all(), name
        if name == "depths" and not depth_grad:
            assert (tg == 0).all() and (jg == 0).all()
            continue
        for ref in (jg, og):
            scale = np.abs(ref).max() + 1e-8
            np.testing.assert_allclose(tg, ref, atol=2e-4 * scale, rtol=1e-3,
                                       err_msg=f"grad mismatch: {name}")


def test_starved_gradient_buffer_counts_drops(rng):
    """At a starved ``grad_buffer_frac`` the backward drops whole chunks of
    the stream and counts them as the JAX kernel does; the gradients that
    remain are finite. ``rasterize_grad_meta`` gives the JAX package's
    (n_written, n_dropped, grad_cap) at both fractions."""
    from gaussian_splatting_tpu.ops.rasterize_pallas import rasterize_grad_meta as j_meta

    width, height = 64, 48
    args = screen_gaussians(rng, 150, width, height)
    for frac in (1.0, 0.05):
        j = tuple(int(x) for x in j_meta(*to_jax(*args), width, height, chunk=128,
                                         grad_buffer_frac=frac, interpret=True))
        t = rasterize_cuda.rasterize_grad_meta(*to_torch(*args), width, height, chunk=128,
                                               grad_buffer_frac=frac)
        assert t == j, frac
    n_written, n_dropped, gcap = t
    assert n_dropped > 0 and n_written == gcap
    xs = [x.requires_grad_(True) for x in to_torch(*args[:5])]
    img, alpha, _ = t_raster(*xs, torch.as_tensor(args[5]), width, height, chunk=128,
                             grad_buffer_frac=0.05, depth_grad=False)
    (img.sum() + alpha.sum()).backward()
    assert all(bool(torch.isfinite(x.grad).all()) for x in xs)
    assert any(bool((x.grad != 0).any()) for x in xs)


def test_plain_backward_meta_and_sentinel_tail(rng):
    """``bwd_tiles_plain`` writes one column per entry in SoA order (row 0
    the gaussian id), pads to a whole chunk with sentinels and reports
    [n_written, n_dropped] in chunks."""
    width, height, chunk, N = 32, 32, 128, 40
    args = to_torch(*screen_gaussians(rng, N, width, height))
    b = rasterize_cuda.isect_and_sort(*args, width, height, 16, chunk, 16)
    out, _ = rasterize_cuda.fwd_tiles_plain(b.tile_starts, b.counts, b.sorted_soa,
                                            16, 2, chunk)
    n = int(b.n_isect)
    grad, meta = rasterize_cuda.bwd_tiles(b.tile_starts, b.counts, b.sorted_soa,
                                          torch.ones_like(out), out, 16, 2, chunk, N,
                                          4 * chunk)
    kept = -(-n // chunk) * chunk
    assert meta.tolist() == [kept, 0]
    assert torch.equal(grad[0, :n], b.sorted_soa[11, :n])
    assert (grad[0, n:kept] == N).all() and (grad[1:, n:kept] == 0).all()
    assert (grad[11:, :kept] == 0).all()


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


def _gapped(b, gap, rng):
    """``b``'s segments moved apart: tile t's segment starts ``gap * (t + 1)``
    columns later, the gaps and the tail hold noise, and tile_starts[T]
    lies ``3 * gap`` past the last segment, as in the bucket layout."""
    T = b.counts.shape[0]
    starts = b.tile_starts[:-1].long() + gap * (torch.arange(T) + 1)
    end = int((starts + b.counts).max()) + 3 * gap
    soa = torch.as_tensor(rng.normal(size=(16, end + 512)).astype(np.float32))
    for t in range(T):
        s, n, c = int(b.tile_starts[t]), int(starts[t]), int(b.counts[t])
        soa[:, n:n + c] = b.sorted_soa[:, s:s + c]
    return torch.cat([starts, torch.tensor([end])]).to(torch.int32), soa


@pytest.mark.parametrize("frac", [1.0, 0.05])
def test_plain_backward_on_gapped_segments_matches_jax(rng, frac):
    """``bwd_tiles_plain`` on segments with gaps between them and
    tile_starts[T] past the last one: entry k of tile t goes to stream
    position excl_prefix(counts)[t] + k, where the TPU kernel appends it,
    so the per-gaussian gradients and [n_written, n_dropped] equal the JAX
    loop backward's (``rasterize_tiled`` and ``rasterize_grad_meta``,
    interpret mode), also when ``grad_buffer_frac`` drops whole chunks."""
    import jax
    import jax.numpy as jnp
    from gaussian_splatting_tpu.ops.rasterize_pallas import rasterize_grad_meta as j_meta

    width, height, chunk, N = 64, 48, 128, 150
    ntx, nty = width // 16, height // 16
    args = screen_gaussians(rng, N, width, height)
    w_img = rng.normal(size=(height, width, 5)).astype(np.float32)

    def loss(img, alpha, depth, w):
        return (img * w[..., :3]).sum() + (alpha * w[..., 3]).sum() + (depth * w[..., 4]).sum()

    j_g = jax.grad(lambda *a: loss(*j_raster(*a, jnp.asarray(args[5]), width, height,
                                             chunk=chunk, grad_buffer_frac=frac,
                                             interpret=True), jnp.asarray(w_img)),
                   argnums=(0, 1, 2, 3, 4))(*to_jax(*args[:5]))
    j_nw, j_nd, j_gcap = (int(x) for x in j_meta(*to_jax(*args), width, height, chunk=chunk,
                                                 grad_buffer_frac=frac, interpret=True))

    b = rasterize_cuda.isect_and_sort(*to_torch(*args), width, height, 16, chunk, 16)
    starts, soa = _gapped(b, 37, rng)
    fout, _ = rasterize_cuda.fwd_tiles_plain(starts, b.counts, soa, 16, ntx, chunk)
    assert torch.equal(fout, rasterize_cuda.fwd_tiles(b.tile_starts, b.counts, b.sorted_soa,
                                                      16, ntx, chunk))
    out = fout.clone().requires_grad_(True)
    img = out.reshape(nty, ntx, 8, 16, 16).permute(0, 3, 1, 4, 2).reshape(height, width, 8)
    loss(img[..., :3], img[..., 4], img[..., 3], torch.as_tensor(w_img)).backward()
    gcap = rasterize_cuda.grad_cap(N, 16, chunk, frac)
    grad, meta, _ = rasterize_cuda.bwd_tiles_plain(starts, b.counts, soa, out.grad, fout, 16,
                                                   ntx, chunk, N, gcap)
    s = tiling.reduce_padded_grads(grad, N, meta[0])
    t_g = [torch.stack([s["dmx"], s["dmy"]], -1), torch.stack([s["dca"], s["dcb"], s["dcc"]], -1),
           torch.stack([s["dr"], s["dg"], s["db"]], -1), s["dop"], s["ddepth"]]
    for name, tg, jg in zip(["means2d", "conics", "colors", "opacities", "depths"], t_g, j_g):
        jg = np.asarray(jg)
        np.testing.assert_allclose(tg.numpy(), jg, atol=2e-4 * (np.abs(jg).max() + 1e-8),
                                   rtol=1e-3, err_msg=name)
    _, unit_meta, _ = rasterize_cuda.bwd_tiles_plain(starts, b.counts, soa,
                                                     torch.ones_like(fout), fout, 16, ntx,
                                                     chunk, N, gcap)
    assert gcap == j_gcap
    assert unit_meta.tolist() == [j_nw, j_nd]
    assert (j_nd > 0) == (frac < 1.0)
