"""PyTorch port, the binning modes ``depth_bits`` (one int32 sort key with
the depth quantized) and ``sort_bands`` (band-split binning) against the
JAX package on identical screen-space inputs: ``isect_and_sort``'s segment
tables, counters and the SoA inside segments exact (the columns outside
segments are read by no kernel); ``rasterize_tiled``'s images and
gradients against JAX's at the tolerances of the port's flat path
(images and alpha 1e-6, depth 1e-6 + rtol 1e-6, gradients those of
``tests/test_rasterize_pallas.py:182``) and against the port's flat path
at those of ``tests/test_rasterize_pallas.py:398,679``; the gradient
stream's and the chunk queue's capacities on the band path. The JAX side
runs jitted, its Pallas kernels in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops.rasterize_pallas import rasterize_grad_meta as j_meta
from gaussian_splatting_tpu.ops.rasterize_pallas import rasterize_tiled as j_raster
from gaussian_splatting_tpu.ops.tiling import class_caps, exact_tile_counts
from gaussian_splatting_tpu.ops.tiling import isect_and_sort as j_isect
from gaussian_splatting_tpu_torch.ops import rasterize_cuda
from gaussian_splatting_tpu_torch.ops import tiling as t_tiling
from gaussian_splatting_tpu_torch.ops.rasterize_cuda import rasterize_tiled as t_raster
from torch_parity import screen_gaussians, to_jax, to_torch

W, H = 64, 48  # 4 x 3 tiles of 16: K = 2 splits the rows 2 + 1, K = 5 and 7 exceed them
CHUNK = 128
COUNTERS = ("n_isect", "n_dropped", "n_budget_dropped", "n_bucket_dropped")
NAMES = ("means2d", "conics", "colors", "opacities", "depths")


def _bin(args, max_t=16, **kw):
    jb = jax.jit(lambda *a: j_isect(*a, W, H, 16, CHUNK, max_t, interpret=True, **kw))(
        *to_jax(*args))
    tb = t_tiling.isect_and_sort(*to_torch(*args), W, H, 16, CHUNK, max_t, **kw)
    return jb, tb


def _segment_cols(b):
    starts, counts = b.tile_starts.numpy(), b.counts.numpy()
    return np.concatenate([np.arange(s, s + c) for s, c in zip(starts[:-1], counts)]
                          + [np.zeros(0, np.int64)]).astype(np.int64)


def _assert_same(jb, tb):
    """Tables and counters equal, and the SoA equal column for column inside
    every segment."""
    np.testing.assert_array_equal(tb.tile_starts.numpy(), np.asarray(jb.tile_starts))
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
    assert tb.tile_starts.dtype == tb.counts.dtype == torch.int32
    for k in COUNTERS:
        assert int(getattr(tb, k)) == int(getattr(jb, k)), k
    j_soa, t_soa = np.asarray(jb.sorted_soa), tb.sorted_soa.numpy()
    assert t_soa.shape == j_soa.shape
    cols = _segment_cols(tb)
    assert len(cols) == int(tb.n_isect)
    np.testing.assert_array_equal(t_soa[:12, cols], j_soa[:12, cols])


def _budgets(args, K=1, max_t=16, scale=1.0):
    """Class budgets covering the heaviest of K bands (``bench.py:86-105``),
    times ``scale``."""
    m, c, _, o, _, r = args
    caps = np.asarray(class_caps(max_t))
    nty = -(-H // 16)
    band_h = -(-nty // K)
    hist = np.zeros(len(caps), np.int64)
    for k in range(K):
        lo, hi = min(k * band_h, nty), min((k + 1) * band_h, nty)
        nt = np.minimum(exact_tile_counts(m, r, W, H, 16, conics=c, opacities=o,
                                          row_lo=lo, row_hi=hi), max_t)
        cls = np.searchsorted(caps, np.clip(nt, 1, max_t))
        hist = np.maximum(hist, np.bincount(cls[nt > 0], minlength=len(caps))[:len(caps)])
    return tuple(int(h * scale) for h in hist)


@pytest.mark.parametrize("layout,bits", [("dense", 16), ("dense", 10), ("compact", 16)])
def test_depth_bits_matches_jax(rng, layout, bits):
    """The quantized key: JAX's tables, counters and segments on both slot
    layouts; the tables equal the exact key's (only the order inside a tile
    may change)."""
    args = screen_gaussians(rng, 150, W, H)
    kw = {"class_budgets": _budgets(args)} if layout == "compact" else {}
    jb, tb = _bin(args, depth_bits=bits, **kw)
    _assert_same(jb, tb)
    exact = t_tiling.isect_and_sort(*to_torch(*args), W, H, 16, CHUNK, 16, **kw)
    np.testing.assert_array_equal(tb.tile_starts.numpy(), exact.tile_starts.numpy())
    assert int(tb.n_isect) > 150


@pytest.mark.parametrize("case", ["equal_depths", "empty_scene"])
def test_depth_bits_degenerate_scenes_match_jax(rng, case):
    """All depths equal (a zero depth range: every slot quantizes to 0 and
    keeps its slot order) and a scene with no real slot (dmin = +inf, dmax =
    -inf: no NaN may reach the key)."""
    m, c, col, o, d, r = screen_gaussians(rng, 80, W, H)
    if case == "equal_depths":
        d = np.full_like(d, 3.25)
    else:
        o = np.full_like(o, 1e-3)  # under the 1/255 gate: every slot a sentinel
    jb, tb = _bin((m, c, col, o, d, r), depth_bits=16)
    _assert_same(jb, tb)
    assert (int(tb.n_isect) > 0) == (case == "equal_depths")


def test_depth_bits_ignored_on_bucket_path(rng):
    """The bucket path keeps the exact (tile, depth) order: depth_bits
    changes nothing there, in either package."""
    args = screen_gaussians(rng, 150, W, H)
    jb, tb = _bin(args, depth_bits=16, sort_buckets=2)
    _assert_same(jb, tb)
    plain = t_tiling.isect_and_sort(*to_torch(*args), W, H, 16, CHUNK, 16, sort_buckets=2)
    assert torch.equal(tb.sorted_soa, plain.sorted_soa)
    assert torch.equal(tb.tile_starts, plain.tile_starts)


@pytest.mark.parametrize("kw", [{"sort_bands": 2, "sort_buckets": 2}, {"depth_bits": 28}])
def test_invalid_binning_modes_raise(rng, kw):
    """Bands with buckets (JAX asserts them exclusive), and a tile grid too
    large for the depth bits in an int32 key (13 tiles need 4 of 31 bits)."""
    args = to_torch(*screen_gaussians(rng, 10, W, H))
    with pytest.raises(ValueError):
        t_tiling.isect_and_sort(*args, W, H, 16, CHUNK, 16, **kw)


@pytest.mark.parametrize("K,layout", [(2, "dense"), (3, "dense"), (5, "dense"),
                                      (7, "dense"), (7, "compact"),
                                      (3, "starved")])
def test_band_binning_matches_jax(rng, K, layout):
    """``sort_bands`` = K: JAX's ``_band_binned`` tables, counters (summed
    over bands) and segments, with the dense layout, the compact one under
    budgets that cover the heaviest band, and budgets starved to half
    (drops counted per band). K = 5 and 7 exceed the 3 tile rows: the
    trailing bands are empty. Where nothing drops, the counts are the flat
    path's."""
    args = screen_gaussians(rng, 150, W, H)
    kw = {}
    if layout != "dense":
        kw["class_budgets"] = _budgets(args, K, scale=0.5 if layout == "starved" else 1.0)
    jb, tb = _bin(args, sort_bands=K, **kw)
    _assert_same(jb, tb)
    m_slots = t_tiling.total_slots(150, 16, kw.get("class_budgets"))
    assert int(tb.tile_starts[-1]) == K * m_slots
    flat = t_tiling.isect_and_sort(*to_torch(*args), W, H, 16, CHUNK, 16)
    if layout == "starved":
        assert int(tb.n_budget_dropped) > 0
    else:
        assert int(tb.n_dropped) == int(tb.n_budget_dropped) == int(flat.n_dropped) == 0
        np.testing.assert_array_equal(tb.counts.numpy(), flat.counts.numpy())
        assert int(tb.n_isect) == int(flat.n_isect)
        cols = _segment_cols(tb)
        np.testing.assert_array_equal(tb.sorted_soa[:12, cols].numpy(),
                                      flat.sorted_soa[:12, :int(flat.n_isect)].numpy())


def test_band_tile_cap_binds_per_band_as_in_jax(rng):
    """Large splats at max_t 2: the cap applies in each band, so a gaussian
    that crosses a band boundary keeps more tiles than on the flat path.
    The port equals JAX's band path, not the flat one."""
    args = screen_gaussians(rng, 40, W, H, radius_scale=6.0)
    jb, tb = _bin(args, max_t=2, sort_bands=3)
    _assert_same(jb, tb)
    flat = t_tiling.isect_and_sort(*to_torch(*args), W, H, 16, CHUNK, 2)
    assert int(flat.n_dropped) > 0
    assert int(tb.n_isect) > int(flat.n_isect)


def _grads(fn, args, timg):
    """Image, alpha, depth and the gradients of the loss of
    ``tests/test_rasterize_pallas.py:718-721``."""
    xs = [x.requires_grad_(True) for x in to_torch(*args[:5])]
    img, alpha, depth = fn(xs)
    loss = (((img - timg) ** 2).sum() + 0.3 * (alpha ** 2).sum()
            + 0.05 * (depth ** 2).sum())
    loss.backward()
    return [a.detach().numpy() for a in (img, alpha, depth)], [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("mode", [{"sort_bands": 3}, {"depth_bits": 16}])
def test_rasterize_tiled_modes_match_jax(rng, mode):
    """Images and gradients against JAX's ``rasterize_tiled`` in the same
    mode, at the port's flat-path tolerances: on this scene the flat path's
    own gradients differ from JAX's by up to 1.2e-5 of the largest
    (float32 sums in another order), which the JAX band test's 1e-6 does
    not cover. Against the port's flat path, the band path is held to that
    test's tolerances (``tests/test_rasterize_pallas.py:679``: images 1e-6,
    gradients atol 1e-6 of the largest, rtol 1e-5) and the quantized key's
    image to 2e-3 (``:398``)."""
    args = screen_gaussians(rng, 90, W, H)
    timg = rng.uniform(size=(H, W, 3)).astype(np.float32)
    radii = args[5]

    def j_loss(*a):
        img, alpha, depth = j_raster(*a, jnp.asarray(radii), W, H, tile_size=16, chunk=CHUNK,
                                     interpret=True, **mode)
        loss = (jnp.sum((img - jnp.asarray(timg)) ** 2) + 0.3 * jnp.sum(alpha ** 2)
                + 0.05 * jnp.sum(depth ** 2))
        return loss, (img, alpha, depth)

    (_, j_out), j_g = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3, 4),
                                                 has_aux=True))(*to_jax(*args[:5]))

    def port(**kw):
        return _grads(lambda xs: t_raster(*xs, torch.as_tensor(radii), W, H, tile_size=16,
                                          chunk=CHUNK, **kw), args, torch.as_tensor(timg))

    t_out, t_g = port(**mode)
    np.testing.assert_allclose(t_out[0], np.asarray(j_out[0]), atol=1e-6, err_msg="image")
    np.testing.assert_allclose(t_out[1], np.asarray(j_out[1]), atol=1e-6, err_msg="alpha")
    # Depths reach 10: the two forwards' float32 sums differ by a few ulps.
    np.testing.assert_allclose(t_out[2], np.asarray(j_out[2]), atol=1e-6, rtol=1e-6,
                               err_msg="depth")
    for name, tg, jg in zip(NAMES, t_g, j_g):
        jg = np.asarray(jg)
        assert np.isfinite(tg).all(), name
        np.testing.assert_allclose(tg, jg, atol=2e-4 * (np.abs(jg).max() + 1e-8), rtol=1e-3,
                                   err_msg=name)
    f_out, f_g = port()
    if "depth_bits" in mode:
        np.testing.assert_allclose(t_out[0], f_out[0], atol=2e-3)
        return
    for name, t, f in zip(("image", "alpha", "depth"), t_out, f_out):
        np.testing.assert_allclose(t, f, atol=1e-6, err_msg=name)
    for name, tg, fg in zip(NAMES, t_g, f_g):
        np.testing.assert_allclose(tg, fg, atol=1e-6 * (np.abs(fg).max() + 1e-8), rtol=1e-5,
                                   err_msg=name)


def test_depth_bits_image_on_separated_depths(rng):
    """``tests/test_rasterize_pallas.py:398``: depths on a coarse grid
    cannot reorder under 16-bit quantization, so the image is the exact
    key's bit for bit; random depths stay within 2e-3."""
    m, c, col, o, d, r = screen_gaussians(rng, 60, W, H)
    d_sep = ((np.arange(60) % 16) * 0.5 + 1.0).astype(np.float32)

    def image(depths, bits):
        img, alpha, _ = t_raster(*to_torch(m, c, col, o, depths, r), W, H, tile_size=16,
                                 chunk=CHUNK, depth_bits=bits)
        return img.numpy(), alpha.numpy()

    for a, b in zip(image(d_sep, 16), image(d_sep, 0)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(image(d, 16)[0], image(d, 0)[0], atol=2e-3)


@pytest.mark.parametrize("budgets", [False, True])
def test_queue_with_bands_is_the_loop_bit_for_bit(rng, budgets):
    """``queue=True`` on the band layout (sentinel runs inside the stream,
    the queue sized for K times the slots): the loop path's image and
    gradients bit for bit."""
    args = screen_gaussians(rng, 120, W, H)
    kw = {"sort_bands": 3}
    if budgets:
        kw["class_budgets"] = _budgets(args, 3)
    timg = torch.as_tensor(rng.uniform(size=(H, W, 3)).astype(np.float32))
    runs = [_grads(lambda xs: t_raster(*xs, torch.as_tensor(args[5]), W, H, tile_size=16,
                                       chunk=CHUNK, queue=q, **kw), args, timg)
            for q in (False, True)]
    (l_out, l_g), (q_out, q_g) = runs
    for a, b in zip(q_out + q_g, l_out + l_g):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("budgets", [False, True])
def test_band_capacities_count_k_times_the_slots(rng, budgets):
    """On the band path the gradient stream's capacity and the chunk
    queue's ``w_cap`` count K x ``total_slots`` (``rasterize_pallas.py:
    805-828``; the dense bound stays min(n_slots, 8N)); the occupancy probe
    (queue path) equals JAX's (n_written, n_dropped, grad_cap)."""
    N, K = 120, 3
    args = screen_gaussians(rng, N, W, H)
    cb = _budgets(args, K) if budgets else None
    m_slots = t_tiling.total_slots(N, 16, cb)
    cfg = rasterize_cuda._config(N, W, H, 16, CHUNK, 16, 1.0, queue=True, class_budgets=cb,
                                 sort_bands=K)
    bound = K * m_slots if budgets else min(K * m_slots, 8 * N)
    assert cfg.grad_cap == -(-bound // CHUNK) * CHUNK + CHUNK
    assert cfg.w_cap == K * m_slots // CHUNK + 12
    assert rasterize_cuda.grad_cap(N, 16, CHUNK, 1.0, cb) < cfg.grad_cap or not budgets
    j = tuple(int(x) for x in jax.jit(lambda *a: j_meta(
        *a, W, H, chunk=CHUNK, class_budgets=cb, sort_bands=K, queue=True,
        interpret=True))(*to_jax(*args)))
    t = rasterize_cuda.rasterize_grad_meta(*to_torch(*args), W, H, chunk=CHUNK,
                                           class_budgets=cb, sort_bands=K, queue=True)
    assert t == j and t[2] == cfg.grad_cap and t[0] > 0
