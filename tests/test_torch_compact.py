"""PyTorch port, the compact footprint-class binning (``ops/tiling.py``
``compact_slots``, ``squeeze_budgets_under_pow2``; the sizes in
``ops/rasterize_cuda.py``; the bucket partition on the compact layout)
against the JAX package on the CPU, and against the port's own dense path.

Tolerances: budgets, slot tiles, slot gaussians, counters, segment tables
and SoA columns below n_isect equal; the port's compact path against its
dense path: image, alpha and depth within atol 1e-6 and gradients within
atol 1e-6 (``tests/test_rasterize_pallas.py:187``); the bucket path's
gradients against the flat path's within 1e-6 of the largest, rtol 1e-5
(``:223``; the reduce sums in another order). One training step with
compact budgets in both packages is in ``tests/test_torch_training.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops import tiling as j_tiling
from gaussian_splatting_tpu_torch.ops import rasterize_cuda as t_rc
from gaussian_splatting_tpu_torch.ops import tiling as t_tiling
from torch_parity import screen_gaussians, to_jax, to_torch

W, H = 64, 48


@pytest.mark.parametrize("case", range(4))
def test_squeeze_budgets_under_pow2_matches_jax(case):
    """tests/test_rasterize_pallas.py:550's cases."""
    caps = (1, 2, 4)
    budgets, hard = [((1152, 640, 512), (1024, 512, 384)),
                     ((1152, 640, 512), (1152, 640, 512)),
                     ((2048, 1024, 1024), (0, 0, 0)),
                     ((2048, 1536, 1280), (0, 0, 0))][case]
    got = t_tiling.squeeze_budgets_under_pow2(budgets, hard, caps)
    assert got == j_tiling.squeeze_budgets_under_pow2(budgets, hard, caps)
    if case == 0:
        assert sum(b * c for b, c in zip(got, caps)) <= 4096 and got != budgets
    else:
        assert got == budgets


@pytest.mark.parametrize("seed", range(6))
def test_squeeze_budgets_random_match_jax(seed):
    rng = np.random.default_rng(seed)
    caps = j_tiling.class_caps(16)
    for _ in range(50):
        hist = rng.integers(0, 40_000, size=len(caps)) * rng.integers(0, 2, size=len(caps))
        budgets = tuple(int(np.ceil(h * rng.uniform(1.0, 1.3) / 128) * 128 + 128) for h in hist)
        hard = tuple(int(np.ceil(h / 128) * 128) for h in hist)
        got = t_tiling.squeeze_budgets_under_pow2(budgets, hard, caps)
        assert got == j_tiling.squeeze_budgets_under_pow2(budgets, hard, caps)
        assert all(h <= g <= b for h, g, b in zip(hard, got, budgets))


def _j_isect(args, width, height, **kw):
    """The JAX binning, jitted (chunk 128, max_t 16)."""
    return jax.jit(lambda *a: j_tiling.isect_and_sort(*a, width, height, 16, 128, 16,
                                                      interpret=True, **kw))(*to_jax(*args))


def _budgets(kind, n, max_t=16):
    L = len(j_tiling.class_caps(max_t))
    return {"ample": (n,) * L, "starved": (4,) * L,
            "mixed": (n, 0, 8, 3, 0, n, 2, 1)[:L]}[kind]


@pytest.mark.parametrize("kind", ["ample", "starved", "mixed"])
def test_compact_slots_match_jax(rng, kind):
    """Slot tiles, slot gaussians, n_isect, n_budget_dropped and n_dropped
    equal to JAX's ``_enumerate_slots`` (tests/test_rasterize_pallas.py:316
    starves every class)."""
    n = 150
    args = screen_gaussians(rng, n, W, H)
    budgets = _budgets(kind, n)
    ntx, T = -(-W // 16), (-(-W // 16)) * (-(-H // 16))
    enum = jax.jit(lambda *a: j_tiling._enumerate_slots(*a, W, H, 16, 16, budgets, ntx, T))
    jk, jq, j_isect, j_bd, j_dr = enum(*to_jax(*args), jnp.arange(n, dtype=jnp.float32))
    tm, tc, _, to_, _, tr = to_torch(*args)
    tk, tg, t_dr, t_bd, tT = t_tiling.binning_slots(tm, tc, to_, tr, W, H, 16, 16, budgets)
    assert tT == T and tk.shape[0] == t_tiling.total_slots(n, 16, budgets)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jq[10]).astype(np.int32))
    assert tg.dtype == torch.int32
    assert int((tk < T).sum()) == int(j_isect)
    assert (int(t_bd), int(t_dr)) == (int(j_bd), int(j_dr))
    assert (int(t_bd) > 0) == (kind != "ample")


@pytest.mark.parametrize("kind,shape,n", [("ample", (64, 48), 150), ("starved", (64, 48), 150),
                                          ("mixed", (64, 48), 150), ("ample", (40, 24), 80)])
def test_compact_isect_and_sort_matches_jax(rng, kind, shape, n):
    """Segment tables, counters and the SoA below n_isect (zero from it on)
    equal to JAX's compact binning."""
    width, height = shape
    args = screen_gaussians(rng, n, width, height)
    budgets = _budgets(kind, n)
    jb = _j_isect(args, width, height, class_budgets=budgets)
    tb = t_tiling.isect_and_sort(*to_torch(*args), width, height, 16, 128, 16,
                                 class_budgets=budgets)
    np.testing.assert_array_equal(tb.tile_starts.numpy(), np.asarray(jb.tile_starts))
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
    for k in ("n_isect", "n_dropped", "n_budget_dropped", "n_bucket_dropped"):
        assert int(getattr(tb, k)) == int(getattr(jb, k)), k
    ni = int(jb.n_isect)
    assert ni > 0 and tuple(tb.sorted_soa.shape) == jb.sorted_soa.shape
    np.testing.assert_array_equal(tb.sorted_soa.numpy()[:, :ni], np.asarray(jb.sorted_soa)[:, :ni])
    assert (tb.sorted_soa[:, ni:] == 0).all()


@pytest.mark.parametrize("buckets", [2, 4])
def test_compact_bucket_binning_matches_jax(rng, buckets):
    """The bucket partition on the compact layout (``slot_gid``): tables,
    counters and every segment equal to JAX's, each tile's segment the
    compact flat path's."""
    args = screen_gaussians(rng, 150, W, H)
    budgets = _budgets("mixed", 150)
    jb = _j_isect(args, W, H, class_budgets=budgets, sort_buckets=buckets)
    tb = t_tiling.isect_and_sort(*to_torch(*args), W, H, 16, 128, 16, class_budgets=budgets,
                                 sort_buckets=buckets)
    np.testing.assert_array_equal(tb.tile_starts.numpy(), np.asarray(jb.tile_starts))
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
    for k in ("n_isect", "n_dropped", "n_budget_dropped", "n_bucket_dropped"):
        assert int(getattr(tb, k)) == int(getattr(jb, k)), k
    flat = t_tiling.isect_and_sort(*to_torch(*args), W, H, 16, 128, 16, class_budgets=budgets)
    starts, counts = tb.tile_starts.numpy(), tb.counts.numpy()
    np.testing.assert_array_equal(counts, flat.counts.numpy())
    j_soa = np.asarray(jb.sorted_soa)
    for t in np.nonzero(counts)[0]:
        s, f, k = starts[t], int(flat.tile_starts[t]), counts[t]
        assert torch.equal(tb.sorted_soa[:12, s:s + k], flat.sorted_soa[:12, f:f + k])
        np.testing.assert_array_equal(tb.sorted_soa[:12, s:s + k].numpy(), j_soa[:12, s:s + k])


def test_bucket_partition_takes_slot_gid(rng):
    """With ``slot_gid`` a kept slot's gaussian (and its depth in the key)
    comes from the array, not from the slot index mod N."""
    from gaussian_splatting_tpu_torch.ops.partition import bucket_partition, quantum_for

    M, N, T = 5000, 37, 20
    tile = torch.as_tensor(rng.integers(0, T + 1, size=M).astype(np.int32))
    depths = torch.as_tensor(rng.uniform(1, 5, size=N).astype(np.float32))
    sg = torch.as_tensor(rng.integers(0, N, size=M).astype(np.int32))
    q = quantum_for(512, 4, 1.5)
    key, gid, counts, drops = bucket_partition(tile, depths, T, 4, q, slot_gid=sg)
    kept = (tile < T).numpy()
    assert int(counts.sum()) + int(drops.sum()) == kept.sum()
    real = key < (T << 32)
    bits = t_tiling._float_order_bits(depths)
    assert torch.equal(key[real] & 0xFFFFFFFF, bits[gid[real].long()])
    assert sorted(gid[real].tolist()) == sorted(sg[torch.as_tensor(kept)].tolist())
    with pytest.raises(ValueError, match="slot_gid"):
        bucket_partition(tile, depths, T, 4, q, slot_gid=sg.long())


def _raster(args, budgets, buckets=0, **kw):
    m, c, col, o, d, r = (x.clone() for x in to_torch(*args))
    leaves = [x.requires_grad_(True) for x in (m, c, col, o, d)]
    img, alpha, depth = t_rc.rasterize_tiled(*leaves, r, W, H, tile_size=16, chunk=128,
                                             max_tiles_per_gaussian=32, class_budgets=budgets,
                                             sort_buckets=buckets,
                                             reduce_slices=4 if buckets else 0, **kw)
    return img, alpha, depth, leaves


def test_compact_matches_dense_images_and_gradients(rng):
    """tests/test_rasterize_pallas.py:187 on the port: with ample budgets the
    compact layout renders the dense image and gives its gradients."""
    args = screen_gaussians(rng, 80, W, H)
    budgets = (80,) * len(t_tiling.class_caps(32))
    timg = torch.as_tensor(rng.uniform(size=(H, W, 3)).astype(np.float32))
    outs = {}
    for name, b in (("dense", None), ("compact", budgets)):
        img, alpha, depth, leaves = _raster(args, b)
        ((img - timg) ** 2).sum().add(0.3 * (alpha ** 2).sum()).backward()
        outs[name] = [img.detach(), alpha.detach(), depth.detach()] + [x.grad for x in leaves]
    for a, b in zip(outs["compact"], outs["dense"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_compact_bucket_matches_compact_flat(rng):
    """tests/test_rasterize_pallas.py:223: compact + sort_buckets 2 and 4
    (reduce_slices 4) against compact flat."""
    args = screen_gaussians(rng, 80, W, H)
    budgets = (80,) * len(t_tiling.class_caps(32))
    timg = torch.as_tensor(rng.uniform(size=(H, W, 3)).astype(np.float32))

    def run(buckets):
        img, alpha, depth, leaves = _raster(args, budgets, buckets)
        ((img - timg) ** 2).sum().add(0.3 * (alpha ** 2).sum()).add(
            0.05 * (depth ** 2).sum()).backward()
        return [img.detach(), alpha.detach(), depth.detach()], [x.grad for x in leaves]

    flat_out, flat_g = run(0)
    for buckets in (2, 4):
        out, g = run(buckets)
        for a, b in zip(out, flat_out):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
        for a, b in zip(g, flat_g):
            scale = float(b.abs().max()) + 1e-8
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6 * scale, rtol=1e-5)


@pytest.mark.parametrize("frac", [1.0, 0.4, 1e-6])
def test_grad_cap_and_w_cap_match_jax(rng, frac):
    """The JAX formulas (``rasterize_pallas.py:805-828``): on the compact
    layout the gradient stream is bounded by its slot count (no 8N cap),
    the chunk queue by slots // chunk + T; the probe reports that capacity,
    no drop at fraction 1 and drops in a one-chunk buffer."""
    args = screen_gaussians(rng, 150, W, H)
    budgets = _budgets("ample", 150)
    n_slots = j_tiling.total_slots(150, 16, budgets)
    want = j_tiling.cdiv(max(128, int(n_slots * frac)), 128) * 128 + 128
    assert t_rc.grad_cap(150, 16, 128, frac, budgets) == want
    cfg = t_rc._config(150, W, H, 16, 128, 16, frac, class_budgets=budgets)
    assert cfg.w_cap == n_slots // 128 + 12 and cfg.grad_cap == want
    nw, nd, gcap = t_rc.rasterize_grad_meta(*to_torch(*args), W, H, tile_size=16, chunk=128,
                                            class_budgets=budgets, grad_buffer_frac=frac)
    assert gcap == want and nw > 0
    if frac == 1.0:
        assert nd == 0
    if frac == 1e-6:
        assert nd > 0
    # The dense bound keeps its 8N cap.
    dense = min(150 * 16, 8 * 150)
    assert t_rc.grad_cap(150, 16, 128, frac) == j_tiling.cdiv(max(128, int(dense * frac)),
                                                              128) * 128 + 128
