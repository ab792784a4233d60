"""PyTorch port, ``ops/tiling.py`` (dense binning and the ``pack_soa``
kernel's plain version) against the JAX ``isect_and_sort`` / ``pack_soa``
on identical screen-space inputs. Integers and SoA columns must be equal."""

import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops.tiling import isect_and_sort as j_isect
from gaussian_splatting_tpu.ops.tiling import pack_soa as j_pack_soa
from gaussian_splatting_tpu_torch.ops import tiling as t_tiling
from torch_parity import screen_gaussians, to_jax, to_torch


def _both(args, width, height, chunk=128, max_t=16):
    jb = j_isect(*to_jax(*args), width, height, 16, chunk, max_t, interpret=True)
    tb = t_tiling.isect_and_sort(*to_torch(*args), width, height, 16, chunk, max_t)
    return jb, tb


def _assert_same_binning(jb, tb):
    np.testing.assert_array_equal(tb.tile_starts.numpy(), np.asarray(jb.tile_starts))
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
    assert int(tb.n_isect) == int(jb.n_isect)
    assert int(tb.n_dropped) == int(jb.n_dropped)
    assert int(tb.n_budget_dropped) == int(jb.n_budget_dropped) == 0
    assert tb.tile_starts.dtype == tb.counts.dtype == torch.int32
    # Sentinel columns may come in another order; real entries may not.
    n = int(jb.n_isect)
    j_soa = np.asarray(jb.sorted_soa)
    assert tuple(tb.sorted_soa.shape) == j_soa.shape
    np.testing.assert_array_equal(tb.sorted_soa.numpy()[:, :n], j_soa[:, :n])


@pytest.mark.parametrize("shape,n", [((64, 48), 150), ((40, 24), 80)])
def test_isect_and_sort_matches_jax(rng, shape, n):
    width, height = shape
    jb, tb = _both(screen_gaussians(rng, n, width, height), width, height)
    assert int(jb.n_isect) > n  # multi-tile footprints exercised
    _assert_same_binning(jb, tb)


def test_tile_cap_binding_matches_jax(rng):
    """max_tiles_per_gaussian=2 on large splats: the cap binds and the
    dropped tiles are counted identically."""
    args = screen_gaussians(rng, 40, 64, 48, radius_scale=6.0)
    jb, tb = _both(args, 64, 48, max_t=2)
    assert int(tb.n_dropped) > 0
    _assert_same_binning(jb, tb)


def test_opacity_cull_and_culled_radii_match_jax(rng):
    """Sub-gate opacities and zero radii contribute no slots, in both."""
    m, c, col, o, d, r = screen_gaussians(rng, 60, 64, 48)
    o[::4] = 1e-3
    r[1::5] = 0
    jb, tb = _both((m, c, col, o, d, r), 64, 48)
    _assert_same_binning(jb, tb)
    gids = tb.sorted_soa[11, :int(tb.n_isect)].long().numpy()
    assert not np.isin(gids, np.r_[0:60:4, 1:60:5]).any()


def test_pack_soa_plain_matches_jax_pack(rng):
    """The kernel's plain version gathers the (10, N) rows through the slot
    index; JAX packs the already-gathered rows. Equal bit for bit, pad 0."""
    N, M, pad = 37, 300, 256
    table = rng.normal(size=(10, N)).astype(np.float32)
    gid = rng.integers(0, N, size=M).astype(np.int32)
    rows = tuple(table[i, gid] for i in range(10)) + (gid.astype(np.float32),)
    j_out = np.asarray(j_pack_soa(to_jax(*rows), pad=pad, interpret=True))
    t_out = t_tiling.pack_soa_plain(*to_torch(table, gid), pad=pad)
    assert tuple(t_out.shape) == j_out.shape == (16, 8192)
    np.testing.assert_array_equal(t_out.numpy(), j_out)
    # The wrapper takes the plain version for CPU tensors.
    np.testing.assert_array_equal(t_tiling.pack_soa(*to_torch(table, gid), pad=pad).numpy(),
                                  j_out)


def test_class_caps_total_slots_and_exact_counts(rng):
    from gaussian_splatting_tpu.ops.tiling import class_caps, exact_tile_counts, total_slots

    for max_t in (1, 4, 16, 64):
        assert t_tiling.class_caps(max_t) == class_caps(max_t)
    budgets = (5, 4, 3, 2, 1, 1, 1, 1)
    assert t_tiling.total_slots(100, 16, budgets) == total_slots(100, 16, budgets)
    assert t_tiling.total_slots(100, 16, None) == 1600
    m, c, _, o, _, r = screen_gaussians(rng, 50, 64, 48)
    np.testing.assert_array_equal(
        t_tiling.exact_tile_counts(m, r, 64, 48, 16, conics=c, opacities=o),
        exact_tile_counts(m, r, 64, 48, 16, conics=c, opacities=o))


@pytest.mark.parametrize("kw", [{"class_budgets": (8,) * 8}, {"depth_bits": 16},
                                {"sort_buckets": 4}, {"sort_bands": 2}])
def test_unported_binning_modes_raise(rng, kw):
    args = to_torch(*screen_gaussians(rng, 10, 32, 32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_tiling.isect_and_sort(*args, 32, 32, 16, 128, 16, **kw)


def test_pack_soa_checks_arguments():
    table = torch.zeros((10, 4))
    with pytest.raises(ValueError):
        t_tiling.pack_soa(table, torch.zeros(8, dtype=torch.int64), pad=0)
    with pytest.raises(ValueError):
        t_tiling.pack_soa(torch.zeros((9, 4)), torch.zeros(8, dtype=torch.int32), pad=0)
