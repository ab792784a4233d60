"""PyTorch port, ``ops/tiling.py`` (dense binning, flat and through the
bucket partition, the chunk queue and the ``pack_soa`` kernel's plain
version) against the JAX ``isect_and_sort`` / ``chunk_queue`` /
``pack_soa`` on identical screen-space inputs. Integers and SoA columns
must be equal (the dense SoA below n_isect; it is zero past it)."""

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


def _pack_inputs(rng, N=37, M=300, pad=256):
    """(N, 10) records, (M,) gids and the JAX pack of the gathered rows."""
    records = rng.normal(size=(N, 10)).astype(np.float32)
    gid = rng.integers(0, N, size=M).astype(np.int32)
    rows = tuple(records[gid, i] for i in range(10)) + (gid.astype(np.float32),)
    return records, gid, np.asarray(j_pack_soa(to_jax(*rows), pad=pad, interpret=True))


def test_pack_soa_plain_matches_jax_pack(rng):
    """The kernel's plain version gathers the (N, 10) records through the
    slot index; JAX packs the already-gathered rows. Equal bit for bit, pad
    0."""
    records, gid, j_out = _pack_inputs(rng)
    t_out = t_tiling.pack_soa_plain(*to_torch(records, gid), pad=256)
    assert tuple(t_out.shape) == j_out.shape == (16, 8192)
    np.testing.assert_array_equal(t_out.numpy(), j_out)
    # The wrapper takes the plain version for CPU tensors.
    np.testing.assert_array_equal(t_tiling.pack_soa(*to_torch(records, gid), pad=256).numpy(),
                                  j_out)


@pytest.mark.parametrize("n_live", [0, 1, 173, 300, 9000])
def test_pack_soa_n_live_zeroes_the_tail(rng, n_live):
    """With ``n_live``, plain version and wrapper equal the JAX pack below
    it and are zero from it on (past M the pad is zero anyway); the shape
    does not change."""
    records, gid, j_out = _pack_inputs(rng)
    nl = torch.tensor([n_live], dtype=torch.int32)
    for fn in (t_tiling.pack_soa_plain, t_tiling.pack_soa):
        t_out = fn(*to_torch(records, gid), pad=256, n_live=nl).numpy()
        assert t_out.shape == j_out.shape
        np.testing.assert_array_equal(t_out[:, :n_live], j_out[:, :n_live])
        assert (t_out[:, n_live:] == 0).all()


def test_pack_soa_records_equal_the_row_table_gather(rng):
    """The (N, 10) record table from ``quantity_records`` gives the SoA the
    (10, N) row table gave: each row gathered on its own through gid."""
    m, c, col, o, d, _ = to_torch(*screen_gaussians(rng, 50, 64, 48))
    records = t_tiling.quantity_records(m, c, col, o, d)
    assert tuple(records.shape) == (50, 10) and records.is_contiguous()
    table = torch.stack([m[:, 0], m[:, 1], c[:, 0], c[:, 1], c[:, 2], o,
                         col[:, 0], col[:, 1], col[:, 2], d])
    gid = torch.as_tensor(rng.integers(0, 50, size=700).astype(np.int32))
    soa = t_tiling.pack_soa(records, gid, pad=256)
    want = torch.zeros_like(soa)
    want[:10, :700] = table[:, gid.long()]
    want[10, :700] = 1.0
    want[11, :700] = gid.to(torch.float32)
    assert torch.equal(soa, want)


@pytest.mark.parametrize("shape,n", [((64, 48), 150), ((40, 24), 80)])
def test_dense_soa_is_zero_past_n_isect(rng, shape, n):
    """The dense binning passes ``tile_starts[T]`` as ``n_live``: the SoA
    holds the JAX package's columns below n_isect and zeros from it on,
    where JAX keeps the sentinel slots' rows that no kernel reads."""
    width, height = shape
    jb, tb = _both(screen_gaussians(rng, n, width, height), width, height)
    _assert_same_binning(jb, tb)
    n_isect = int(tb.n_isect)
    assert int(tb.tile_starts[-1]) == n_isect > 0
    assert (tb.sorted_soa[:, n_isect:] == 0).all()
    assert (np.asarray(jb.sorted_soa)[10, n_isect:t_tiling.total_slots(n, 16, None)] == 1).all()


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


def _assert_same_bucket_binning(jb, tb):
    """Tables, counters and every segment of the SoA equal. The layout has
    pad columns between segments (JAX: zeros; the port: gaussian 0's rows,
    gathered through gid 0), which the kernels never read."""
    np.testing.assert_array_equal(tb.tile_starts.numpy(), np.asarray(jb.tile_starts))
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
    for k in ("n_isect", "n_dropped", "n_budget_dropped", "n_bucket_dropped"):
        assert int(getattr(tb, k)) == int(getattr(jb, k)), k
    j_soa, t_soa = np.asarray(jb.sorted_soa), tb.sorted_soa.numpy()
    assert t_soa.shape == j_soa.shape
    starts, counts = tb.tile_starts.numpy(), tb.counts.numpy()
    cols = np.concatenate([np.arange(s, s + c) for s, c in zip(starts[:-1], counts)])
    assert len(cols) == int(tb.n_isect)
    np.testing.assert_array_equal(t_soa[:12, cols], j_soa[:12, cols])


@pytest.mark.parametrize("buckets", [2, 4])
def test_bucket_binning_matches_jax(rng, buckets):
    """``sort_buckets``: partition by tile % B, one batched sort: the JAX
    package's segment tables, counters and segments; the starts jump
    between buckets and tile_starts[T] = B * cap lies past every segment.
    Each tile's order is the dense path's."""
    width, height = 64, 48
    args = screen_gaussians(rng, 150, width, height)
    jb = j_isect(*to_jax(*args), width, height, 16, 128, 16, sort_buckets=buckets,
                 interpret=True)
    tb = t_tiling.isect_and_sort(*to_torch(*args), width, height, 16, 128, 16,
                                 sort_buckets=buckets)
    _assert_same_bucket_binning(jb, tb)
    assert int(tb.n_bucket_dropped) == 0
    starts, counts = tb.tile_starts.numpy(), tb.counts.numpy()
    assert starts[-1] > (starts[:-1] + counts).max()
    assert (np.diff(starts[:-1]) < 0).any()
    dense = t_tiling.isect_and_sort(*to_torch(*args), width, height, 16, 128, 16)
    np.testing.assert_array_equal(counts, dense.counts.numpy())
    for t in np.nonzero(counts)[0]:
        s, d, c = starts[t], int(dense.tile_starts[t]), counts[t]
        assert torch.equal(tb.sorted_soa[:12, s:s + c], dense.sorted_soa[:12, d:d + c])


def test_bucket_overflow_counted_matches_jax(rng):
    """Starved buckets (headroom 0.05, tests/test_rasterize_pallas.py:269):
    the drops are counted as the JAX package counts them and left out of
    n_isect; kept + dropped is the dense count."""
    width, height = 64, 48
    args = screen_gaussians(rng, 400, width, height, radius_scale=2.0,
                            opacity_range=(0.05, 0.3))
    jb = j_isect(*to_jax(*args), width, height, 16, 128, 16, sort_buckets=2,
                 bucket_headroom=0.05, interpret=True)
    tb = t_tiling.isect_and_sort(*to_torch(*args), width, height, 16, 128, 16,
                                 sort_buckets=2, bucket_headroom=0.05)
    _assert_same_bucket_binning(jb, tb)
    dense = t_tiling.isect_and_sort(*to_torch(*args), width, height, 16, 128, 16)
    assert int(tb.n_bucket_dropped) > 0
    assert int(tb.n_isect) + int(tb.n_bucket_dropped) == int(dense.n_isect)


def test_bucket_binning_more_buckets_than_lanes_matches_jax(rng):
    """``sort_buckets=64``, more buckets than a warp has lanes (the port's
    former limit, still the narrow kernel's): at the default headroom 1.5
    a 512-slot chunk keeps 12 slots a bucket, so the busiest buckets
    overflow. Tables, counters (1,230 entries kept, 6 dropped) and
    segments equal the JAX package's; kept + dropped is the dense count."""
    width, height = 256, 192
    args = screen_gaussians(rng, 400, width, height)
    jb = j_isect(*to_jax(*args), width, height, 16, 128, 16, sort_buckets=64,
                 interpret=True)
    tb = t_tiling.isect_and_sort(*to_torch(*args), width, height, 16, 128, 16,
                                 sort_buckets=64)
    _assert_same_bucket_binning(jb, tb)
    assert (int(tb.n_isect), int(tb.n_bucket_dropped)) == (1230, 6)
    dense = t_tiling.isect_and_sort(*to_torch(*args), width, height, 16, 128, 16)
    assert int(tb.n_isect) + int(tb.n_bucket_dropped) == int(dense.n_isect)


@pytest.mark.parametrize("buckets", [256, 2048])
def test_bucket_binning_up_to_2048_buckets(rng, buckets):
    """The bucket binning at B = 256 (quantum 3) and B = 2048 (quantum 1,
    the largest B that the JAX package takes at headroom 1.5: B q = 4C)
    with a headroom that keeps every slot: every tile's segment equals the
    dense binning's, and tile_starts[T] = B * cap lies past them all."""
    width, height = 256, 192
    args = screen_gaussians(rng, 400, width, height)
    headroom = 4.0 if buckets == 256 else 1.5
    tb = t_tiling.isect_and_sort(*to_torch(*args), width, height, 16, 128, 16,
                                 sort_buckets=buckets, bucket_headroom=headroom)
    dense = t_tiling.isect_and_sort(*to_torch(*args), width, height, 16, 128, 16)
    starts, counts = tb.tile_starts.numpy(), tb.counts.numpy()
    kept = int(tb.n_isect) + int(tb.n_bucket_dropped)
    assert kept == int(dense.n_isect) and int(counts.sum()) == int(tb.n_isect)
    if buckets == 256:
        assert int(tb.n_bucket_dropped) == 0
        np.testing.assert_array_equal(counts, dense.counts.numpy())
    assert starts[-1] > (starts[:-1] + counts).max()
    for t in np.nonzero(counts)[0]:
        s, d, c = starts[t], int(dense.tile_starts[t]), counts[t]
        if buckets == 256:
            assert torch.equal(tb.sorted_soa[:12, s:s + c], dense.sorted_soa[:12, d:d + c])
        else:  # a tile keeps a stable subsequence of its dense segment
            seg = dense.sorted_soa[11, d:d + int(dense.counts[t])].tolist()
            got = tb.sorted_soa[11, s:s + c].tolist()
            it = iter(seg)
            assert all(g in it for g in got)


@pytest.mark.parametrize("counts,w_cap", [([300, 0, 256, 1, 0], 8), ([0, 0, 0], 4),
                                          ([513, 7, 0, 256, 255], 12)])
def test_chunk_queue_matches_jax(counts, w_cap):
    """The flat chunk queue (tests/test_rasterize_pallas.py:628 and one
    more): tile-major items, empty tiles skipped, the pad tail clamped."""
    from gaussian_splatting_tpu.ops.tiling import chunk_queue as j_chunk_queue

    c = np.asarray(counts, np.int32)
    jq = j_chunk_queue(to_jax(c)[0], 256, w_cap)
    tq = t_tiling.chunk_queue(to_torch(c)[0], 256, w_cap)
    for j, t in zip(jq, tq):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_pack_soa_checks_arguments():
    records = torch.zeros((4, 10))
    with pytest.raises(ValueError):
        t_tiling.pack_soa(records, torch.zeros(8, dtype=torch.int64), pad=0)
    with pytest.raises(ValueError):
        t_tiling.pack_soa(torch.zeros((10, 4)), torch.zeros(8, dtype=torch.int32), pad=0)


@pytest.mark.parametrize("n_live", [torch.tensor([3], dtype=torch.int64),
                                    torch.tensor([3.0]),
                                    torch.tensor([3, 4], dtype=torch.int32),
                                    torch.zeros((0,), dtype=torch.int32),
                                    torch.tensor([3], dtype=torch.int32, device="meta")])
def test_pack_soa_refuses_bad_n_live(n_live):
    """``n_live`` must be one int32 element on gid's device."""
    with pytest.raises(ValueError, match="n_live"):
        t_tiling.pack_soa(torch.zeros((4, 10)), torch.zeros(8, dtype=torch.int32), pad=0,
                          n_live=n_live)
