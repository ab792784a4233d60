"""PyTorch port, ``ops/partition.py`` against the JAX ``partition_soa`` in
interpret mode: the general (16, M) contract on the cases of
``tests/test_partition.py``, and the bucket binning's fused partition
(``bucket_partition``, CUDA kernel 8's plain version on the CPU) against the
JAX package's ``pack_rows`` + ``partition_soa`` of the binning's input. The
partition moves values, so every output must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops.partition import partition_soa as j_partition
from gaussian_splatting_tpu.ops.partition import quantum_for as j_quantum_for
from gaussian_splatting_tpu.ops.tiling import pack_rows as j_pack_rows
from gaussian_splatting_tpu_torch.ops.partition import (
    bucket_partition, bucket_partition_plain, partition_soa, quantum_for)
from gaussian_splatting_tpu_torch.ops.tiling import binning_slots
from test_partition import _np_qpartition
from torch_parity import screen_gaussians, to_torch


def _keys_uniform(rng, M):
    return rng.integers(0, 997, size=M)


def _keys_geometric(rng, M):
    return np.minimum(rng.geometric(0.5, size=M) - 1, 500)


def _keys_tile_sub(rng, M):
    return rng.integers(0, 32, size=M) << 4 | rng.integers(0, 16, size=M)


# (M, B, q, C, keys, kwargs): tests/test_partition.py:64-125.
CASES = {
    "balanced": (1024, 4, 64, 128, _keys_uniform, {"sentinel": 997.0}),
    "overflow_counted": (1024, 8, 16, 128, _keys_geometric, {"sentinel": 1000.0}),
    "filters_and_per_bucket_sentinels": (
        1024, 8, 32, 128, _keys_uniform,
        {"sentinel": tuple(10_000.0 + k for k in range(8)), "n_valid": 900,
         "drop_key_above": 700.0}),
    "bucket_shift": (512, 4, 64, 128, _keys_tile_sub, {"sentinel": 1e9, "bucket_shift": 4}),
    # More buckets than a warp has lanes, at the bucket binning's C and
    # default headroom (quantum 12).
    "B64": (2048, 64, 12, 512, _keys_uniform, {"sentinel": 997.0}),
}


def _both(x, B, q, C, **kw):
    nv = kw.pop("n_valid", None)
    j = j_partition(jnp.asarray(x), B, q, key_row=0, C=C, n_valid=nv, interpret=True, **kw)
    t = partition_soa(torch.as_tensor(x), B, q, key_row=0, C=C,
                      n_valid=None if nv is None else torch.tensor([nv], dtype=torch.int32),
                      **kw)
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


@pytest.mark.parametrize("case", sorted(CASES))
def test_partition_matches_jax_exactly(rng, case):
    M, B, q, C, keys, kw = CASES[case]
    x = rng.normal(size=(16, M)).astype(np.float32)
    x[0] = keys(rng, M).astype(np.float32)
    (jo, jc, jd), (to, tc, td) = _both(x, B, q, C, **kw)
    assert to.shape == jo.shape == (16, B, (M // C) * q)
    assert tc.dtype == td.dtype == np.int32
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(to, jo)
    if case == "overflow_counted":
        assert td.sum() > 0


@pytest.mark.parametrize("B", [256, 2048])
def test_partition_up_to_2048_buckets_matches_jax_reference(rng, B):
    """B = 256 (quantum 3) and B = 2048 (quantum 1, B q = 4C, the largest
    the JAX package takes at C = 512 and headroom 1.5), with overflow,
    against the reference the JAX partition kernel is held to
    (``tests/test_partition.py::_np_qpartition``). The JAX kernel itself
    unrolls a loop over the buckets: in interpret mode it compiled for 8
    minutes at B = 2048 on the CPU, so it is compared at B = 64 above."""
    M, C = 2048, 512
    q = quantum_for(C, B, 1.5)
    x = rng.normal(size=(16, M)).astype(np.float32)
    x[0] = rng.integers(0, 5000, size=M).astype(np.float32)
    out, counts, drops = partition_soa(torch.as_tensor(x), B, q, key_row=0, sentinel=5000.0,
                                       C=C)
    ref = _np_qpartition(x, B, q, C, 0, (5000.0,) * B)
    np.testing.assert_array_equal(out.numpy(), ref[0])
    np.testing.assert_array_equal(counts.numpy(), ref[1])
    np.testing.assert_array_equal(drops.numpy(), ref[2])
    assert int(drops.sum()) > 0


def test_partition_then_batched_sort_matches_flat_sort(rng):
    """Partition by key modulo B, one stable sort per bucket, de-interleave:
    the flat sort (tests/test_partition.py:125), on the port's output."""
    M, B, C = 2048, 4, 128
    keys = rng.permutation(M).astype(np.float32)
    x = rng.normal(size=(16, M)).astype(np.float32)
    x[0] = keys
    out, counts, drops = partition_soa(torch.as_tensor(x), B, 2 * (C // B), key_row=0,
                                       sentinel=float(M), C=C)
    assert int(drops.sum()) == 0 and int(counts.sum()) == M
    order = torch.sort(out[0], dim=1, stable=True).indices
    srt = torch.gather(out, 2, order[None].expand(16, -1, -1)).numpy()
    got = np.concatenate([srt[:15, k, :int(counts[k])] for k in range(B)], axis=1)
    want = x[:15][:, np.argsort(keys)]
    np.testing.assert_array_equal(got[:, np.argsort(got[0], kind="stable")], want)


def test_quantum_for_matches_jax():
    for C, B, h in ((512, 8, 1.5), (512, 8, 1.15), (256, 8, 1.5), (512, 16, 1.5),
                    (512, 8, 1.3), (256, 8, 2.0), (128, 4, 1.5), (512, 2, 0.05)):
        assert quantum_for(C, B, h) == j_quantum_for(C, B, h)
    assert quantum_for(512, 8, 1.5) == 96


def test_partition_checks_arguments():
    x = torch.zeros((16, 1024))
    with pytest.raises(ValueError):
        partition_soa(x.double(), 4, 64, sentinel=0.0, C=128)
    with pytest.raises(ValueError):
        partition_soa(x, 3, 64, sentinel=0.0, C=128)        # B not a power of two
    with pytest.raises(ValueError):
        partition_soa(x, 4, 64, key_row=15, sentinel=0.0, C=128)
    with pytest.raises(ValueError):
        partition_soa(x, 4, 64, sentinel=0.0, C=128, bucket_shift=32)
    with pytest.raises(ValueError):
        partition_soa(torch.zeros((16, 1000)), 4, 64, sentinel=0.0, C=128)  # M % C
    with pytest.raises(ValueError):
        partition_soa(x, 4, 20, sentinel=0.0, C=128)        # B q not lane-aligned
    with pytest.raises(ValueError):
        partition_soa(x, 4, 256, sentinel=0.0, C=128)       # headroom above 4
    with pytest.raises(ValueError):
        partition_soa(x, 4, 64, sentinel=(0.0, 1.0), C=128)  # one sentinel per bucket
    with pytest.raises(ValueError):
        partition_soa(x, 4, 64, sentinel=0.0, C=128, n_valid=torch.tensor([5]))


def test_partition_soa_refuses_other_devices():
    """The general contract is the plain reference: CPU tensors only; the
    card's partition is ``bucket_partition``."""
    x = torch.zeros((16, 1024), device="meta")
    with pytest.raises(ValueError, match="bucket_partition"):
        partition_soa(x, 4, 64, sentinel=0.0, C=128)


def _order_bits(x):
    b = x.astype(np.float32).view(np.int32).astype(np.int64)
    return np.where(b >= 0, b + (1 << 31), (~b) & 0xFFFFFFFF)


# (sort_buckets, headroom, scene kwargs): the default headroom at three
# bucket counts, and starved buckets (tests/test_rasterize_pallas.py:269).
BUCKET_CASES = {
    "B2": (2, 1.5, {}),
    "B4": (4, 1.5, {}),
    "B8": (8, 1.5, {}),
    "B64": (64, 1.5, {"n": 400, "width": 256, "height": 192}),
    "B2_starved": (2, 0.05, {"n": 400, "radius_scale": 2.0, "opacity_range": (0.05, 0.3)}),
}


@pytest.mark.parametrize("case", sorted(BUCKET_CASES))
def test_bucket_partition_matches_jax(rng, case):
    """The fused partition of a scene's dense slots against the JAX bucket
    binning's own input (``pack_rows`` of the tile, the depth, nine
    quantities and the gid of each slot, ``tiling.py:806-812``) through the
    JAX ``partition_soa``: key = (row 0 << 32) | order bits of row 1 and gid
    = row 11 where row 15 marks a kept column, T << 32 and 0 on the pads;
    counts and drops equal."""
    B, headroom, kw = BUCKET_CASES[case]
    kw = dict(kw)
    width, height, max_t = kw.pop("width", 64), kw.pop("height", 48), 16
    n = kw.pop("n", 150)
    m2, c, col, o, d, r = screen_gaussians(rng, n, width, height, **kw)
    tm, tc, to_, tr = to_torch(m2, c, o, r)
    tile_key, _, _, _, T = binning_slots(tm, tc, to_, tr, width, height, 16, max_t)
    q = quantum_for(512, B, headroom)

    g = np.arange(tile_key.shape[0]) % n
    quantities = (d, m2[:, 0], m2[:, 1], c[:, 0], c[:, 1], c[:, 2], o, col[:, 0], col[:, 1],
                  col[:, 2], np.arange(n))
    rows = (tile_key.numpy().astype(np.float32),) + tuple(
        np.asarray(v, np.float32)[g] for v in quantities)
    packed = j_pack_rows(tuple(jnp.asarray(x) for x in rows), sentinel=float(T), interpret=True)
    jo, jc, jd = (np.asarray(a) for a in j_partition(
        packed, B, q, key_row=0, sentinel=float(T), drop_key_above=float(T), C=512,
        interpret=True))

    depths = torch.as_tensor(d)
    key, gid, counts, drops = bucket_partition(tile_key, depths, T, B, q)
    cap = (packed.shape[1] // 512) * q
    assert tuple(key.shape) == tuple(gid.shape) == (B, cap)
    assert key.dtype == torch.int64 and gid.dtype == counts.dtype == drops.dtype == torch.int32
    valid = jo[15] == 1
    want_key = np.where(valid, (jo[0].astype(np.int64) << 32) | _order_bits(jo[1]), T << 32)
    np.testing.assert_array_equal(key.numpy(), want_key)
    np.testing.assert_array_equal(gid.numpy(), np.where(valid, jo[11].astype(np.int32), 0))
    np.testing.assert_array_equal(counts.numpy(), jc)
    np.testing.assert_array_equal(drops.numpy(), jd)
    assert int(counts.sum()) + int(drops.sum()) == int((tile_key < T).sum())
    if case in ("B2_starved", "B64"):
        assert int(drops.sum()) > 0
    for a, b in zip((key, gid, counts, drops),
                    bucket_partition_plain(tile_key, depths, T, B, q)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B", [256, 2048])
def test_bucket_partition_up_to_2048_buckets(rng, B):
    """The fused partition at B = 256 and 2048 against the general
    contract on the bucket binning's input (the JAX package's ``pack_rows``
    of the slots' tile, depth and gid, as in ``test_bucket_partition_matches_jax``)
    through ``_np_qpartition``, the JAX partition kernel's reference."""
    width, height, n = 256, 192, 400
    m2, c, _, o, d, r = screen_gaussians(rng, n, width, height)
    tm, tc, to_, tr = to_torch(m2, c, o, r)
    tile_key, _, _, _, T = binning_slots(tm, tc, to_, tr, width, height, 16, 16)
    q = quantum_for(512, B, 1.5)
    g = np.arange(tile_key.shape[0]) % n
    rows = (tile_key.numpy().astype(np.float32), d[g]) + (np.zeros_like(d[g]),) * 9 + (
        np.arange(n, dtype=np.float32)[g],)
    packed = np.asarray(j_pack_rows(tuple(jnp.asarray(x) for x in rows), sentinel=float(T),
                                    interpret=True))
    ro, rc, rd = _np_qpartition(packed, B, q, 512, 0, (float(T),) * B,
                                drop_key_above=float(T))
    key, gid, counts, drops = bucket_partition(tile_key, torch.as_tensor(d), T, B, q)
    valid = ro[15] == 1
    want_key = np.where(valid, (ro[0].astype(np.int64) << 32) | _order_bits(ro[1]), T << 32)
    np.testing.assert_array_equal(key.numpy(), want_key)
    np.testing.assert_array_equal(gid.numpy(), np.where(valid, ro[11].astype(np.int32), 0))
    np.testing.assert_array_equal(counts.numpy(), rc)
    np.testing.assert_array_equal(drops.numpy(), rd)
    assert int(counts.sum()) + int(drops.sum()) == int((tile_key < T).sum())


def test_bucket_partition_checks_arguments():
    tile = torch.zeros(1024, dtype=torch.int32)
    depths = torch.ones(64)
    with pytest.raises(ValueError):
        bucket_partition(tile.long(), depths, 10, 4, 64)           # tiles not int32
    with pytest.raises(ValueError):
        bucket_partition(tile, depths.double(), 10, 4, 64)         # depths not float32
    with pytest.raises(ValueError):
        bucket_partition(tile, depths[:0], 10, 4, 64)              # no gaussian
    with pytest.raises(ValueError):
        bucket_partition(tile, depths, 0, 4, 64)                   # T not positive
    with pytest.raises(ValueError):
        bucket_partition(tile, depths, 10, 3, 64)                  # B not a power of two
    with pytest.raises(ValueError):
        bucket_partition(tile, depths, 10, 4096, 1)                # B q above 4C
    with pytest.raises(ValueError):
        bucket_partition(tile, depths, 10, 32, 128, C=1024)        # stages above 227 KB
    with pytest.raises(ValueError):
        bucket_partition(tile, depths, 10, 4, 64, C=384)           # C does not divide 8192
    with pytest.raises(ValueError):
        bucket_partition(tile, depths, 10, 4, 20)                  # B q not lane-aligned
    with pytest.raises(ValueError):
        bucket_partition(tile, depths, 10, 4, 1024)                # headroom above 4
    with pytest.raises(ValueError):
        bucket_partition(tile[::2], depths, 10, 4, 64)             # not contiguous
    with pytest.raises(ValueError):
        bucket_partition(tile, depths.to("meta"), 10, 4, 64)       # two devices
    with pytest.raises(ValueError, match="CUDA or CPU"):
        bucket_partition(tile.to("meta"), depths.to("meta"), 10, 4, 64)
