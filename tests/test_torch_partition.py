"""PyTorch port, ``ops/partition.py`` (the bucket partition, CUDA kernel
8's plain version on the CPU) against the JAX ``partition_soa`` in
interpret mode, on the cases of ``tests/test_partition.py``. The partition
moves values, so ``out``, ``counts`` and ``drops`` must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops.partition import partition_soa as j_partition
from gaussian_splatting_tpu.ops.partition import quantum_for as j_quantum_for
from gaussian_splatting_tpu_torch.ops.partition import partition_soa, quantum_for


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
