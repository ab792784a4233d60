"""PyTorch port, the gradient reduce: ``ops/segsum.py`` and ``pack_rows`` /
``reduce_padded_grads`` in ``ops/tiling.py`` against the JAX package's
(Pallas in interpret mode), on the CPU where the port runs the kernels'
plain versions.

Tolerances: ``pack_rows`` moves values and must be equal bit for bit. Sums
are taken in another order (the JAX segsum adds one-hot matrix products
window by window, the port differences float64 prefix sums), so they are
compared with allclose at the tolerance of ``tests/test_grad_reduce.py``
(atol 3e-6 times the column's absolute mass, rtol 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops.segsum import segment_sum_sorted as j_segsum
from gaussian_splatting_tpu.ops.tiling import pack_rows as j_pack_rows
from gaussian_splatting_tpu.ops.tiling import reduce_padded_grads as j_reduce
from gaussian_splatting_tpu_torch.ops import segsum as t_segsum
from gaussian_splatting_tpu_torch.ops import tiling as t_tiling

KEYS = t_tiling.GRAD_KEYS


def _grad_stream(rng, N, pcap, n_written):
    """A backward-kernel stream as ``tests/test_grad_reduce.py`` makes it:
    random ids, wide-magnitude gradients, NaN junk past ``n_written``."""
    grads = np.zeros((16, pcap), np.float32)
    mag = np.exp(rng.normal(size=(pcap,)) * 2).astype(np.float32)
    grads[1:11] = rng.normal(size=(10, pcap)).astype(np.float32) * mag
    grads[0] = rng.integers(0, N, size=(pcap,)).astype(np.float32)
    grads[1:11, n_written:] = np.nan
    grads[0, n_written:] = float(N + 11)
    return grads


def _sorted_buffer(rng, N, M, empty=()):
    """A gid-sorted (16, M) buffer with every id in ``empty`` absent and a
    sentinel tail (id N, zero payload)."""
    ids = np.sort(rng.choice(np.setdiff1d(np.arange(N), empty), size=M - 37))
    buf = np.zeros((16, M), np.float32)
    buf[0, :M - 37] = ids
    buf[0, M - 37:] = N
    buf[1:, :M - 37] = rng.normal(size=(15, M - 37))
    return buf


@pytest.mark.parametrize("M", [4096, 5000])
def test_segment_sum_sorted_matches_jax(rng, M):
    """Ragged M (the JAX wrapper pads it to its 256 window), empty segments
    and the sentinel tail."""
    N = 300
    empty = np.arange(0, N, 13)
    buf = _sorted_buffer(rng, N, M, empty)
    j_out = np.asarray(j_segsum(jnp.asarray(buf), N, interpret=True))
    t_out = t_segsum.segment_sum_sorted(torch.as_tensor(buf), N).numpy()
    assert t_out.shape == j_out.shape == (16, N)
    assert (t_out[:, empty] == 0).all()
    for r in range(1, 16):
        mass = np.abs(buf[r]).sum()
        np.testing.assert_allclose(t_out[r], j_out[r], atol=3e-6 * mass, rtol=1e-4)
    np.testing.assert_allclose(t_out[0], j_out[0], rtol=1e-6)  # g * count


def test_segment_sum_sorted_checks_arguments():
    with pytest.raises(ValueError):
        t_segsum.segment_sum_sorted(torch.zeros((15, 8)), 4)
    with pytest.raises(ValueError):
        t_segsum.segment_sum_sorted(torch.zeros((16, 8), dtype=torch.float64), 4)
    with pytest.raises(ValueError):
        t_segsum.segment_sum_sorted(torch.zeros((16, 8)), 1 << 24)


@pytest.mark.parametrize("n_rows", [10, 11])
def test_pack_rows_matches_jax_exactly(rng, n_rows):
    """The port sorts only the masked key and gathers the payloads through
    the permutation; JAX packs rows that are already permuted. Equal bit
    for bit, including the sentinel pad past M and the masked columns."""
    N, pcap, col0, m, n_written = 400, 12_000, 4000, 6000, 9000
    grads = _grad_stream(rng, N, pcap, n_written)
    src = torch.as_tensor(grads)
    n_valid = torch.tensor([n_written], dtype=torch.int32)
    key_sorted, perm = t_tiling.sorted_gid_key(src, N, n_valid, col0, m)
    assert (key_sorted[:-1] <= key_sorted[1:]).all() and int(key_sorted[-1]) == N
    t_out = t_tiling.pack_rows(src, perm, key_sorted, n_valid, col0, n_rows, float(N))

    p = perm.numpy()
    ok = (col0 + p) < n_written
    rows = [key_sorted.numpy().astype(np.float32)]
    rows += [np.where(ok, grads[r, col0 + p], 0.0).astype(np.float32)
             for r in range(1, n_rows)]
    j_out = np.asarray(j_pack_rows(tuple(jnp.asarray(r) for r in rows), float(N),
                                   interpret=True))
    assert tuple(t_out.shape) == j_out.shape == (16, 8192)
    np.testing.assert_array_equal(t_out.numpy(), j_out)
    assert (t_out[0, m:] == N).all() and np.isfinite(t_out.numpy()).all()


def test_pack_rows_checks_arguments():
    src = torch.zeros((16, 64))
    perm = torch.arange(32)
    key = torch.zeros(32, dtype=torch.int32)
    nv = torch.tensor([10], dtype=torch.int32)
    with pytest.raises(ValueError):
        t_tiling.pack_rows(src, perm.to(torch.int32), key, nv, 0, 10, 5.0)
    with pytest.raises(ValueError):
        t_tiling.pack_rows(src, perm, key, nv, 40, 10, 5.0)  # slice past the end
    with pytest.raises(ValueError):
        t_tiling.pack_rows(src, perm, key, nv, 0, 17, 5.0)


@pytest.mark.parametrize("slices,with_depth", [(0, True), (0, False), (4, True), (4, False)])
def test_reduce_padded_grads_matches_jax_and_direct_sum(rng, slices, with_depth):
    N, pcap, n_written = 800, 20_480, 17_000
    grads = _grad_stream(rng, N, pcap, n_written)
    t_out = t_tiling.reduce_padded_grads(torch.as_tensor(grads), N,
                                         torch.tensor(n_written, dtype=torch.int32),
                                         with_depth=with_depth, sort_slices=slices)
    j_out = j_reduce(jnp.asarray(grads), N, jnp.int32(n_written), interpret=True,
                     with_depth=with_depth, sort_slices=slices)
    ids = grads[0, :n_written].astype(int)
    for q, k in enumerate(KEYS):
        got = t_out[k].numpy()
        assert got.shape == (N,) and np.isfinite(got).all(), k
        if k == "ddepth" and not with_depth:
            assert (got == 0).all() and (np.asarray(j_out[k]) == 0).all()
            continue
        direct = np.zeros(N, np.float64)
        np.add.at(direct, ids, grads[1 + q, :n_written].astype(np.float64))
        mass = np.abs(grads[1 + q, :n_written]).sum()
        np.testing.assert_allclose(got, np.asarray(j_out[k]), atol=3e-6 * mass,
                                   rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(got, direct, atol=3e-6 * mass, rtol=1e-4, err_msg=k)


def test_reduce_empty_segments_and_unsliceable_cap():
    """Gaussians without entries get exactly zero; a K that does not divide
    the capacity falls back to one slice, as in JAX."""
    N, pcap = 100, 4096
    grads = np.zeros((16, pcap), np.float32)
    grads[0] = 7.0
    grads[1] = 1.0
    for K in (0, 7):
        out = t_tiling.reduce_padded_grads(torch.as_tensor(grads), N,
                                           torch.tensor(pcap, dtype=torch.int32),
                                           sort_slices=K)
        dmx = out["dmx"].numpy()
        assert dmx[7] == 4096.0 and (np.delete(dmx, 7) == 0).all()
