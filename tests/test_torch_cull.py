"""PyTorch port, the raster kernels' warp cull (``csrc/raster_tiles.cuh``)
through its plain mirror ``rasterize_cuda.warp_cull_plain``: a warp skips an
entry only when no pixel of its 8x4 block could take it, so the skip leaves
the forward output unchanged. The CUDA kernels run only on a card
(``chip_smoke.py`` runs the same check on the bench scene and two views);
here the mirror, which does the kernels' float32 operations in their order,
is held on adversarial conics and on the small scenes of the parity tests."""

import numpy as np
import pytest
import torch

from gaussian_splatting_tpu_torch.ops import rasterize_cuda
from gaussian_splatting_tpu_torch.ops.rasterize_cuda import warp_cull_plain, warp_pixel_map
from torch_parity import screen_gaussians, to_torch

ALPHA_SKIP = np.float32(1.0 / 255.0)


@pytest.mark.parametrize("tile_size", [8, 16, 32])
def test_warp_pixel_map_is_8x4_blocks(tile_size):
    """Every pixel of the tile belongs to one lane; each warp's pixels are
    an 8-wide, 4-high block."""
    pix = warp_pixel_map(tile_size)
    assert pix.shape == (tile_size * tile_size // 32, 32)
    assert torch.equal(torch.sort(pix.flatten()).values, torch.arange(tile_size * tile_size))
    x, y = pix % tile_size, pix // tile_size
    assert ((x.amax(1) - x.amin(1)) == 7).all() and ((y.amax(1) - y.amin(1)) == 3).all()


def _conic(cov):
    inv = np.linalg.inv(cov)
    return np.stack([inv[..., 0, 0], inv[..., 0, 1], inv[..., 1, 1]], -1)


def _adversarial_entries(rng, n, tile_size, ntx, nty):
    """Entries around a ntx x nty tile image that stress the cull: regular,
    tiny and huge footprints, near-singular conics at any angle (large |cb|),
    opacities just above 1/255 and at 1, means placed so that an edge pixel
    centre sits at the gate boundary, and entries that must never be skipped
    (op below 1/255, indefinite or non-finite conics). Returns the (10, n)
    SoA rows 0..9 as float32 numpy, the (n,) tile of each entry and the
    (n,) mask of the entries that must never be skipped."""
    W, H = ntx * tile_size, nty * tile_size
    kind = rng.integers(0, 5, size=n)
    theta = rng.uniform(0, np.pi, size=n)
    s1 = np.exp(rng.uniform(np.log(0.3), np.log(60.0), size=n))
    ratio = np.where(kind == 1, np.exp(rng.uniform(np.log(1e2), np.log(1e4), size=n)),
                     np.exp(rng.uniform(0, np.log(4.0), size=n)))
    s2 = s1 / ratio
    c, s = np.cos(theta), np.sin(theta)
    R = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    var = np.stack([s1 ** 2, s2 ** 2], -1)[:, None, :]
    cov = R @ (np.eye(2)[None] * var) @ np.swapaxes(R, 1, 2)
    conics = _conic(cov)
    op = rng.choice([float(ALPHA_SKIP) * (1 + 1e-6), float(ALPHA_SKIP) * 1.01, 0.05, 0.5, 1.0],
                    size=n)
    means = rng.uniform([-2 * tile_size, -2 * tile_size], [W + 2 * tile_size, H + 2 * tile_size],
                        size=(n, 2))
    # Boundary entries: isotropic, the mean at the gate distance (+- a few
    # ulps) left of a pixel centre column, level with a pixel row.
    b = kind == 2
    c_iso = rng.uniform(0.01, 2.0, size=n)
    conics[b] = np.stack([c_iso, np.zeros(n), c_iso], -1)[b]
    d = np.sqrt(2.0 * np.log(255.0 * op) / c_iso) * (1.0 + rng.choice([-1e-6, 0.0, 1e-6], size=n))
    px = rng.integers(0, W, size=n) + 0.5
    py = rng.integers(0, H, size=n) + 0.5
    means[b] = np.stack([px - d, py], -1)[b]
    colors = rng.uniform(size=(n, 3))
    depths = rng.uniform(1.0, 10.0, size=n)
    soa = np.concatenate([means.T, conics.T, op[None], colors.T, depths[None]]).astype(np.float32)
    # Entries the cull must never skip.
    never = kind == 4
    sub = rng.integers(0, 4, size=n)
    soa[5, never & (sub == 0)] = float(ALPHA_SKIP) * 0.999
    soa[3, never & (sub == 1)] = 2.0 * np.sqrt(soa[2] * soa[4])[never & (sub == 1)]
    soa[0, never & (sub == 2)] = np.nan
    soa[4, never & (sub == 3)] = np.inf
    tile = rng.integers(0, ntx * nty, size=n)
    return soa, tile, never


def _segments(soa_rows, tile, n_tiles):
    """tile_starts, counts and a (16, M) SoA holding the entries grouped by
    tile (stable), rows 10 = 1 and 11 = entry index."""
    order = np.argsort(tile, kind="stable")
    counts = np.bincount(tile, minlength=n_tiles).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    soa = np.zeros((16, len(tile) + 8), np.float32)
    soa[:10, :len(tile)] = soa_rows[:, order]
    soa[10, :len(tile)] = 1.0
    soa[11, :len(tile)] = order
    return torch.as_tensor(starts), torch.as_tensor(counts), torch.as_tensor(soa), order


@pytest.mark.parametrize("seed,tile_size", [(0, 16), (1, 16), (2, 8), (3, 32), (4, 16)])
def test_warp_cull_never_skips_a_contributing_pixel(seed, tile_size):
    """Adversarial conics: no (warp, entry) pair that the mirror culls holds
    a pixel where the plain ``contrib`` is true; entries with op < 1/255,
    indefinite or non-finite conics are never culled; and the cull is not
    vacuous."""
    rng = np.random.default_rng(seed)
    ntx, nty = 3, 2
    rows, tile, never = _adversarial_entries(rng, 3000, tile_size, ntx, nty)
    starts, counts, soa, order = _segments(rows, tile, ntx * nty)
    keep, touched = warp_cull_plain(starts, counts, soa, tile_size, ntx)
    assert keep.shape == touched.shape == (tile_size * tile_size // 32, len(tile))
    assert int((touched & ~keep).sum()) == 0
    assert bool(keep[:, never[order]].all())
    assert int(touched.sum()) > 0
    assert 0.2 < float((~keep).float().mean()) < 1.0


@pytest.mark.parametrize("shape,tile_size,radius_scale", [
    ((64, 48), 16, 1.0), ((40, 24), 8, 1.0), ((72, 40), 32, 1.0), ((64, 48), 16, 20.0)])
def test_warp_cull_on_binned_scenes(rng, shape, tile_size, radius_scale):
    """On the parity tests' scenes, binned as the rasterizer bins them: the
    mirror culls a share of the (warp, entry) pairs and never one whose
    block holds a contributing pixel, so never a counted, contributing pair
    of the forward."""
    width, height = shape
    args = to_torch(*screen_gaussians(rng, 120, width, height, radius_scale=radius_scale))
    ntx = -(-width // tile_size)
    b = rasterize_cuda.isect_and_sort(*args, width, height, tile_size, 128, 16)
    keep, touched = warp_cull_plain(b.tile_starts, b.counts, b.sorted_soa, tile_size, ntx)
    assert keep.shape[1] == int(b.n_isect) > 0
    assert int((touched & ~keep).sum()) == 0
    assert float((~keep).float().mean()) > 0.0


def test_warp_cull_matches_plain_forward_pixels():
    """``touched`` is the plain forward's own contribution test: on one tile
    with one entry, the pixels the plain forward blends lie exactly in the
    warp blocks marked touched."""
    ts = 16
    soa = torch.zeros((16, 8))
    soa[:10, 0] = torch.tensor([5.3, 9.7, 0.08, 0.03, 0.5, 0.8, 1.0, 0.0, 0.0, 2.0])
    starts = torch.tensor([0, 1], dtype=torch.int32)
    counts = torch.tensor([1], dtype=torch.int32)
    out, _ = rasterize_cuda.fwd_tiles_plain(starts, counts, soa, ts, 1, 128)
    keep, touched = warp_cull_plain(starts, counts, soa, ts, 1)
    blended = out[0, 4] > 0                                  # (256,) sum_w
    pix = warp_pixel_map(ts)
    assert torch.equal(touched[:, 0], blended[pix].any(1))
    assert bool(keep[touched].all()) and not bool(keep.all())
