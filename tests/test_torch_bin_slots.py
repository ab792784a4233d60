"""``ops/tiling.bin_slots``, the binning's slot enumeration: its argument
checks, the plain version that CPU tensors take, and on a CUDA card the
kernel pair of ``csrc/bin_slots.cu`` bit for bit against that plain version
run on the card, through every layout and mode of ``isect_and_sort``.

The card test is marked ``chip`` and skips without a card; this file
imports no JAX, so it runs on the card with ``python -m pytest
tests/test_torch_bin_slots.py -m chip --noconftest``."""

import numpy as np
import pytest
import torch

from gaussian_splatting_tpu_torch.ops import tiling
from gaussian_splatting_tpu_torch.utils import profiling

W, H, TS = 512, 384, 16


def scene(seed, n, width=W, height=H, device="cpu"):
    """Seeded screen-space gaussians ``(means2d, conics, opacities, radii,
    depths)`` with the cases the binning must not mistake: degenerate,
    indefinite and near-singular conics, zero radii, opacities under the
    1/255 cull, footprints over the image's edges, and equal depths."""
    rng = np.random.default_rng(seed)
    m = rng.uniform([-40, -40], [width + 40, height + 40], size=(n, 2))
    s1, s2 = rng.uniform(0.5, 30, n), rng.uniform(0.5, 30, n)
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    con = np.stack([c * c / s1 ** 2 + s * s / s2 ** 2, c * s * (1 / s1 ** 2 - 1 / s2 ** 2),
                    s * s / s1 ** 2 + c * c / s2 ** 2], 1).astype(np.float32)
    k = n // 10
    con[:k, 0] = 0.0                                  # ca 0
    con[k:2 * k, 2] = -1e-3                           # indefinite
    con[2 * k:3 * k] = (1e-9, 0.0, 1e-9)              # a footprint over the whole image
    con[3 * k:4 * k, 1] = np.sqrt(con[3 * k:4 * k, 0] * con[3 * k:4 * k, 2])  # singular
    op = rng.uniform(0.0, 1.0, n)
    op[4 * k:5 * k] = rng.uniform(0, 2.0 / 255, k)    # around the cull
    rad = (np.ceil(3 * np.maximum(s1, s2)) * rng.integers(1, 3, n)).astype(np.int32)
    rad[5 * k:5 * k + k // 2] = 0
    depth = rng.uniform(0.1, 10, n)
    depth[:k // 2] = depth[k // 2]                    # ties
    arrays = (m.astype(np.float32), con, op.astype(np.float32), rad, depth.astype(np.float32))
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def class_budgets(geo, max_t, frac, width=W, height=H):
    """Budgets at ``frac`` of each footprint class's population."""
    *_, n_capped = tiling._tile_rects(geo[0], geo[1], geo[2], geo[3], width, height, TS, max_t)
    caps = torch.tensor(tiling.class_caps(max_t), device=n_capped.device)
    cls = torch.sum(n_capped[:, None] > caps[None, :], 1)
    cls = torch.where(n_capped > 0, cls, len(caps))
    counts = torch.bincount(cls, minlength=len(caps) + 1)[:len(caps)]
    return tuple(int(c * frac) for c in counts.cpu())


def _launches():
    return profiling.counters().get("launch.bin_slots", 0)


# --- argument checks (CPU) ---


def _bad(geo, i, x):
    return tuple(x if j == i else g for j, g in enumerate(geo))


@pytest.mark.parametrize("case", [
    "means2d_dtype", "conics_shape", "opacities_dtype", "radii_dtype", "depths_shape",
    "device", "contiguous"])
def test_bin_slots_checks_arguments(case):
    geo = scene(0, 40)
    bad = {
        "means2d_dtype": _bad(geo, 0, geo[0].double()),
        "conics_shape": _bad(geo, 1, geo[1][:, :2].contiguous()),
        "opacities_dtype": _bad(geo, 2, geo[2].half()),
        "radii_dtype": _bad(geo, 3, geo[3].long()),
        "depths_shape": _bad(geo, 4, geo[4][:-1]),
        "device": _bad(geo, 4, geo[4].to("meta")),
        "contiguous": _bad(geo, 1, torch.cat([geo[1], geo[1]], 1)[:, ::2]),
    }[case]
    with pytest.raises(ValueError):
        tiling.bin_slots(*bad, W, H, TS, 16)


def test_bin_slots_refuses_too_many_gaussians():
    """Gaussian ids travel as float32 in the SoA: N < 2^24 (meta tensors,
    no memory)."""
    n = 1 << 24
    geo = tuple(torch.empty(s, dtype=d, device="meta") for s, d in (
        ((n, 2), torch.float32), ((n, 3), torch.float32), ((n,), torch.float32),
        ((n,), torch.int32), ((n,), torch.float32)))
    with pytest.raises(ValueError, match="2\\^24"):
        tiling.bin_slots(*geo, W, H, TS, 16)


@pytest.mark.parametrize("depth_bits,ok", [(0, True), (15, True), (16, False), (20, False)])
def test_bin_slots_int32_key_guard(depth_bits, ok):
    """The int32 key ``tile * 2^b + qd`` needs (T + 1) < 2^(31 - b): a
    256 x 128 tile grid (T = 32,768) takes 15 bits and refuses 16."""
    geo = scene(1, 40)
    if ok:
        tiling.bin_slots(*geo, 4096, 2048, TS, 16, depth_bits=depth_bits)
    else:
        with pytest.raises(ValueError, match="too large"):
            tiling.bin_slots(*geo, 4096, 2048, TS, 16, depth_bits=depth_bits)


@pytest.mark.parametrize("budgets", [(4,) * 7, (4,) * 7 + (-1,)])
def test_bin_slots_checks_budgets(budgets):
    with pytest.raises(ValueError, match="budgets"):
        tiling.bin_slots(*scene(2, 40), W, H, TS, 16, class_budgets=budgets)


def test_bin_slots_refuses_other_devices():
    geo = tuple(g.to("meta") for g in scene(3, 40))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tiling.bin_slots(*geo, W, H, TS, 16)


# --- the plain path (CPU) ---


@pytest.mark.parametrize("layout", ["dense", "compact"])
@pytest.mark.parametrize("depth_bits", [None, 0])
def test_cpu_tensors_take_the_plain_path(layout, depth_bits):
    """CPU tensors run ``bin_slots_plain`` and launch nothing: the key is
    the exact key of ``slot_sort_key`` (or the tile of ``binning_slots``),
    and the counters are those of the binning's slots."""
    geo = scene(4, 600)
    budgets = class_budgets(geo, 16, 0.7) if layout == "compact" else None
    before = _launches()
    sl = tiling.bin_slots(*geo, W, H, TS, 16, budgets, depth_bits=depth_bits)
    assert _launches() == before
    tile_key, slot_gid, n_dropped, n_budget_dropped, T = tiling.binning_slots(
        geo[0], geo[1], geo[2], geo[3], W, H, TS, 16, budgets)
    key = tile_key if depth_bits is not None else tiling.slot_sort_key(
        tile_key, geo[4], T, slot_gid)[0]
    assert torch.equal(sl.key, key) and sl.T == T
    assert (sl.slot_gid is None) == (layout == "dense")
    if slot_gid is not None:
        assert torch.equal(sl.slot_gid, slot_gid)
    assert int(sl.n_isect) == int(torch.sum(tile_key < T)) > 0
    assert int(sl.n_dropped) == int(n_dropped) > 0
    assert int(sl.n_budget_dropped) == int(n_budget_dropped)
    assert (int(n_budget_dropped) > 0) == (layout == "compact")


@pytest.mark.parametrize("mode", [{}, {"depth_bits": 16}, {"sort_bands": 3}])
def test_isect_and_sort_sorts_the_slots_keys(mode):
    """``isect_and_sort`` on the compact layout equals the chain it is made
    of: ``binning_slots``, ``slot_sort_key`` and one stable sort, band by
    band with ``sort_bands``."""
    geo = scene(5, 600)
    means2d, conics, opac, radii, depths = geo
    colors = torch.rand((600, 3), generator=torch.Generator().manual_seed(0))
    budgets = class_budgets(geo, 16, 0.8)
    b = tiling.isect_and_sort(means2d, conics, colors, opac, depths, radii, W, H, TS, 128, 16,
                              class_budgets=budgets, **mode)
    K = mode.get("sort_bands", 1)
    ntx, nty = W // TS, H // TS
    band_h = -(-nty // K)
    gids, n_isect = [], 0
    for k in range(K):
        lo, hi = k * band_h, min((k + 1) * band_h, nty)
        tile_key, slot_gid, _, _, T = tiling.binning_slots(
            means2d, conics, opac, radii, W, H, TS, 16, budgets, row_lo=lo, row_hi=hi)
        key, _ = tiling.slot_sort_key(tile_key, depths, T, slot_gid, mode.get("depth_bits", 0))
        gids.append(slot_gid[torch.sort(key, stable=True)[1]])
        n_isect += int(torch.sum(tile_key < T))
    assert int(b.n_isect) == n_isect
    live = int(b.n_isect) if K == 1 else b.tile_starts[-1]
    assert torch.equal(b.sorted_soa[11, :live], torch.cat(gids)[:live].float())


# --- the kernel pair (CUDA card) ---


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


CARD_MODES = [
    ("dense", None, {}), ("compact", 0.8, {}), ("compact_tight", 0.4, {}),
    ("dense_bands2", None, {"sort_bands": 2}), ("compact_bands3", 0.8, {"sort_bands": 3}),
    ("dense_buckets8", None, {"sort_buckets": 8}),
    ("compact_buckets64", 0.8, {"sort_buckets": 64}),
    ("dense_depth16", None, {"depth_bits": 16}), ("compact_depth16", 0.8, {"depth_bits": 16}),
]


@pytest.mark.chip
@pytest.mark.parametrize("name,frac,mode", CARD_MODES, ids=[m[0] for m in CARD_MODES])
def test_kernel_pair_equals_plain_on_the_card(cuda_device, monkeypatch, name, frac, mode):
    """Keys, gids, tile_starts, counts, SoA and the three counters of the
    kernel pair equal those of the plain code on the card bit for bit, and
    the pair launches once a view (once a band)."""
    geo = scene(6, 20_000, device=cuda_device)
    means2d, conics, opac, radii, depths = geo
    colors = torch.rand((20_000, 3), device=cuda_device)
    budgets = None if frac is None else class_budgets(geo, 16, frac)
    for depth_bits in (None, 0):
        k = tiling.bin_slots(*geo, W, H, TS, 16, budgets, depth_bits=depth_bits)
        p = tiling.bin_slots_plain(*geo, W, H, TS, 16, budgets, depth_bits=depth_bits)
        assert torch.equal(k.key, p.key)
        assert (k.slot_gid is None) == (p.slot_gid is None)
        assert k.slot_gid is None or torch.equal(k.slot_gid, p.slot_gid)
        for f in ("n_isect", "n_dropped", "n_budget_dropped"):
            assert int(getattr(k, f)) == int(getattr(p, f)), f

    def binned():
        return tiling.isect_and_sort(means2d, conics, colors, opac, depths, radii, W, H, TS,
                                     128, 16, class_budgets=budgets, **mode)
    before = _launches()
    kb = binned()
    assert _launches() - before == 2 * mode.get("sort_bands", 1)
    monkeypatch.setattr(tiling, "bin_slots", tiling.bin_slots_plain)
    pb = binned()
    assert _launches() - before == 2 * mode.get("sort_bands", 1)
    for f in tiling.TileBinning._fields:
        assert torch.equal(getattr(kb, f), getattr(pb, f)), f
    assert int(kb.n_isect) > 0
