"""``work.py``'s counts on a scene counted by hand, and the reference's
counts of the same scene."""

import pytest
import torch

from portbench import work
from portbench.reference import render as R


def _two_wide_gaussians():
    """Two gaussians centred on a 16 x 16 image (one tile), so wide that
    their alpha is their opacity, 0.5, at every pixel: every pixel blends
    both (T stays above 1e-4), 512 pairs carry a weight, 2 intersections."""
    means2d = torch.tensor([[8.0, 8.0], [8.0, 8.0]])
    conics = torch.full((2, 3), 1e-6)
    conics[:, 1] = 0.0
    colors = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    return R.Screen(means2d, conics, colors, torch.tensor([0.5, 0.5]),
                    torch.tensor([1.0, 2.0]), torch.tensor([3, 3], dtype=torch.int32))


def test_reference_counts_the_hand_counted_scene():
    s = _two_wide_gaussians()
    b = R.bin_view(s, 16, 16, 16, 16)
    assert b.n_isect == 2 and b.gid.tolist() == [0, 1]
    img, pairs = R.blend(b, s, 16, 16)
    assert pairs == 512
    # front: 0.5 red; behind: 0.5 * 0.5 green.
    assert torch.allclose(img[3, 5], torch.tensor([0.5, 0.25, 0.0]), atol=1e-4)


def test_work_counts_by_hand():
    ops, nbytes = work.raster_fwd(n_isect=2, pairs=512, pixels=256, tiles=1)
    assert ops == 32 * 512
    assert nbytes == 40 * 2 + 8 * 1 + 20 * 256
    ops, nbytes = work.raster_bwd(n_isect=2, pairs=512, pixels=256, tiles=1)
    assert ops == 76 * 512
    assert nbytes == 88 * 2 + 8 + 40 * 256
    view = {"pairs": 512, "pixels": 256}
    assert work.train_step_flops(view, 2, 1, 3) == (
        3 * (268 + 142) * 2 + 108 * 512 + 3 * 73 * 3 * 256 + 14 * 59 * 2)
    assert work.render_frame_flops(view, 2, 0) == (268 + 9) * 2 + 32 * 512


def test_roofline_share():
    assert work.roofline_share(1.0, 1.0, 0.0) is None
    # 3.35 GB at 3.35 TB/s is 1 ms: in 2 ms, half the roofline.
    assert work.roofline_share(1e3, 3.35e9, 2e-3) == pytest.approx(50.0)
    assert work.roofline_share(67e9, 0.0, 1e-3) == pytest.approx(100.0)
