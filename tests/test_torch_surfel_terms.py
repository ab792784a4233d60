"""The surfel regularizers (``training/loss.py::surfel_terms``: the
normal-consistency and depth-distortion means of one 2D Gaussian Splatting
view) on the CPU: the hand-derived backward ``surfel_terms_bwd_plain``, which
``csrc/surfel_terms.cu``'s backward kernel computes, against autograd of the
plain ``surfel_terms_plain``; and the entry point on the raster's (H, W, 12)
map buffer, read where it lies.

Tolerances, each with its reason:
- the hand-derived gradients against autograd: 1e-5 of each input row's
  largest in float32 (the same operations, summed in another order where
  autograd adds the stencil's four shifted adjoints), 1e-10 in float64;
- the entry point on CPU tensors runs the plain forward and the hand-derived
  backward themselves, so a strided buffer and its contiguous copy give the
  same bits.

The kernels on the card are held to these in ``tests/test_torch_surfel.py``
(``-m chip``).
"""

import pytest
import torch

from gaussian_splatting_tpu_torch.ops.surfel import (
    OUT_ROWS,
    ROW_ALPHA,
    ROW_DEPTH,
    ROW_DIST,
    ROW_MEDIAN,
    ROW_NORMAL,
)
from gaussian_splatting_tpu_torch.training import loss as L
from gaussian_splatting_tpu_torch.utils import profiling

CASES = ("smooth", "alpha_below_floor", "background", "flat_depth")
TOL = {torch.float32: 1e-5, torch.float64: 1e-10}
G_NORMAL, G_DIST = 0.7, -1.3


def _camera(dtype):
    g = torch.Generator().manual_seed(5)
    vm = torch.eye(4, dtype=torch.float64)
    vm[:3, :3] = torch.linalg.qr(torch.randn((3, 3), generator=g, dtype=torch.float64))[0]
    vm[:3, 3] = torch.tensor([0.1, -0.2, 0.3])
    K = torch.tensor([[30.0, 0.0, 17.0], [0.0, 31.0, 12.0], [0.0, 0.0, 1.0]])
    return vm.to(dtype), K.to(dtype)


def _buffer(H, W, case, dtype=torch.float32, pad=(5, 7), seed=0):
    """A (H, W, 12) view of a padded (H + pad, W + pad, 12) buffer, as the
    raster returns its maps: a depth sum alpha times a wavy surface, the
    normal sum, the distortion and the median depth; ``case`` plants a
    region of alpha under the 1e-10 floor, of empty background (depth and
    alpha 0: a zero cross product) or of constant surface depth."""
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=dtype), torch.arange(W, dtype=dtype),
                            indexing="ij")
    alpha = 0.2 + 0.7 * torch.rand((H, W), generator=g, dtype=dtype)
    surface = 2.0 + 0.3 * torch.sin(xx / 5) + 0.2 * torch.cos(yy / 3)
    ys, xs = slice(H // 4, H // 4 + 4), slice(W // 3, W // 3 + 6)
    if case == "alpha_below_floor":
        alpha[ys, xs] = 1e-12
    elif case == "background":
        alpha[ys, xs] = 0.0
    elif case == "flat_depth":
        surface[ys, xs] = 2.5
    buf = torch.zeros((H + pad[0], W + pad[1], OUT_ROWS), dtype=dtype)
    buf[:H, :W, :3] = torch.rand((H, W, 3), generator=g, dtype=dtype)
    buf[:H, :W, ROW_DEPTH] = surface * alpha
    buf[:H, :W, ROW_ALPHA] = alpha
    buf[:H, :W, ROW_NORMAL:ROW_NORMAL + 3] = (
        torch.randn((H, W, 3), generator=g, dtype=dtype) * alpha[..., None])
    buf[:H, :W, ROW_DIST] = 0.01 * torch.rand((H, W), generator=g, dtype=dtype)
    buf[:H, :W, ROW_MEDIAN] = surface + 0.01 * torch.randn((H, W), generator=g, dtype=dtype)
    buf[:H, :W, ROW_MEDIAN + 1:] = torch.rand((H, W, 2), generator=g, dtype=dtype)
    return buf[:H, :W]


def _row_err(got, want):
    """max |got - want| of each row over that row's largest |want|."""
    scale = want.abs().amax(dim=(0, 1)).clamp_min(1e-30)
    return ((got - want).abs().amax(dim=(0, 1)) / scale).max().item()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("depth_ratio", [0.0, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_backward_matches_autograd(case, depth_ratio, dtype):
    """``surfel_terms_bwd_plain`` against autograd of ``surfel_terms_plain``
    at a 21 x 37 view (neither a multiple of the kernels' 32 x 8 tile)."""
    maps = _buffer(21, 37, case, dtype)
    vm, K = _camera(dtype)
    six = L._six_maps(maps).clone().requires_grad_(True)
    median = maps[..., ROW_MEDIAN]
    l_n, l_d = L.surfel_terms_plain(six, vm, K, depth_ratio, median)
    g_n, g_d = torch.tensor(G_NORMAL, dtype=dtype), torch.tensor(G_DIST, dtype=dtype)
    (l_n * g_n + l_d * g_d).backward()
    got = L.surfel_terms_bwd_plain(L._six_maps(maps), vm, K, depth_ratio, median, g_n, g_d)
    assert got.dtype == dtype and got.shape == six.shape
    assert _row_err(got, six.grad) <= TOL[dtype]
    if case == "alpha_below_floor":
        assert float(got[5:9, 12:18, 4].abs().max()) == 0.0


def test_missing_cotangent_is_zero():
    """A None cotangent gives what a zero one gives."""
    maps = _buffer(12, 40, "smooth")
    vm, K = _camera(torch.float32)
    args = (L._six_maps(maps), vm, K, 0.0, maps[..., ROW_MEDIAN])
    zero = torch.zeros(())
    assert torch.equal(L.surfel_terms_bwd_plain(*args, None, torch.tensor(G_DIST)),
                       L.surfel_terms_bwd_plain(*args, zero, torch.tensor(G_DIST)))
    assert torch.equal(L.surfel_terms_bwd_plain(*args, torch.tensor(G_NORMAL), None),
                       L.surfel_terms_bwd_plain(*args, torch.tensor(G_NORMAL), zero))


@pytest.mark.parametrize("depth_ratio", [0.0, 0.5])
def test_entry_point_on_the_map_buffer(depth_ratio):
    """``surfel_terms`` on a strided (H, W, 12) view: the plain terms' values
    bit for bit, one gradient of the whole buffer with the hand-derived rows
    in place and zeros in the rows the terms do not read (the colour, the
    median, M1 and M2), and the same values and gradient as on a contiguous
    copy of the buffer."""
    maps = _buffer(19, 45, "background")
    assert not maps.is_contiguous()
    vm, K = _camera(torch.float32)
    want = L.surfel_terms_plain(L._six_maps(maps), vm, K, depth_ratio, maps[..., ROW_MEDIAN])
    grads = []
    for m in (maps.detach().clone().requires_grad_(True),
              maps.contiguous().detach().requires_grad_(True)):
        # The buffer reaches the terms as the step hands it: through a view.
        l_n, l_d = L.surfel_terms(m[:], vm, K, depth_ratio)
        assert torch.equal(l_n, want[0]) and torch.equal(l_d, want[1])
        (l_n * G_NORMAL + l_d * G_DIST).backward()
        grads.append(m.grad)
    assert torch.equal(grads[0], grads[1])
    d6 = L.surfel_terms_bwd_plain(L._six_maps(maps), vm, K, depth_ratio, maps[..., ROW_MEDIAN],
                                  torch.tensor(G_NORMAL), torch.tensor(G_DIST))
    assert torch.equal(L._six_maps(grads[0]), d6)
    for row in (0, 1, 2, ROW_MEDIAN, ROW_MEDIAN + 1, ROW_MEDIAN + 2):
        assert float(grads[0][..., row].abs().max()) == 0.0


def test_entry_point_launches_nothing_on_the_cpu():
    profiling.reset_counters("launch.surfel_terms_fwd", "launch.surfel_terms_bwd")
    maps = _buffer(10, 10, "smooth").detach().requires_grad_(True)
    vm, K = _camera(torch.float32)
    l_n, l_d = L.surfel_terms(maps, vm, K)
    (l_n + l_d).backward()
    counts = profiling.counters()
    assert counts.get("launch.surfel_terms_fwd", 0) == 0
    assert counts.get("launch.surfel_terms_bwd", 0) == 0


@pytest.mark.parametrize("bad", ["rows", "viewmat", "device"])
def test_entry_point_refuses_what_it_does_not_take(bad):
    maps = _buffer(10, 10, "smooth")
    vm, K = _camera(torch.float32)
    if bad == "rows":
        maps = maps[..., :6]
    elif bad == "viewmat":
        vm = vm[:3]
    else:
        maps = torch.empty(maps.shape, device="meta")
    with pytest.raises(ValueError):
        L.surfel_terms(maps, vm, K)
