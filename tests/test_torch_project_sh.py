"""PyTorch port, ``ops/project_sh.py``: projection + SH as one autograd
Function. On CPU tensors its forward is the plain code and its backward the
hand-derived formulas (``project_shade_bwd_plain``) that the CUDA kernel pair
of ``csrc/project_sh.cu`` computes; here they are held against autograd
through ``project_gaussians`` + ``sh_to_color`` in float64, on random scenes
and on slots at each guard of the projection, and ``project_and_shade`` is
held to its routing: the Function unless the view needs a gradient.

Tolerances: float64 on both sides, the same formulas in another operation
order; the largest error of a gradient leaf is held at 1e-9 of the leaf's
largest magnitude plus 1e-12, float64's rounding of terms of order 1 for a
leaf whose gradients are all rounding noise (measured: under 1e-12 of the
largest on the random scenes; the degenerate slots carry gradients up to
~1e22).
"""

import math

import numpy as np
import pytest
import torch

from gaussian_splatting_tpu_torch.core.sh import sh_to_color
from gaussian_splatting_tpu_torch.models.gaussians import NEG_INF_LOGIT
from gaussian_splatting_tpu_torch.ops.project_sh import project_shade
from gaussian_splatting_tpu_torch.ops.projection import project_gaussians
from gaussian_splatting_tpu_torch.ops.render import project_and_shade
from gaussian_splatting_tpu_torch.utils import profiling

W, H = 64, 48
DT = torch.float64
MODES = ("classic", "antialiased")
# (active degree, SH bases stored): each degree at its own width and below 16.
SH_SHAPES = [(0, 1), (0, 16), (1, 4), (1, 16), (2, 9), (2, 16), (3, 16)]
GRAD_ATOL_FRAC, GRAD_ATOL = 1e-9, 1e-12


def _camera(dtype=DT):
    """Camera frame = world frame: looking along +z from the origin."""
    K = torch.tensor([[60.0, 0.0, 32.0], [0.0, 60.0, 24.0], [0.0, 0.0, 1.0]], dtype=dtype)
    return torch.eye(4, dtype=dtype), K


def _scene(rng, n, k_bases, dtype=DT):
    """Raw parameters of n gaussians in front of the camera, a few past the
    frustum's sides."""
    means = np.stack([rng.normal(size=n) * 1.5, rng.normal(size=n), rng.uniform(1.0, 6.0, n)], -1)
    quats = rng.normal(size=(n, 4))
    log_scales = np.log(rng.uniform(0.05, 0.5, size=(n, 3)))
    logit = rng.normal(size=n)
    sh = rng.normal(size=(n, k_bases, 3)) * 0.3
    return [torch.tensor(a, dtype=dtype) for a in (means, quats, log_scales, logit, sh)]


def _special(kind, rng, k_bases):
    """Eight slots at one guard of the projection, and the check that they
    reach it (on the reference's outputs)."""
    means, quats, log_scales, logit, sh = _scene(rng, 8, k_bases)
    if kind == "behind":        # behind the camera, and inside the near plane
        means[:4, 2] = -torch.linspace(0.5, 3.0, 4, dtype=DT)
        means[4:, 2] = torch.linspace(1e-4, 5e-3, 4, dtype=DT)
        check = lambda p, z, m: bool((p.radii == 0).all())
    elif kind == "offscreen":   # in front, far past the image's sides
        means[:, 0] = torch.linspace(-40.0, 40.0, 8, dtype=DT)
        means[:, 0] += torch.sign(means[:, 0]) * 20.0
        means[:, 2] = 3.0
        log_scales[:] = math.log(0.01)
        check = lambda p, z, m: bool((p.radii == 0).all())
    elif kind == "clamp":       # x/z past 1.3 tan(fov/2) but wide enough to reach the image
        means[:, 0] = torch.linspace(0.9, 1.6, 8, dtype=DT) * means[:, 2]
        means[::2, 0] *= -1.0
        means[:, 1] = 0.9 * means[:, 2] * torch.linspace(-1.0, 1.0, 8, dtype=DT)
        log_scales[:] = math.log(1.5) + log_scales
        logit[:] = 3.0
        lim = 1.3 * 0.5 * W / 60.0
        check = lambda p, z, m: bool(((m[:, 0] / z).abs() > lim).all() and (p.radii > 0).any())
    elif kind == "det_nonpositive":  # rank-1 footprint at 45 degrees: b^2 >= (a+eps)(c+eps)
        ang = math.pi / 4
        quats[:] = torch.tensor([math.cos(ang / 2), 0.0, 0.0, math.sin(ang / 2)], dtype=DT)
        log_scales[:] = torch.log(torch.tensor([1e10, 1e-10, 1e-10], dtype=DT))
        means[:] = torch.tensor([0.0, 0.0, 5.0], dtype=DT)
        # det <= 0: det_safe is 1, so the conic is (c + eps, -b, a + eps) itself.
        check = lambda p, z, m: bool((p.radii == 0).all() and (p.conics[:, 0] > 1e20).all())
    elif kind == "dead":        # a dead slot's opacity, as masked_opacities gives it
        logit[:] = NEG_INF_LOGIT
        check = lambda p, z, m: True
    else:
        raise ValueError(kind)
    return [means, quats, log_scales, logit, sh], check


def _reference(means, quats, log_scales, logit, sh, view, K, deg, mode):
    """The layer as autograd differentiates it: activations,
    ``project_gaussians`` with the opacity-aware radius, the antialiased
    opacity, the view direction from -R^T t and ``sh_to_color``."""
    scales = torch.exp(log_scales)
    op = torch.sigmoid(logit)
    proj = project_gaussians(means, quats, scales, view, K, W, H, opacities=op)
    if mode == "antialiased":
        op = op * proj.compensations
    cam = -view[:3, :3].T @ view[:3, 3]
    d = means - cam[None, :]
    d = d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-12)
    return proj, sh_to_color(deg, sh, d), op


def _outputs(proj, colors, opac):
    return [proj.means2d, proj.depths, proj.conics, proj.compensations, colors, opac]


def _cotangents(rng, n):
    """Random cotangents of the six float outputs; the first two slots get
    none at all and the next two none on their colour (the raster backward
    hands slots it never binned exact zeros)."""
    cot = [torch.tensor(rng.normal(size=s), dtype=DT) for s in
           [(n, 2), (n,), (n, 3), (n,), (n, 3), (n,)]]
    for c in cot:
        c[:2] = 0.0
    cot[4][2:4] = 0.0
    return cot


def _assert_grads_close(got, want):
    for name, a, b in zip(("means", "quats", "log_scales", "logit", "sh"), got, want):
        assert a.shape == b.shape, name
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= GRAD_ATOL_FRAC * scale + GRAD_ATOL, f"{name}: {err:.3e} of {scale:.3e}"


def _check_against_autograd(params, deg, mode, rng, check=None):
    view, K = _camera()
    leaves = [p.clone().requires_grad_(True) for p in params]
    ref = _reference(*leaves, view, K, deg, mode)
    if check is not None:
        assert check(ref[0], params[0][:, 2], params[0])
    cot = _cotangents(rng, params[0].shape[0])
    want = torch.autograd.grad(_outputs(*ref), leaves, cot)

    mine = [p.clone().requires_grad_(True) for p in params]
    out = project_shade(*mine, view, K, W, H, deg, mode)
    for a, b in zip(_outputs(*out), _outputs(*ref)):
        assert torch.equal(a, b.detach())
    assert torch.equal(out[0].radii, ref[0].radii)
    got = torch.autograd.grad(_outputs(*out), mine, cot)
    _assert_grads_close(got, want)
    # Slots with no cotangent get exact zeros; so does the SH gradient of
    # slots with no colour cotangent, and every basis past the active degree.
    for g in got:
        assert not bool(g[:2].any())
    assert not bool(got[4][2:4].any())
    assert not bool(got[4][:, (deg + 1) ** 2:].any())
    return got


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("deg,k_bases", SH_SHAPES)
def test_plain_backward_matches_autograd(deg, k_bases, mode):
    rng = np.random.default_rng(100 * deg + k_bases)
    params = _scene(rng, 300, k_bases)
    # A few slots at every guard, among the ordinary ones.
    for kind in ("behind", "offscreen", "clamp", "dead"):
        extra, _ = _special(kind, rng, k_bases)
        params = [torch.cat([p, e]) for p, e in zip(params, extra)]
    _check_against_autograd(params, deg, mode, rng)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["behind", "offscreen", "clamp", "det_nonpositive", "dead"])
def test_guarded_slots_match_autograd(kind, mode):
    rng = np.random.default_rng(sum(map(ord, kind)))
    params, check = _special(kind, rng, 16)
    _check_against_autograd(params, 3, mode, rng, check)


@pytest.mark.parametrize("mode", MODES)
def test_forward_equals_the_autograd_path(mode):
    """float32, as the render path runs it: the Function's outputs against
    the plain code's, which the autograd path (a view that needs a
    gradient) runs, value for value and radius for radius."""
    rng = np.random.default_rng(7)
    params = _scene(rng, 500, 16, dtype=torch.float32)
    view, K = _camera(torch.float32)
    mine = project_and_shade(*params, view, K, W, H, sh_degree=3, rasterize_mode=mode)
    ref = project_and_shade(*params, view.clone().requires_grad_(True), K, W, H, sh_degree=3,
                            rasterize_mode=mode)
    for a, b in zip(_outputs(*mine), _outputs(*ref)):
        assert torch.equal(a, b.detach())
    assert torch.equal(mine[0].radii, ref[0].radii)
    assert int((mine[0].radii > 0).sum()) > 100


@pytest.mark.parametrize("which", ["viewmat", "K"])
def test_a_view_that_needs_a_gradient_takes_the_autograd_path(which):
    rng = np.random.default_rng(3)
    params = [p.requires_grad_(True) for p in _scene(rng, 200, 16, dtype=torch.float32)]
    view, K = _camera(torch.float32)
    cam = {"viewmat": view, "K": K}
    cam[which] = cam[which].clone().requires_grad_(True)
    profiling.reset_counters("project_sh.autograd")
    proj, colors, opac = project_and_shade(*params, cam["viewmat"], cam["K"], W, H)
    assert profiling.counters()["project_sh.autograd"] == 1
    (proj.means2d.sum() + proj.conics.sum() + colors.sum() + opac.sum()).backward()
    assert bool(cam[which].grad.abs().sum() > 0)
    assert all(p.grad is not None for p in params)
    # Neither the parameters alone nor a view under no_grad count.
    project_and_shade(*params, view, K, W, H)
    with torch.no_grad():
        project_and_shade(*params, cam["viewmat"], cam["K"], W, H)
    assert profiling.counters()["project_sh.autograd"] == 1


def test_unknown_rasterize_mode_and_too_few_bases_raise():
    params = _scene(np.random.default_rng(0), 10, 4, dtype=torch.float32)
    view, K = _camera(torch.float32)
    with pytest.raises(ValueError, match="rasterize_mode"):
        project_and_shade(*params, view, K, W, H, sh_degree=1, rasterize_mode="blurry")
    with pytest.raises(ValueError, match="SH bases"):
        project_and_shade(*params, view, K, W, H, sh_degree=2)
