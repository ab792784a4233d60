"""4D Gaussian Splatting in the port (``models/hexplane.py``, the field op
``ops/hexplane.py``, ``training/step.py``, the trainer and checkpoints)
against the plain reference ``models/hexplane_ref.py`` (the field through
``F.grid_sample`` as the K-Planes wrapper calls it), on the CPU with seeded
fields.

Tolerances, each with its reason:
- the field's features: 1e-6 of the largest (the same bilinear sums and
  six float32 products, grid_sample's arithmetic against the plain
  version's, a few ulps apart);
- the plane and coordinate gradients: 1e-5 of each tensor's largest (the
  same terms summed in another order: over channels and planes by the
  hand-derived backward, by autograd's graph in the reference);
- a training step: the loss 1e-6 relative (the same float32 image, the
  offsets a few ulps apart), every leaf's gradient (the Adam first moment
  over 1 - b1) 1e-4 of its largest (rounding-level offset differences
  moved through the renderer's backward, as ``tests/test_torch_deform.py``);
- the Adam change: 1e-6 absolute (the second moments start at 1e-4, so no
  sign of a rounding-level gradient decides an update);
- through a checkpoint: bit for bit.

On the card (``-m chip``): the kernel pair against the plain version at 1M
rows and the published widths, features within 1e-6 of the largest,
coordinate gradients 1e-5 and plane gradients 1e-4 of each largest (a hot
cell sums up to ~1e5 terms in an order the atomics set), and one launch of
each a training view.
"""

import numpy as np
import pytest
import torch

from gaussian_splatting_tpu_torch.core.activations import opacity_activation
from gaussian_splatting_tpu_torch.core.cameras import look_at, make_intrinsics
from gaussian_splatting_tpu_torch.core.sh import sh_to_color
from gaussian_splatting_tpu_torch.models import hexplane as HX
from gaussian_splatting_tpu_torch.models import hexplane_ref as HR
from gaussian_splatting_tpu_torch.models.gaussians import PARAM_KEYS, GaussianParams
from gaussian_splatting_tpu_torch.ops import hexplane as OP
from gaussian_splatting_tpu_torch.ops.projection import project_gaussians
from gaussian_splatting_tpu_torch.ops.rasterize_ref import rasterize_reference
from gaussian_splatting_tpu_torch.training.config import TrainingConfig
from gaussian_splatting_tpu_torch.training.optimizer import adam_init
from gaussian_splatting_tpu_torch.training.step import TrainState, ViewBatch, make_train_step
from gaussian_splatting_tpu_torch.utils import profiling

W, H = 32, 24
CPU = torch.device("cpu")
EXTENT = 2.0


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _field_params(seed, res=None, device=CPU):
    """A field with random planes in [0.5, 1] (the init's time planes are
    all ones, whose gradients along t vanish) and the init's decoder; with
    ``res`` (space, time) planes of that many cells."""
    params = HX.init_params(seed, device=device)
    g = torch.Generator().manual_seed(seed + 100)
    for s in range(2):
        for p, (i, j) in enumerate(HX.PAIRS):
            k = HX.plane_name(s, p)
            shape = params[k].shape
            if res is not None:
                shape = (res[j == 3], res[i == 3], HX.CHANNELS)
            params[k] = (0.5 + 0.5 * torch.rand(shape, generator=g)).to(device)
    return params


def _planes(params):
    return [params[k] for k in HX.plane_names()]


def _field_pair(params, xn, t, cot):
    """(features, gradients of the planes and xn) of the port's field and of
    the reference's grid_sample field under the same cotangent."""
    leaves = [p.clone().requires_grad_(True) for p in _planes(params)]
    x1 = xn.clone().requires_grad_(True)
    f1 = OP.field(leaves, x1, t)
    g1 = torch.autograd.grad(f1, leaves + [x1], cot)
    ref = {k: params[k].clone().requires_grad_(True) for k in HX.plane_names()}
    x2 = xn.clone().requires_grad_(True)
    f2 = HR.field(ref, torch.cat([x2, torch.full((xn.shape[0], 1), float(t))], 1))
    g2 = torch.autograd.grad(f2, [ref[k] for k in HX.plane_names()] + [x2], cot)
    return f1.detach(), g1, f2.detach(), g2


@pytest.mark.parametrize("case", ["published", "edges"])
def test_field_matches_grid_sample(case):
    """The plain field and its hand-derived backward against F.grid_sample
    under autograd: random rows at the published widths with some outside
    the box; and rows on cell edges, corners and the border of planes of 5
    spatial and 9 time cells (every coordinate a multiple of a cell)."""
    g = torch.Generator().manual_seed(4)
    if case == "published":
        params = _field_params(1)
        xn = torch.rand((1500, 3), generator=g) * 2.6 - 1.3
        t = 0.37
    else:
        params = _field_params(2, res=(5, 9))
        # ((q + 1) / 2) * 4 is an integer for q = -1 + k / 2: edges, the
        # border (q = +-1) and outside it.
        ks = torch.randint(-2, 7, (600, 3), generator=g).float()
        xn = -1.0 + ks / 2.0
        t = 0.5  # ((0.5 + 1) / 2) * 8 = 6: a time-cell edge
    cot = torch.randn((xn.shape[0], 32), generator=g)
    f1, g1, f2, g2 = _field_pair(params, xn, t, cot)
    assert f1.shape == (xn.shape[0], 32)
    assert _rel(f1, f2) < 1e-6, _rel(f1, f2)
    names = HX.plane_names() + ["xn"]
    for name, a, b in zip(names, g1, g2):
        assert float(b.abs().max()) > 0, name
        assert _rel(a, b) < 1e-5, (name, _rel(a, b))
    if case == "edges":
        # Coordinates on or past the border take no gradient.
        on_border = (xn.abs() >= 1.0)
        assert not g1[-1][on_border].any() and not g2[-1][on_border].any()


def test_decoder_offsets_and_regularizers_match_reference():
    """The offsets of a subset of rows (zero elsewhere) and their gradients
    into the means and every field tensor; the regularizers against the
    reference's ``compute_regulation`` and the formula written out."""
    params = _field_params(5)
    g = torch.Generator().manual_seed(6)
    box = torch.tensor([[-1.0, -0.8, -1.2], [1.1, 0.9, 1.0]])
    means = torch.randn((300, 3), generator=g) * 0.7
    rows = torch.arange(0, 300, 3)
    t = 0.81
    p1 = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    m1 = means.clone().requires_grad_(True)
    got = HX.offsets(p1, box, m1, rows, t)
    p2 = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    m2 = means.clone().requires_grad_(True)
    part = HR.offsets(p2, box, m2[rows], t)
    want = [torch.zeros((300, o.shape[1])).index_put((rows,), o) for o in part]
    cots = [torch.randn(o.shape, generator=g) for o in want]
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-5
    ga = torch.autograd.grad(got, list(p1.values()) + [m1], cots)
    gb = torch.autograd.grad(want, list(p2.values()) + [m2], cots)
    for k, a, b in zip(list(p1) + ["means"], ga, gb):
        assert float(b.abs().max()) > 0, k
        assert _rel(a, b) < 1e-5, (k, _rel(a, b))
    # The offsets apply before the activations.
    q = torch.randn((300, 4), generator=g)
    ls = torch.randn((300, 3), generator=g)
    mm, qq, ss = HX.deformed(means, q, ls, got)
    torch.testing.assert_close(mm, means + got[0], rtol=0, atol=0)
    torch.testing.assert_close(qq, q + got[1], rtol=0, atol=0)
    torch.testing.assert_close(ss, ls + got[2], rtol=0, atol=0)
    # Regularizers.
    reg = HX.regularizer(params)
    torch.testing.assert_close(reg, HR.regularizer(params), rtol=1e-6, atol=0)
    tv = ts = l1 = 0.0
    for s in range(2):
        for p in range(6):
            a = params[HX.plane_name(s, p)].double().numpy()
            smooth = float(np.mean(np.diff(a, n=2, axis=0) ** 2))
            if HX.PAIRS[p][1] == 3:
                ts += smooth
                l1 += float(np.mean(np.abs(1.0 - a)))
            else:
                tv += smooth
    np.testing.assert_allclose(float(reg), 2e-4 * tv + 1e-3 * ts + 1e-4 * l1, rtol=1e-6)
    assert HX.decoder_macs_per_row() == 14_976
    assert sum(params[k].numel() for k in HX.plane_names()) == 2_365_440


def _render_fn(sh_degree):
    """The reference's renderer of deformed gaussians (unit quaternions,
    activated scales) from the port's plain projection and SH and the
    PyTorch oracle rasterizer, under autograd."""
    def fn(means, quats, scales, logits, sh, viewmat, K):
        op = opacity_activation(logits)
        proj = project_gaussians(means, quats, scales, viewmat, K, W, H, eps2d=0.3,
                                 opacities=op)
        cam = -viewmat[:3, :3].T @ viewmat[:3, 3]
        d = means - cam[None]
        d = d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-12)
        colors = sh_to_color(sh_degree, sh, d)
        return rasterize_reference(proj.means2d, proj.conics, colors, op, proj.depths,
                                   proj.radii, W, H, tile_size=16).image
    return fn


def _scene(n=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    means = torch.randn((n, 3), generator=g) * 0.5
    quats = torch.randn((n, 4), generator=g)
    log_scales = torch.log(0.05 + 0.15 * torch.rand((n, 3), generator=g))
    logits = 1.0 + torch.randn((n, 1), generator=g)
    sh = torch.cat([torch.randn((n, 1, 3), generator=g),
                    0.1 * torch.randn((n, 15, 3), generator=g)], dim=1)
    return GaussianParams(means=means, quats=quats, log_scales=log_scales,
                          logit_opacities=logits, features_dc=sh[:, :1].contiguous(),
                          features_rest=sh[:, 1:].contiguous())


def _views(n_views=2):
    K = make_intrinsics(W, H, focal_px=30.0, device=CPU)
    vms = [look_at(eye=(2.5 * np.sin(a), 0.3, -2.5 * np.cos(a)), target=(0, 0, 0), device=CPU)
           for a in np.linspace(0.0, 1.2, n_views)]
    return ([torch.as_tensor(np.asarray(v), dtype=torch.float32) for v in vms],
            torch.as_tensor(np.asarray(K), dtype=torch.float32))


def _box(p):
    return HX.box_of(p.means)


def _state(p, alive, net, nu0=1e-4):
    from gaussian_splatting_tpu_torch.models.gaussians import GaussianState

    C, dev = p.means.shape[0], p.means.device
    gauss = GaussianState(params=GaussianParams(**{k: getattr(p, k).clone() for k in PARAM_KEYS}),
                          alive=alive.clone(), xyz_grad_accum=torch.zeros((C, 3), device=dev),
                          xyz_grad_count=torch.zeros((C, 1), device=dev),
                          max_radii2d=torch.zeros((C,), dtype=torch.int32, device=dev))
    opt = adam_init(gauss.params)
    for k in PARAM_KEYS:
        getattr(opt.nu, k).fill_(nu0)
    opt.step.fill_(100)
    field = HX.HexPlaneState(params={k: v.clone() for k, v in net.items()},
                             mu={k: torch.zeros_like(v) for k, v in net.items()},
                             nu={k: torch.full_like(v, nu0) for k, v in net.items()},
                             box=_box(p))
    return TrainState(gauss=gauss, opt=opt,
                      iteration=torch.tensor(5000, dtype=torch.int32, device=dev), deform=field)


def _cfg(**kw):
    return TrainingConfig(**{**dict(batch_size=2, backend="ref", deform=True,
                                    deform_field="hexplane", lambda_dssim=0.0), **kw})


def test_step_matches_reference_step():
    """One step with the field against the reference's autograd step: the
    loss, every leaf's gradient (the six groups, the twelve planes, the
    decoder's fourteen tensors), the Adam changes at the two rates."""
    p = _scene(40)
    alive = torch.ones(40, dtype=torch.bool)
    alive[[3, 17]] = False
    net = _field_params(11)
    vms, K = _views(2)
    times = [0.2, 0.7]
    fn = _render_fn(3)
    targets = []
    with torch.no_grad():
        for vm, t in zip(vms, times):
            dx, dr, ds = HR.offsets(net, _box(p), p.means, t)
            m2, q2, s2 = HR.deformed(p.means + 0.02, p.quats, p.log_scales, 0.5 * dx, dr, ds)
            targets.append(torch.clamp(fn(m2, q2, s2, p.logit_opacities.reshape(-1),
                                          p.sh_coeffs, vm, K), 0, 1))
    batch = ViewBatch(images=torch.stack(targets), viewmats=torch.stack(vms),
                      Ks=torch.stack([K, K]), view_idx=torch.tensor([0, 1]),
                      times=torch.tensor(times, dtype=torch.float32))
    cfg = _cfg()
    state = _state(p, alive, net)
    step = make_train_step(cfg, W, H, 3, "ref", EXTENT, device=CPU)
    state, m = step(state, batch)
    mu0 = {k: torch.zeros_like(getattr(p, k)) for k in PARAM_KEYS}
    mu0.update({k: torch.zeros_like(v) for k, v in net.items()})
    nu0 = {k: torch.full_like(v, 1e-4) for k, v in mu0.items()}
    lrs = {"means": float(cfg.position_lr_init * (cfg.position_lr_final / cfg.position_lr_init)
                          ** (5000 / cfg.position_lr_max_steps)),
           "quats": cfg.lr_rotation, "log_scales": cfg.lr_scaling,
           "logit_opacities": cfg.lr_opacity, "features_dc": cfg.lr_features_dc,
           "features_rest": cfg.lr_features_rest,
           # The fine stage's iteration 2000 of 20k, times the extent.
           "grid": float(HR.lr("grid", 5000, cfg.deform_warmup, EXTENT)),
           "deformation": float(HR.lr("deformation", 5000, cfg.deform_warmup, EXTENT))}
    rcfg = dict(lambda_dssim=cfg.lambda_dssim, scale_reg_max_ratio=cfg.scale_reg_max_ratio,
                scale_reg_weight=cfg.scale_reg_weight, adam_b1=cfg.adam_b1,
                adam_b2=cfg.adam_b2, adam_eps=cfg.adam_eps, lrs=lrs, extent=EXTENT,
                scale_clamp_ratio=cfg.scale_clamp_ratio)
    views = [(vms[i], K, batch.images[i], times[i]) for i in range(2)]
    ref = HR.reference_step({k: getattr(p, k) for k in PARAM_KEYS}, net, mu0, nu0, 100, alive,
                            _box(p), views, fn, rcfg)
    np.testing.assert_allclose(float(m["loss"]), ref["loss"], rtol=1e-6)
    np.testing.assert_allclose(float(m["deform_reg"]), ref["field_reg"], rtol=1e-6)
    b1 = cfg.adam_b1
    got_mu = {k: getattr(state.opt.mu, k) for k in PARAM_KEYS}
    got_mu.update(state.deform.mu)
    assert len(ref["grads"]) == 6 + 26
    for k, g in ref["grads"].items():
        assert float(g.abs().max()) > 0, k
        assert _rel(got_mu[k] / (1 - b1), g) < 1e-4, (k, _rel(got_mu[k] / (1 - b1), g))
    for k in PARAM_KEYS:
        torch.testing.assert_close(getattr(state.gauss.params, k) - getattr(p, k),
                                   ref["params"][k] - getattr(p, k), rtol=0, atol=1e-6)
    for k in net:
        torch.testing.assert_close(state.deform.params[k] - net[k], ref["net"][k] - net[k],
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(m["grid_lr"]), lrs["grid"], rtol=1e-6)
    np.testing.assert_allclose(float(m["deform_lr"]), lrs["deformation"], rtol=1e-6)
    assert int(state.opt.step) == 101 and int(state.iteration) == 5001


def _dataset(p, net, n_views=4):
    from gaussian_splatting_tpu_torch.training.trainer import ViewDataset

    K = make_intrinsics(W, H, focal_px=30.0, device=CPU)
    vms, imgs = [], []
    fn = _render_fn(0)
    for a, t in zip(np.linspace(0.0, 1.5, n_views), np.linspace(0.0, 1.0, n_views)):
        vm = torch.as_tensor(np.asarray(look_at(eye=(2.5 * np.sin(a), 0.3, -2.5 * np.cos(a)),
                                                target=(0, 0, 0), device=CPU)), dtype=torch.float32)
        with torch.no_grad():
            dx, dr, ds = HR.offsets(net, _box(p), p.means, float(t))
            m2, q2, s2 = HR.deformed(p.means, p.quats, p.log_scales, dx, dr, ds)
            img = fn(m2, q2, s2, p.logit_opacities.reshape(-1), p.sh_coeffs, vm,
                     torch.as_tensor(np.asarray(K)))
        vms.append(vm.numpy())
        imgs.append((np.clip(img.numpy(), 0, 1) * 255).astype(np.uint8))
    return ViewDataset(images=np.stack(imgs), viewmats=np.stack(vms),
                       Ks=np.tile(np.asarray(K)[None], (n_views, 1, 1)))


def test_trainer_checkpoint_and_resume(tmp_path):
    """The trainer deforms from its warm-up on with the box of the initial
    points; the field, its moments and the box survive a checkpoint bit for
    bit; a resumed run carries them on and takes the regularizer's span."""
    from gaussian_splatting_tpu_torch.training.checkpoint import load_checkpoint
    from gaussian_splatting_tpu_torch.training.trainer import (
        GaussianTrainer,
        compute_scene_geometry,
    )

    p = _scene(30)
    ds = _dataset(p, _field_params(2))
    cfg = _cfg(iterations=4, initial_gaussians=30, max_gaussians=256, deform_warmup=2,
               densify_from_iteration=10_000, opacity_reset_interval=10_000,
               log_scalar_interval=2, log_image_interval=0, val_interval=10_000,
               checkpoint_interval=10_000, log_hist_interval=10_000, val_fraction=0.0,
               backend="cuda")
    points = p.means.numpy().astype(np.float64)
    final = GaussianTrainer(cfg, device=CPU).train(ds, str(tmp_path), points=points,
                                                   colors=np.full((30, 3), 0.5))
    assert isinstance(final.deform, HX.HexPlaneState)
    _, kept = compute_scene_geometry(points, [ds.viewmats])
    torch.testing.assert_close(final.deform.box, HX.box_of(torch.as_tensor(points[kept])))
    assert any(float(v.abs().max()) > 0 for v in final.deform.mu.values())
    state, _ = load_checkpoint(str(tmp_path / "final.npz"), device=CPU)
    assert torch.equal(state.deform.box, final.deform.box)
    for tab in ("params", "mu", "nu"):
        assert list(getattr(state.deform, tab)) == [n for n, _ in HX.shapes()]
        for k, v in getattr(final.deform, tab).items():
            assert torch.equal(getattr(state.deform, tab)[k], v), (tab, k)
    profiling.reset()
    profiling.enable()
    try:
        resumed = GaussianTrainer(cfg.replace(iterations=5, val_seed=99), device=CPU).train(
            ds, str(tmp_path / "r"), resume_from=str(tmp_path / "final.npz"))
        names = {r.name for r in profiling.spans()}
    finally:
        profiling.disable()
    assert {"deform.field", "deform.field.bwd", "deform.mlp", "deform.mlp.bwd",
            "step.deform_reg"} <= names
    assert int(resumed.iteration) == 5
    moved = [float((resumed.deform.params[k] - v).abs().max())
             for k, v in final.deform.params.items()]
    assert 0 < max(moved) < 0.1
    with pytest.raises(ValueError, match="another deformation"):
        GaussianTrainer(cfg.replace(deform_field="mlp", iterations=6), device=CPU).train(
            ds, str(tmp_path / "r2"), resume_from=str(tmp_path / "final.npz"))

    # render_single at a time: the reference's render of the field's offsets.
    from gaussian_splatting_tpu_torch.ops.facade import GaussianRasterizer

    g = state.gauss
    params = GaussianParams(**{k: getattr(g.params, k)[g.alive] for k in PARAM_KEYS})
    K, vm = torch.as_tensor(ds.Ks[1]), torch.as_tensor(ds.viewmats[1])
    rast = GaussianRasterizer(W, H, backend="ref", sh_degree=0, device=CPU, deform=state.deform)
    got = rast.render_single(params, {"world_view_transform": vm, "K": K}, t=0.4).render
    with torch.no_grad():
        dx, dr, dsc = HR.offsets(state.deform.params, state.deform.box, params.means, 0.4)
        m2, q2, s2 = HR.deformed(params.means, params.quats, params.log_scales, dx, dr, dsc)
        want = _render_fn(0)(m2, q2, s2, params.logit_opacities.reshape(-1),
                             params.sh_coeffs, vm, K)
    assert float((got - want).abs().max()) < 1e-5
    static = rast.render_single(params, {"world_view_transform": vm, "K": K}).render
    assert float((static - want).abs().max()) > 1e-3


@pytest.mark.parametrize("what", ["mesh", "surfels", "poses", "val_align", "kind"])
def test_guards_name_what_is_missing(what):
    import types

    from gaussian_splatting_tpu_torch.training.trainer import GaussianTrainer

    cfg, mesh, err, match = _cfg(), None, NotImplementedError, None
    if what == "mesh":
        mesh = types.SimpleNamespace(device=CPU, shape={"data": 2, "model": 2}, rank=0)
        match = "on a mesh"
    elif what == "surfels":
        cfg, match = _cfg(surfels=True), "with surfels"
    elif what == "poses":
        cfg, match = _cfg(optimize_poses=True), "pose refinement"
    elif what == "val_align":
        cfg, match = _cfg(val_pose_align_steps=2), "pose refinement"
    else:
        cfg, err, match = _cfg(deform_field="grid"), ValueError, "deform_field"
    with pytest.raises(err, match=match):
        GaussianTrainer(cfg, device=CPU, mesh=mesh).train(None, "unused")


def test_train_cli_flag():
    from gaussian_splatting_tpu_torch.train_cli import build_parser, config_from_args

    cfg = config_from_args(build_parser().parse_args(
        ["--videos", "a.mp4", "--output", "o", "--deform", "--deform-field", "hexplane"]))
    assert cfg.deform and cfg.deform_field == "hexplane"
    assert TrainingConfig().deform_field == "mlp"


# --- the kernel pair (CUDA card) ---


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _launches():
    c = profiling.counters()
    return c.get("launch.hexplane_fwd", 0), c.get("launch.hexplane_bwd", 0)


def _card_field(dev, dtype=torch.float32):
    params = _field_params(7, device=dev)
    g = torch.Generator(device=dev).manual_seed(8)
    # Not a multiple of a warp's 8 rows, so the backward's last trip ends
    # inside a warp. A scene's rows crowd a few cells: half of them in a
    # small ball.
    rows = 1_000_003
    xn = torch.rand((rows, 3), generator=g, device=dev) * 2.2 - 1.1
    xn[: rows // 2] = 0.3 + 0.05 * torch.randn((rows // 2, 3), generator=g, device=dev)
    cot = torch.randn((rows, 32), generator=g, device=dev)
    planes = [p.to(dtype).float() for p in _planes(params)]
    return planes, xn.to(dtype).float(), cot


def _run(fn_fwd, fn_bwd, planes, xn, t, cot):
    feat = fn_fwd(planes, xn, t)
    grads, gxn = fn_bwd(planes, xn, t, cot)
    torch.cuda.synchronize()
    return feat, grads, gxn


def _gaps(a, b):
    feat = _rel(a[0], b[0])
    planes = max(_rel(x, y) for x, y in zip(a[1], b[1]))
    return feat, planes, _rel(a[2], b[2])


@pytest.mark.chip
def test_kernel_pair_matches_plain_on_the_card(cuda_device):
    """The pair against the plain version at 1M rows and the published
    widths: features 1e-6, coordinate gradients 1e-5, plane gradients 1e-4
    of each largest; two runs of the kernel, whose atomics sum in another
    order each time, and a bfloat16 field, which must fail each limit."""
    planes, xn, cot = _card_field(cuda_device)
    t = torch.tensor(0.37, device=cuda_device)
    want = _run(OP.field_plain, OP.field_bwd_plain, planes, xn, t, cot)
    before = _launches()
    got = _run(OP._fwd_cuda, OP._bwd_cuda, planes, xn, t, cot)
    assert tuple(a - b for a, b in zip(_launches(), before)) == (1, 1)
    again = _run(OP._fwd_cuda, OP._bwd_cuda, planes, xn, t, cot)
    feat, pl, coord = _gaps(got, want)
    print(f"kernel vs plain: features {feat:.3g}, planes {pl:.3g}, coordinates {coord:.3g}; "
          f"kernel vs kernel: {_gaps(again, got)}")
    assert feat < 1e-6 and coord < 1e-5 and pl < 1e-4
    assert torch.equal(again[0], got[0]) and torch.equal(again[2], got[2])
    bf = _card_field(cuda_device, torch.bfloat16)
    low = _run(OP.field_plain, OP.field_bwd_plain, bf[0], bf[1], t, cot)
    lf, lp, lc = _gaps(low, want)
    print(f"bfloat16 field vs float32: features {lf:.3g}, planes {lp:.3g}, coordinates {lc:.3g}")
    assert lf > 1e-6 and lp > 1e-4 and lc > 1e-5


@pytest.mark.chip
def test_one_launch_of_each_a_training_view(cuda_device):
    """A batch-2 training step on the card launches the pair once a view,
    and its loss and gradients match the same step's plain version."""
    from gaussian_splatting_tpu_torch.ops import hexplane as ops_hexplane

    p = _scene(400)
    p = GaussianParams(**{k: getattr(p, k).to(cuda_device) for k in PARAM_KEYS})
    alive = torch.ones(400, dtype=torch.bool, device=cuda_device)
    net = {k: v.to(cuda_device) for k, v in _field_params(3).items()}
    vms, K = _views(2)
    batch = ViewBatch(images=torch.rand((2, H, W, 3), device=cuda_device),
                      viewmats=torch.stack(vms).to(cuda_device),
                      Ks=torch.stack([K, K]).to(cuda_device),
                      view_idx=torch.tensor([0, 1], device=cuda_device),
                      times=torch.tensor([0.2, 0.7], device=cuda_device))
    step = make_train_step(_cfg(backend="cuda"), W, H, 3, "cuda", EXTENT, device=cuda_device)
    before = _launches()
    s1, m1 = step(_state(p, alive, net), batch)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (2, 2)
    fwd, bwd = ops_hexplane._fwd_cuda, ops_hexplane._bwd_cuda
    ops_hexplane._fwd_cuda = lambda pl, x, t: OP.field_plain(pl, x, t)
    ops_hexplane._bwd_cuda = lambda pl, x, t, g: OP.field_bwd_plain(pl, x, t, g)
    try:
        s2, m2 = step(_state(p, alive, net), batch)
    finally:
        ops_hexplane._fwd_cuda, ops_hexplane._bwd_cuda = fwd, bwd
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-6)
    for k in s1.deform.mu:
        assert _rel(s1.deform.mu[k], s2.deform.mu[k]) < 1e-4, k
    assert _rel(s1.opt.mu.means, s2.opt.mu.means) < 1e-4
