"""Deformable 3D Gaussians in the port (``models/deform.py``, the offsets
through ``ops/project_sh.py``, ``training/step.py``, the trainer and
``render_single(t=)``) against the plain reference
``models/deform_ref.py``, on the CPU at small sizes with seeded weights.

Tolerances, each with its reason:
- the MLP's offsets and gradients: 1e-5 of the largest magnitude (the same
  float32 products, the heads as one matrix product in the port and three
  in the reference);
- the kernel pair's plain version against autograd through the plain
  code: 1e-5 of each leaf's largest gradient (hand-derived formulas
  against autograd's graph, as ``tests/test_torch_project_sh.py``);
- a training step: loss rtol 1e-5, gradients (the Adam first moments over
  1 - b1) 1e-4 of each leaf's largest, the Adam change 1e-6 absolute (the
  second moments start at 1e-4, so the update follows the gradient and no
  sign of a rounding-level gradient decides it);
- before the warm-up, after densify and through a checkpoint: bit for bit.
"""

import types

import numpy as np
import pytest
import torch

from gaussian_splatting_tpu_torch.core.activations import opacity_activation
from gaussian_splatting_tpu_torch.core.cameras import look_at, make_intrinsics
from gaussian_splatting_tpu_torch.core.sh import sh_to_color
from gaussian_splatting_tpu_torch.models import deform as D
from gaussian_splatting_tpu_torch.models import deform_ref as DR
from gaussian_splatting_tpu_torch.models.gaussians import PARAM_KEYS, GaussianParams
from gaussian_splatting_tpu_torch.ops.facade import GaussianRasterizer
from gaussian_splatting_tpu_torch.ops.project_sh import project_shade, project_shade_plain
from gaussian_splatting_tpu_torch.ops.projection import project_gaussians
from gaussian_splatting_tpu_torch.ops.rasterize_ref import rasterize_reference
from gaussian_splatting_tpu_torch.training.config import TrainingConfig
from gaussian_splatting_tpu_torch.training.optimizer import adam_init
from gaussian_splatting_tpu_torch.training.step import TrainState, ViewBatch, make_train_step

W, H = 32, 24
CPU = torch.device("cpu")
SMALL = D.DeformSpec(depth=4, width=32, skip=2, multires_x=4, multires_t=3)
PUBLISHED = D.DeformSpec()


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _ref_net(spec, seed):
    return DR.init_net(spec.depth, spec.width, spec.multires_x, spec.multires_t, seed)


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
    return [torch.as_tensor(np.asarray(v), dtype=torch.float32) for v in vms], \
        torch.as_tensor(np.asarray(K), dtype=torch.float32)


def _render_fn(sh_degree):
    """The reference's renderer of deformed gaussians from the port's plain
    projection and SH and the PyTorch oracle rasterizer, under autograd."""
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


@pytest.mark.parametrize("spec", [PUBLISHED, SMALL], ids=["published", "small"])
def test_mlp_matches_reference(spec):
    net = D.init_params(spec, seed=3, device=CPU)
    ref = _ref_net(spec, 3)
    assert list(net) == list(ref)
    for k in net:
        torch.testing.assert_close(net[k], ref[k], rtol=1e-6, atol=1e-7, msg=k)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((64, 3), generator=g)
    t = 0.37
    leaves = {k: v.clone().requires_grad_(True) for k, v in net.items()}
    rleaves = {k: v.clone().requires_grad_(True) for k, v in ref.items()}
    got = D.mlp(leaves, spec, x, torch.tensor(t))
    want = DR.deform_mlp(rleaves, x, t, spec.multires_x, spec.multires_t)
    assert D.encode(x, spec.multires_x).shape[1] == spec.in_x
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-5
    cots = [torch.randn(o.shape, generator=g) for o in want]
    ga = torch.autograd.grad(got, list(leaves.values()), cots)
    gb = torch.autograd.grad(want, list(rleaves.values()), cots)
    for k, a, b in zip(leaves, ga, gb):
        assert _rel(a, b) < 1e-5, k
    if spec == PUBLISHED:
        assert spec.macs_per_row() == 504_320


@pytest.mark.parametrize("mode,degree", [("classic", 3), ("antialiased", 1)])
def test_pair_offsets_plain_against_autograd(mode, degree):
    p = _scene(48)
    (vm,), K = _views(1)
    g = torch.Generator().manual_seed(7)
    offs = (0.05 * torch.randn((48, 3), generator=g), 0.2 * torch.randn((48, 4), generator=g),
            0.02 * torch.randn((48, 3), generator=g))
    ins = [p.means, p.quats, p.log_scales, p.logit_opacities.reshape(-1), p.sh_coeffs]

    def run(fn):
        leaves = [x.clone().requires_grad_(True) for x in ins]
        ol = [o.clone().requires_grad_(True) for o in offs]
        proj, colors, opac = fn(*leaves, vm, K, W, H, degree, mode, tuple(ol))
        outs = [proj.means2d, proj.depths, proj.conics, proj.compensations, colors, opac]
        cots = [torch.randn(o.shape, generator=torch.Generator().manual_seed(i)) *
                (proj.radii > 0).reshape(-1, *([1] * (o.dim() - 1)))
                for i, o in enumerate(outs)]
        cots[1] = torch.zeros_like(cots[1])
        grads = torch.autograd.grad(outs, leaves + ol, cots)
        return [o.detach() for o in outs], proj.radii, grads

    ko, kr, kg = run(project_shade)
    po, pr, pg = run(project_shade_plain)
    assert torch.equal(kr, pr) and int((kr > 0).sum()) > 10
    for a, b in zip(ko, po):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    names = ["means", "quats", "log_scales", "logits", "sh", "dx", "dr", "ds"]
    for k, a, b in zip(names, kg, pg):
        assert _rel(a, b) < 1e-5, (k, _rel(a, b))
    # dx's gradient is the means'.
    torch.testing.assert_close(kg[5], kg[0], rtol=0, atol=0)


def _state(p, alive, net, mu0=0.0, nu0=1e-4):
    from gaussian_splatting_tpu_torch.models.gaussians import GaussianState

    C = p.means.shape[0]
    gauss = GaussianState(params=GaussianParams(**{k: getattr(p, k).clone() for k in PARAM_KEYS}),
                          alive=alive.clone(), xyz_grad_accum=torch.zeros((C, 3)),
                          xyz_grad_count=torch.zeros((C, 1)),
                          max_radii2d=torch.zeros((C,), dtype=torch.int32))
    opt = adam_init(gauss.params)
    for k in PARAM_KEYS:
        getattr(opt.nu, k).fill_(nu0)
    opt.step.fill_(100)
    dstate = None
    if net is not None:
        dstate = D.DeformState(params={k: v.clone() for k, v in net.items()},
                               mu={k: torch.zeros_like(v) for k, v in net.items()},
                               nu={k: torch.full_like(v, nu0) for k, v in net.items()},
                               spec=SMALL)
    return TrainState(gauss=gauss, opt=opt, iteration=torch.tensor(5000, dtype=torch.int32),
                      deform=dstate)


def _cfg(**kw):
    return TrainingConfig(**{**dict(batch_size=2, backend="ref", deform=True), **kw})


def _batch(p, net, times):
    vms, K = _views(2)
    targets = []
    fn = _render_fn(3)
    with torch.no_grad():
        for vm, t in zip(vms, times):
            dx, dr, ds = DR.deform_mlp(net, p.means, t, SMALL.multires_x, SMALL.multires_t)
            m2, q2, s2 = DR.deformed(p.means + 0.02, p.quats, p.log_scales, 0.5 * dx, dr, ds)
            targets.append(torch.clamp(fn(m2, q2, s2, p.logit_opacities.reshape(-1),
                                          p.sh_coeffs, vm, K), 0, 1))
    return ViewBatch(images=torch.stack(targets), viewmats=torch.stack(vms),
                     Ks=torch.stack([K, K]), view_idx=torch.tensor([0, 1]),
                     times=torch.tensor(times, dtype=torch.float32))


def test_step_matches_reference_step():
    p = _scene(40)
    alive = torch.ones(40, dtype=torch.bool)
    alive[[3, 17]] = False
    net = _ref_net(SMALL, 11)
    batch = _batch(p, net, [0.2, 0.7])
    cfg = _cfg()
    state = _state(p, alive, net)
    step = make_train_step(cfg, W, H, 3, "ref", 2.0, device=CPU)
    state, m = step(state, batch)
    mu0 = {k: torch.zeros_like(getattr(p, k)) for k in PARAM_KEYS}
    mu0.update({k: torch.zeros_like(v) for k, v in net.items()})
    nu0 = {k: torch.full_like(v, 1e-4) for k, v in mu0.items()}
    lrs = {"means": float(cfg.position_lr_init * (cfg.position_lr_final / cfg.position_lr_init)
                          ** (5000 / cfg.position_lr_max_steps)),
           "quats": cfg.lr_rotation, "log_scales": cfg.lr_scaling,
           "logit_opacities": cfg.lr_opacity, "features_dc": cfg.lr_features_dc,
           "features_rest": cfg.lr_features_rest,
           # The published schedule: 5 x the position rate's start, decaying
           # to the position rate's end over 40k iterations.
           "deform": float(DR.exp_lr(5.0 * cfg.position_lr_init, cfg.position_lr_final,
                                     40_000, 5000))}
    rcfg = dict(lambda_dssim=cfg.lambda_dssim, scale_reg_max_ratio=cfg.scale_reg_max_ratio,
                scale_reg_weight=cfg.scale_reg_weight, adam_b1=cfg.adam_b1,
                adam_b2=cfg.adam_b2, adam_eps=cfg.adam_eps, lrs=lrs, extent=2.0,
                scale_clamp_ratio=cfg.scale_clamp_ratio, multires_x=SMALL.multires_x,
                multires_t=SMALL.multires_t)
    views = [(batch.viewmats[i], batch.Ks[i], batch.images[i], float(batch.times[i]))
             for i in range(2)]
    ref = DR.reference_step({k: getattr(p, k) for k in PARAM_KEYS}, net, mu0, nu0, 100, alive,
                            views, _render_fn(3), rcfg)
    np.testing.assert_allclose(float(m["loss"]), ref["loss"], rtol=1e-5)
    b1 = cfg.adam_b1
    got_mu = {k: getattr(state.opt.mu, k) for k in PARAM_KEYS}
    got_mu.update(state.deform.mu)
    for k, g in ref["grads"].items():
        assert float(g.abs().max()) > 0, k
        assert _rel(got_mu[k] / (1 - b1), g) < 1e-4, (k, _rel(got_mu[k] / (1 - b1), g))
    for k in PARAM_KEYS:
        torch.testing.assert_close(getattr(state.gauss.params, k) - getattr(p, k),
                                   ref["params"][k] - getattr(p, k), rtol=0, atol=1e-6)
    for k in net:
        torch.testing.assert_close(state.deform.params[k] - net[k], ref["net"][k] - net[k],
                                   rtol=0, atol=1e-6)
    assert int(state.opt.step) == 101 and int(state.iteration) == 5001
    assert float(m["grad_norm/deform"]) > 0


def test_before_warmup_the_step_is_the_static_step():
    p = _scene(40)
    alive = torch.ones(40, dtype=torch.bool)
    net = _ref_net(SMALL, 11)
    batch = _batch(p, net, [0.2, 0.7])
    batch.times = None
    step = make_train_step(_cfg(), W, H, 3, "cuda", 2.0, device=CPU)
    with_net, m1 = step(_state(p, alive, net), batch)
    static, m2 = step(_state(p, alive, None), batch)
    for k in PARAM_KEYS:
        assert torch.equal(getattr(with_net.gauss.params, k), getattr(static.gauss.params, k))
        assert torch.equal(getattr(with_net.opt.mu, k), getattr(static.opt.mu, k))
    assert torch.equal(m1["loss"], m2["loss"]) and "deform_lr" not in m1
    for k in net:
        assert torch.equal(with_net.deform.params[k], net[k])
        assert not with_net.deform.mu[k].any()


def _dataset(p, net, n_views=4):
    from gaussian_splatting_tpu_torch.training.trainer import ViewDataset

    K = make_intrinsics(W, H, focal_px=30.0, device=CPU)
    vms, imgs = [], []
    fn = _render_fn(0)
    times = np.linspace(0.0, 1.0, n_views)
    for a, t in zip(np.linspace(0.0, 1.5, n_views), times):
        vm = torch.as_tensor(np.asarray(look_at(eye=(2.5 * np.sin(a), 0.3, -2.5 * np.cos(a)),
                                                target=(0, 0, 0), device=CPU)), dtype=torch.float32)
        with torch.no_grad():
            dx, dr, ds = DR.deform_mlp(net, p.means, t, SMALL.multires_x, SMALL.multires_t)
            m2, q2, s2 = DR.deformed(p.means, p.quats, p.log_scales, dx, dr, ds)
            img = fn(m2, q2, s2, p.logit_opacities.reshape(-1), p.sh_coeffs, vm,
                     torch.as_tensor(np.asarray(K)))
        vms.append(vm.numpy())
        imgs.append((np.clip(img.numpy(), 0, 1) * 255).astype(np.uint8))
    return ViewDataset(images=np.stack(imgs), viewmats=np.stack(vms),
                       Ks=np.tile(np.asarray(K)[None], (n_views, 1, 1)))


def test_trainer_checkpoint_densify_and_render_at_t(tmp_path):
    """The trainer deforms from its warm-up on; the network and its moments
    survive a checkpoint bit for bit and a densify event untouched; a
    resumed run carries them on; ``render_single(t=)`` renders the
    reference's image."""
    from gaussian_splatting_tpu_torch.training.checkpoint import load_checkpoint
    from gaussian_splatting_tpu_torch.training.trainer import GaussianTrainer

    p = _scene(30)
    net = _ref_net(SMALL, 2)
    ds = _dataset(p, net)
    assert np.allclose(ds.view_times(), [0, 1 / 3, 2 / 3, 1])
    cfg = _cfg(iterations=6, initial_gaussians=30, max_gaussians=256, deform_warmup=2,
               densify_from_iteration=2, densify_interval=4, opacity_reset_interval=10_000,
               log_scalar_interval=2, log_image_interval=0, val_interval=10_000,
               checkpoint_interval=3, log_hist_interval=10_000, val_fraction=0.0,
               densify_grads_threshold=1e-9, backend="cuda")
    tr = GaussianTrainer(cfg, device=CPU)
    seen = []
    orig = tr._densify

    def spy(state, extent, it):
        before = {k: v.clone() for k, v in state.deform.params.items()}
        out = orig(state, extent, it)
        seen.append(all(torch.equal(out.deform.params[k], before[k]) for k in before)
                    and out.deform is state.deform)
        return out

    tr._densify = spy
    final = tr.train(ds, str(tmp_path), points=p.means.numpy().astype(np.float64),
                     colors=np.full((30, 3), 0.5))
    assert seen == [True]
    assert final.deform is not None and any(float(v.abs().max()) > 0
                                            for v in final.deform.mu.values())
    state, _ = load_checkpoint(str(tmp_path / "final.npz"), device=CPU)
    assert state.deform.spec == PUBLISHED
    for tab in ("params", "mu", "nu"):
        for k, v in getattr(final.deform, tab).items():
            assert torch.equal(getattr(state.deform, tab)[k], v), (tab, k)
    # Resume: the network comes from the checkpoint, not from a new init.
    cfg2 = cfg.replace(iterations=8, checkpoint_interval=10_000, val_seed=99)
    resumed = GaussianTrainer(cfg2, device=CPU).train(ds, str(tmp_path / "r"),
                                                      resume_from=str(tmp_path / "final.npz"))
    assert int(resumed.iteration) == 8
    moved = [float((resumed.deform.params[k] - v).abs().max())
             for k, v in final.deform.params.items()]
    assert 0 < max(moved) < 0.1

    # render_single at a time against the reference's render of it.
    g = state.gauss
    params = GaussianParams(**{k: getattr(g.params, k)[g.alive] for k in PARAM_KEYS})
    K = torch.as_tensor(ds.Ks[1])
    vm = torch.as_tensor(ds.viewmats[1])
    rast = GaussianRasterizer(W, H, backend="ref", sh_degree=0, device=CPU,
                              deform=state.deform)
    got = rast.render_single(params, {"world_view_transform": vm, "K": K}, t=0.4).render
    rnet = state.deform.params
    with torch.no_grad():
        dx, dr, dsc = DR.deform_mlp(rnet, params.means, 0.4, PUBLISHED.multires_x,
                                    PUBLISHED.multires_t)
        m2, q2, s2 = DR.deformed(params.means, params.quats, params.log_scales, dx, dr, dsc)
        want = _render_fn(0)(m2, q2, s2, params.logit_opacities.reshape(-1), params.sh_coeffs,
                             vm, K)
    assert float((got - want).abs().max()) < 1e-5
    static = rast.render_single(params, {"world_view_transform": vm, "K": K}).render
    assert float((static - want).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="deformation network"):
        GaussianRasterizer(W, H, backend="ref", device=CPU).render_single(
            params, {"world_view_transform": vm, "K": K}, t=0.4)


def test_mesh_guard():
    from gaussian_splatting_tpu_torch.parallel.sharded_step import make_sharded_train_step
    from gaussian_splatting_tpu_torch.training.trainer import GaussianTrainer

    cfg = _cfg()
    with pytest.raises(NotImplementedError, match="on a mesh"):
        make_sharded_train_step(cfg, None, W, H, 3, "cuda", 2.0)
    mesh = types.SimpleNamespace(device=CPU, shape={"data": 2, "model": 2}, rank=0)
    ds = _dataset(_scene(10), _ref_net(SMALL, 1), 2)
    with pytest.raises(NotImplementedError, match="deformation MLP"):
        GaussianTrainer(cfg, device=CPU, mesh=mesh).train(ds, "unused")
