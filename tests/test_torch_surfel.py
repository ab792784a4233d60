"""2D Gaussian Splatting (surfels) in the port (``ops/surfel.py``, the
surfel path of ``ops/render.py``, ``training/loss.py``, ``training/step.py``,
the trainer, densify, checkpoints and the PLY export) against the plain
reference ``models/surfel_ref.py``, on the CPU at small sizes with seeded
surfels.

Tolerances, each with its reason:
- the maps against the reference: 1e-5 of each map's largest magnitude
  (the same float32 per-pixel operations; the reference projects with matrix
  products where the port writes each sum out, so the screen values differ
  in their last bits); the distortion 1e-5 of the largest M2 = sum w m^2,
  the size of the terms m^2 A + M2 - 2 m M1 whose cancellation leaves it
  (a few hundredths of their size here);
- the gradients against autograd through the reference: 2e-4 of each leaf's
  largest (hand-derived formulas summed tile by tile and pixel by pixel
  against autograd's graph);
- the projection's hand-derived backward against autograd through the plain
  projection, in float64: 1e-9 of each leaf's largest;
- a training step: loss rtol 1e-5, gradients (the Adam first moments over 1
  - b1) 2e-4 of each leaf's largest.

The card cases (``-m chip``, run with ``--noconftest``) hold the CUDA kernels
to their plain versions run on the card at a 1080p view: stop decisions and
radii bit for bit, the maps to 1e-5 and the gradients to 1e-4 of each
largest magnitude (the kernels' sums run in another order and contract
multiply-adds).
"""

import types

import numpy as np
import pytest
import torch

from gaussian_splatting_tpu_torch.core.cameras import look_at, make_intrinsics
from gaussian_splatting_tpu_torch.models import surfel_ref as SR
from gaussian_splatting_tpu_torch.models.gaussians import PARAM_KEYS, GaussianParams
from gaussian_splatting_tpu_torch.ops import surfel as S
from gaussian_splatting_tpu_torch.ops.render import render
from gaussian_splatting_tpu_torch.training.config import TrainingConfig

W, H = 64, 48
CPU = torch.device("cpu")
MAPS = {"rgb": slice(0, 3), "depth": 3, "alpha": 4, "normal": slice(5, 8), "distortion": 8}


def _scene(n=300, seed=1, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return types.SimpleNamespace(
        means=(torch.randn((n, 3), generator=g) * 0.6).to(dtype),
        quats=torch.randn((n, 4), generator=g).to(dtype),
        log_scales=torch.log(0.03 + 0.15 * torch.rand((n, 2), generator=g)).to(dtype),
        logits=torch.randn((n, 1), generator=g).to(dtype),
        sh=(torch.randn((n, 16, 3), generator=g) * 0.2).to(dtype))


def _camera(dtype=torch.float32):
    vm = torch.eye(4, dtype=dtype)
    vm[2, 3] = 4.0
    K = torch.tensor([[60.0, 0.0, 32.0], [0.0, 60.0, 24.0], [0.0, 0.0, 1.0]], dtype=dtype)
    return vm, K


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _check_maps(got, want):
    for name, sl in MAPS.items():
        scale = want[..., 11] if name == "distortion" else want[..., sl]
        err = float((got[..., sl] - want[..., sl]).abs().max())
        assert err <= 1e-5 * float(scale.abs().max()), name


def _port_maps(p, vm, K, chunk=256, **kw):
    o = render(p.means, p.quats, p.log_scales, p.logits, p.sh, vm, K, W, H, sh_degree=3,
               backend="cuda", device=CPU, max_tiles_per_gaussian=64, raster_chunk=chunk, **kw)
    return o, torch.cat([o.render, o.depth[..., None], o.alpha[..., None], o.normal,
                         o.distortion[..., None], o.median_depth[..., None]], -1)


@pytest.mark.parametrize("chunk", [256, 16])
def test_maps_match_reference(chunk):
    """Every map of the port's plain path equals the reference's; at chunk
    16 the pixels carry their stop rule across many chunks."""
    p = _scene()
    vm, K = _camera()
    out, got = _port_maps(p, vm, K, chunk)
    want = SR.render(p.means, p.quats, p.log_scales, p.logits, p.sh, vm, K, W, H, 3,
                     chunk=chunk)
    assert float(want[..., 4].max()) > 0.9 and float((want[..., 8] > 0).float().mean()) > 0.2
    _check_maps(got, want)
    # The median depth: the same entry at every pixel.
    assert torch.equal(got[..., 9], want[..., 9])
    assert out.means2d.shape == (300, 2) and bool(out.visibility.any())


def test_ref_backend_renders_the_reference():
    """``render(backend="ref")`` of surfels is the reference's render."""
    p = _scene(120, seed=6)
    vm, K = _camera()
    o = render(p.means, p.quats, p.log_scales, p.logits, p.sh, vm, K, W, H, sh_degree=3,
               backend="ref", device=CPU)
    want = SR.render(p.means, p.quats, p.log_scales, p.logits, p.sh, vm, K, W, H, 3)
    assert torch.equal(o.render, want[..., :3]) and torch.equal(o.distortion, want[..., 8])
    with pytest.raises(NotImplementedError, match="pose refinement"):
        render(p.means, p.quats, p.log_scales, p.logits, p.sh, vm.clone().requires_grad_(True),
               K, W, H, backend="cuda", device=CPU)


def test_gradients_match_reference():
    """The gradients of a seeded weighted sum of the maps with respect to
    means, quats, both scales, opacity and SH: the kernels' hand-derived
    backward (plain version) and reduce against autograd through the
    reference."""
    p = _scene()
    vm, K = _camera()
    wts = torch.randn((H, W, 9), generator=torch.Generator().manual_seed(7))

    def grads(fn):
        leaves = [x.clone().requires_grad_(True)
                  for x in (p.means, p.quats, p.log_scales, p.logits, p.sh)]
        (fn(*leaves)[..., :9] * wts).sum().backward()
        return [x.grad for x in leaves]

    def port(*l):
        q = types.SimpleNamespace(means=l[0], quats=l[1], log_scales=l[2], logits=l[3], sh=l[4])
        return _port_maps(q, vm, K)[1]

    got = grads(port)
    want = grads(lambda *l: SR.render(*l, vm, K, W, H, 3))
    for name, a, b in zip(("means", "quats", "log_scales", "logits", "sh"), got, want):
        assert _rel(a, b) < 2e-4, name


def test_projection_backward_against_autograd():
    """``project_surfels_bwd_plain`` (the kernel's formulas) against autograd
    through ``project_surfels_plain``, float64, with a surfel nearly facing
    away and one at the depth clamp."""
    p = _scene(64, seed=3, dtype=torch.float64)
    vm, K = _camera(torch.float64)
    leaves = [x.clone().requires_grad_(True)
              for x in (p.means, p.quats, p.log_scales, p.logits.reshape(-1), p.sh)]
    out = S.project_surfels_plain(*leaves, vm, K, W, H, 3)
    g = torch.Generator().manual_seed(5)
    cot = [torch.randn(t.shape, generator=g, dtype=torch.float64)
           for t in (out.centers, out.tmat, out.normals, out.colors, out.opac)]
    loss = sum((t * c).sum() for t, c in zip((out.centers, out.tmat, out.normals, out.colors,
                                              out.opac), cot))
    want = torch.autograd.grad(loss, leaves)
    got = S.project_surfels_bwd_plain(p.means, p.quats, p.log_scales, p.logits.reshape(-1), p.sh,
                                      vm, K, 3, *cot)
    for name, a, b in zip(("means", "quats", "log_scales", "logits", "sh"), got, want):
        assert _rel(a, b) < 1e-9, name


def test_edge_on_surfel_renders_through_the_filter():
    """A surfel whose plane holds the camera's ray to its centre gives p3 = 0
    or rho3 far above rho2 there: only the screen filter renders it, as the
    reference does, and a pixel at its centre gets its opacity."""
    vm, K = _camera()
    q = torch.tensor([[np.cos(np.pi / 4), np.sin(np.pi / 4), 0.0, 0.0]], dtype=torch.float32)
    p = types.SimpleNamespace(means=torch.tensor([[0.0, 0.0, 0.0]]), quats=q,
                              log_scales=torch.log(torch.tensor([[0.3, 0.3]])),
                              logits=torch.tensor([[3.0]]), sh=torch.zeros((1, 16, 3)))
    # t_w of a quarter turn about x lies in the image plane's y axis: the
    # disc is seen exactly edge-on.
    out, got = _port_maps(p, vm, K)
    want = SR.render(p.means, p.quats, p.log_scales, p.logits, p.sh, vm, K, W, H, 3)
    _check_maps(got, want)
    alpha = got[..., 4]
    assert float(alpha[24, 32]) > 0.5
    # The filter's footprint: nothing beyond ~2.4 px of the centre.
    assert float(alpha[24, 40]) == 0.0 and float(alpha[30, 32]) == 0.0


def test_split_draws_children_in_the_tangent_plane():
    from gaussian_splatting_tpu_torch.core.quaternions import quat_normalize, quat_to_rotmat
    from gaussian_splatting_tpu_torch.models.densify import densify_and_prune
    from gaussian_splatting_tpu_torch.models.gaussians import empty_state

    C, n = 64, 20
    state = empty_state(C, CPU, surfels=True)
    g = torch.Generator().manual_seed(2)
    p = state.params
    p.means[:n] = torch.randn((n, 3), generator=g)
    p.quats[:n] = torch.randn((n, 4), generator=g)
    p.log_scales[:n] = torch.log(torch.full((n, 2), 0.8))
    p.logit_opacities[:n] = 2.0
    state.alive[:n] = True
    state.xyz_grad_accum[:n] = 1.0
    state.xyz_grad_count[:n] = 1.0
    zeros = GaussianParams(**{k: torch.zeros_like(getattr(p, k)) for k in PARAM_KEYS})
    new, _, stats = densify_and_prune(state, (zeros, zeros), 1e-3, 0.005, 1.0, 1000,
                                      generator=torch.Generator().manual_seed(3))
    assert int(stats.n_split) == n and new.params.log_scales.shape == (C, 2)
    normal = quat_to_rotmat(quat_normalize(p.quats[:n]))[:, :, 2]
    off = new.params.means[:n] - p.means[:n]
    assert float(off.norm(dim=-1).min()) > 1e-3
    assert float((off * normal).sum(-1).abs().max()) < 1e-5


def _dataset(n_views=4, n=60, seed=4):
    from gaussian_splatting_tpu_torch.training.trainer import ViewDataset

    p = _scene(n, seed)
    p.means = p.means * 0.5
    K = torch.as_tensor(np.asarray(make_intrinsics(32, 24, focal_px=30.0, device=CPU)))
    vms, imgs = [], []
    for a in np.linspace(0.0, 1.5, n_views):
        vm = torch.as_tensor(np.asarray(look_at(eye=(2.5 * np.sin(a), 0.3, -2.5 * np.cos(a)),
                                                target=(0, 0, 0), device=CPU)),
                             dtype=torch.float32)
        with torch.no_grad():
            img = SR.render(p.means, p.quats, p.log_scales, p.logits, p.sh[:, :1], vm, K, 32, 24,
                            0)[..., :3]
        vms.append(vm.numpy())
        imgs.append((np.clip(img.numpy(), 0, 1) * 255).astype(np.uint8))
    return p, ViewDataset(images=np.stack(imgs), viewmats=np.stack(vms),
                          Ks=np.tile(K.numpy()[None], (n_views, 1, 1)))


def _cfg(**kw):
    return TrainingConfig(**{**dict(batch_size=2, backend="cuda", surfels=True), **kw})


def test_step_matches_reference_step():
    """One ``make_train_step`` step at iteration 7000 (both terms on):
    the loss and every group's gradient against the reference's loss and
    autograd."""
    from gaussian_splatting_tpu_torch.models.gaussians import state_from_numpy
    from gaussian_splatting_tpu_torch.training.optimizer import adam_init
    from gaussian_splatting_tpu_torch.training.step import TrainState, ViewBatch, make_train_step

    p, ds = _dataset()
    n = p.means.shape[0]
    # Copies: the step updates the state it is given in place.
    arrays = {"means": p.means.numpy().copy(), "quats": p.quats.numpy().copy(),
              "log_scales": p.log_scales.numpy().copy(), "logit_opacities": p.logits.numpy().copy(),
              "features_dc": p.sh[:, :1].numpy() + 0.3, "features_rest": p.sh[:, 1:].numpy().copy()}
    cfg = _cfg(scale_reg_weight=0.0)
    init = {k: v.copy() for k, v in arrays.items()}
    gauss = state_from_numpy(arrays, CPU)
    state = TrainState(gauss=gauss, opt=adam_init(gauss.params),
                       iteration=torch.tensor(7000, dtype=torch.int32))
    batch = ViewBatch(images=torch.as_tensor(ds.images[:2]).float() / 255.0,
                      viewmats=torch.as_tensor(ds.viewmats[:2]), Ks=torch.as_tensor(ds.Ks[:2]))
    step = make_train_step(cfg, 32, 24, 3, "cuda", 3.0, device=CPU)
    _, metrics = step(state, batch)
    grads = {k: getattr(state.opt.mu, k) / (1.0 - cfg.adam_b1) for k in PARAM_KEYS}

    leaves = {k: torch.as_tensor(v).requires_grad_(True) for k, v in init.items()}
    total = 0.0
    for b in range(2):
        prm = {"means": leaves["means"], "quats": leaves["quats"],
               "log_scales": leaves["log_scales"], "logit_opacities": leaves["logit_opacities"],
               "sh": torch.cat([leaves["features_dc"], leaves["features_rest"]], 1)}
        total = total + SR.view_loss(prm, batch.viewmats[b], batch.Ks[b], batch.images[b], 32, 24,
                                     3, 7000, tile_size=cfg.tile_size, chunk=cfg.raster_chunk)
    (total / 2).backward()
    want = float(total.detach() / 2)
    assert abs(float(metrics["loss"]) - want) <= 1e-5 * abs(want)
    assert float(metrics["surfel/dist"]) > 0.0 and float(metrics["surfel/normal"]) > 0.0
    for k in PARAM_KEYS:
        assert _rel(grads[k], leaves[k].grad) < 2e-4, k
    assert n == 60


def test_trainer_checkpoint_ply_and_render(tmp_path, monkeypatch):
    """Three training steps of a surfel scene through ``GaussianTrainer``, a
    densify event among them; the checkpoint holds surfels and reloads bit
    for bit, the PLY writes scale_0 and scale_1 only, a resumed run carries
    on, ``render_single`` renders the checkpoint, and a 3D run refuses to
    resume it. (The runs' summary plots are left out: they check nothing
    here and their first text layout costs seconds.)"""
    from gaussian_splatting_tpu_torch.ops.facade import GaussianRasterizer
    from gaussian_splatting_tpu_torch.utils import plots
    from gaussian_splatting_tpu_torch.training.checkpoint import load_checkpoint
    from gaussian_splatting_tpu_torch.training.export import read_ply
    from gaussian_splatting_tpu_torch.training.trainer import GaussianTrainer

    monkeypatch.setattr(plots, "draw_graphs", lambda *a, **k: None)
    p, ds = _dataset()
    cfg = _cfg(iterations=3, initial_gaussians=60, max_gaussians=512,
               densify_from_iteration=1, densify_interval=2, opacity_reset_interval=10_000,
               log_scalar_interval=1, log_image_interval=0, val_interval=10_000,
               checkpoint_interval=10_000, log_hist_interval=10_000, val_fraction=0.0,
               densify_grads_threshold=1e-9)
    final = GaussianTrainer(cfg, device=CPU).train(
        ds, str(tmp_path), points=p.means.numpy().astype(np.float64),
        colors=np.full((60, 3), 0.5))
    assert final.gauss.params.log_scales.shape[1] == 2 and int(final.iteration) == 3
    assert int(final.gauss.n_alive()) > 60
    state, meta = load_checkpoint(str(tmp_path / "final.npz"), device=CPU)
    for k in PARAM_KEYS:
        assert torch.equal(getattr(state.gauss.params, k), getattr(final.gauss.params, k)), k
    with np.load(tmp_path / "final.npz") as z:
        assert z["params/log_scales"].shape[1] == 2
    ply = read_ply(str(tmp_path / "final.ply"))
    assert ply["log_scales"].shape == (int(final.gauss.n_alive()), 2)
    header = (tmp_path / "final.ply").read_bytes().split(b"end_header")[0]
    assert b"scale_1" in header and b"scale_2" not in header
    from gaussian_splatting_tpu_torch.eval_cli import load_model

    for name in ("final.npz", "final.ply"):  # what eval_cli renders
        g, _ = load_model(str(tmp_path / name), device=CPU)
        assert g.params.surfels and int(g.alive.sum()) == int(final.gauss.n_alive()), name
    resumed = GaussianTrainer(cfg.replace(iterations=4), device=CPU).train(
        ds, str(tmp_path / "r"), resume_from=str(tmp_path / "final.npz"))
    assert int(resumed.iteration) == 4
    with pytest.raises(ValueError, match="holds surfels"):
        GaussianTrainer(cfg.replace(surfels=False, iterations=5), device=CPU).train(
            ds, str(tmp_path / "s"), resume_from=str(tmp_path / "final.npz"))
    g = state.gauss
    params = GaussianParams(**{k: getattr(g.params, k)[g.alive] for k in PARAM_KEYS})
    vm, K = torch.as_tensor(ds.viewmats[1]), torch.as_tensor(ds.Ks[1])
    rast = GaussianRasterizer(32, 24, backend="cuda", sh_degree=0, device=CPU)
    got = rast.render_single(params, {"world_view_transform": vm, "K": K})
    want = SR.render(params.means, params.quats, params.log_scales, params.logit_opacities,
                     params.sh_coeffs, vm, K, 32, 24, 0)
    assert got.normal is not None and _rel(got.render, want[..., :3]) < 1e-5


def test_train_cli_flag():
    from gaussian_splatting_tpu_torch import train_cli

    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(
        ["--videos", "v", "--surfels"]))
    assert cfg.surfels and (cfg.surfel_lambda_dist, cfg.surfel_lambda_normal,
                            cfg.surfel_depth_ratio) == (100.0, 0.05, 0.0)
    assert not train_cli.config_from_args(
        train_cli.build_parser().parse_args(["--videos", "v"])).surfels


@pytest.mark.parametrize("what", ["mesh", "deform", "poses", "mesh_step"])
def test_guards_name_what_is_missing(what):
    from gaussian_splatting_tpu_torch.parallel.sharded_step import make_sharded_train_step
    from gaussian_splatting_tpu_torch.training.trainer import GaussianTrainer

    _, ds = _dataset(2, 10)
    if what == "mesh_step":
        with pytest.raises(NotImplementedError, match="surfels.*on a mesh"):
            make_sharded_train_step(_cfg(), None, 32, 24, 3, "cuda", 2.0)
        return
    cfg, mesh, match = _cfg(), None, None
    if what == "mesh":
        mesh = types.SimpleNamespace(device=CPU, shape={"data": 2, "model": 2}, rank=0)
        match = "surfels.*on a mesh"
    elif what == "deform":
        cfg, match = _cfg(deform=True), "surfels with deform"
    else:
        cfg, match = _cfg(optimize_poses=True), "surfels with pose refinement"
    with pytest.raises(NotImplementedError, match=match):
        GaussianTrainer(cfg, device=CPU, mesh=mesh).train(ds, "unused")


def test_static_path_unchanged():
    """A 3D scene renders through the static path: no surfel maps, and the
    binning without ``records`` packs the quantity records."""
    from gaussian_splatting_tpu_torch.ops.tiling import isect_and_sort

    g = torch.Generator().manual_seed(0)
    n = 50
    means2d = torch.rand((n, 2), generator=g) * torch.tensor([W, H])
    conics = torch.tensor([[0.2, 0.0, 0.2]]).repeat(n, 1)
    b = isect_and_sort(means2d, conics, torch.rand((n, 3), generator=g),
                       torch.full((n,), 0.8), torch.rand(n, generator=g) + 1.0,
                       torch.full((n,), 6, dtype=torch.int32), W, H, 16, 256)
    rec = isect_and_sort(means2d, conics, torch.rand((n, 3), generator=g),
                         torch.full((n,), 0.8), torch.rand(n, generator=g) + 1.0,
                         torch.full((n,), 6, dtype=torch.int32), W, H, 16, 256,
                         records=torch.zeros((n, 10)))
    assert b.sorted_soa.shape == rec.sorted_soa.shape and float(b.sorted_soa[:10].abs().max()) > 0
    assert float(rec.sorted_soa[:10].abs().max()) == 0.0
    p = _scene(40)
    vm, K = _camera()
    out = render(p.means, p.quats, torch.cat([p.log_scales, p.log_scales[:, :1]], 1), p.logits,
                 p.sh, vm, K, W, H, backend="cuda", device=CPU)
    assert out.normal is None and out.distortion is None and out.median_depth is None


# ---- the kernels (CUDA card) ----------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_scene(dev, n=200_000, seed=0):
    """Surfels in front of a 1080p camera, dense enough for long tile lists."""
    g = torch.Generator(device=dev).manual_seed(seed)
    means = torch.rand((n, 3), generator=g, device=dev) * torch.tensor(
        [3.2, 1.8, 2.0], device=dev) - torch.tensor([1.6, 0.9, -2.0], device=dev)
    return types.SimpleNamespace(
        means=means, quats=torch.randn((n, 4), generator=g, device=dev),
        log_scales=torch.log(0.002 + 0.01 * torch.rand((n, 2), generator=g, device=dev)),
        logits=torch.randn((n,), generator=g, device=dev) + 1.0,
        sh=0.3 * torch.randn((n, 16, 3), generator=g, device=dev))


def _card_camera(dev):
    K = torch.tensor([[1200.0, 0.0, 960.0], [0.0, 1200.0, 540.0], [0.0, 0.0, 1.0]], device=dev)
    return torch.eye(4, device=dev), K


@pytest.mark.chip
def test_projection_kernel_equals_plain_on_the_card(cuda_device):
    """The projection pair against ``project_surfels_plain`` and
    ``project_surfels_bwd_plain`` run on the card: radii bit for bit, the
    rest to 1e-5 of each output's largest magnitude."""
    p = _card_scene(cuda_device)
    vm, K = _card_camera(cuda_device)
    args = (p.means, p.quats, p.log_scales, p.logits, p.sh, vm, K)
    got = S._ProjectSurfels.apply(*args, (1920, 1080, 3))
    want = S.project_surfels_plain(*args, 1920, 1080, 3)
    assert torch.equal(got[5], want.radii)
    for i, name in enumerate(S.SurfelProjected._fields):
        if name != "radii":
            assert _rel(got[i], getattr(want, name)) < 1e-5, name
    g = torch.Generator(device=cuda_device).manual_seed(3)
    cot = [torch.randn(t.shape, generator=g, device=cuda_device)
           for t in (want.centers, want.tmat, want.normals, want.colors, want.opac)]
    ins = S._surfel_inputs(*args)
    out = [torch.empty_like(x) for x in ins[:5]]
    S._launch_project("bwd", ins, 1920, 1080, 3, [*cot, *out])
    ref = S.project_surfels_bwd_plain(*args, 3, *cot)
    for name, a, b in zip(("means", "quats", "log_scales", "logits", "sh"), out, ref):
        assert _rel(a, b) < 1e-5, name


@pytest.mark.chip
@pytest.mark.parametrize("chunk", [256, 64])
def test_raster_kernels_equal_plain_on_the_card(cuda_device, chunk):
    """The raster pair at a 1080p view against ``surfel_fwd_plain`` and
    ``surfel_bwd_plain`` on the card: the per-pixel weights' stop decisions
    bit for bit (the alpha map's zeros and the median depths equal), the
    maps to 1e-5 and the reduced gradients to 1e-4 of each largest."""
    from gaussian_splatting_tpu_torch.ops.tiling import isect_and_sort

    p = _card_scene(cuda_device)
    vm, K = _card_camera(cuda_device)
    with torch.no_grad():
        sp = S.project_surfels(p.means, p.quats, p.log_scales, p.logits, p.sh, vm, K, 1920, 1080)
        ra, rb = S.surfel_records(sp)
        b = isect_and_sort(sp.centers, sp.conics, sp.colors, sp.opac, sp.depths, sp.radii, 1920,
                           1080, 16, chunk, 16, records=ra)
        soa_b = S.second_soa(rb, b.sorted_soa)
        ntx = 120
        got = S.surfel_fwd(b.tile_starts, b.counts, b.sorted_soa, soa_b, 16, ntx, chunk)
        want, _ = S.surfel_fwd_plain(b.tile_starts, b.counts, b.sorted_soa, soa_b, 16, ntx,
                                     chunk)
        assert torch.equal(got[:, 4] == 0, want[:, 4] == 0)
        assert torch.equal(got[:, 9], want[:, 9])
        for r in range(12):
            if r != 9:
                scale = want[:, 11] if r == 8 else want[:, r]
                err = float((got[:, r] - want[:, r]).abs().max())
                assert err <= 1e-5 * float(scale.abs().max()), r
        gout = torch.randn(got.shape, generator=torch.Generator(device=cuda_device).manual_seed(1),
                           device=cuda_device)
        gout[:, 9:] = 0.0
        n = sp.centers.shape[0]
        cap = S.grad_cap(n, 16, chunk)
        grad, meta = S.surfel_bwd(b.tile_starts, b.counts, b.sorted_soa, soa_b, gout,
                                  want, 16, ntx, chunk, n, cap)
        grad_p, meta_p, _ = S.surfel_bwd_plain(b.tile_starts, b.counts, b.sorted_soa,
                                               soa_b, gout, want, 16, ntx, chunk, n, cap)
        assert torch.equal(meta, meta_p)
        s = S.reduce_surfel_grads(grad, n, meta[0])
        s_p = S.reduce_surfel_grads(grad_p, n, meta_p[0])
        for r, key in enumerate(S.SURFEL_GRAD_KEYS):
            assert _rel(s[r], s_p[r]) < 1e-4, key
