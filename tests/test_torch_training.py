"""PyTorch port, the training slice: ``training/loss.py``, ``optimizer.py``,
``core/se3.py``, ``training/step.py`` and ``training/checkpoint.py``
against the JAX package, on the CPU (the port's kernels run their plain
versions, the JAX step its Pallas kernels in interpret mode).

Tolerances, each with its reason:
- float32 losses and schedules: rtol 1e-5 (the same float32 formulas,
  evaluated in another order); bfloat16 losses: atol 1e-2 (the two
  frameworks round to bfloat16 at different places in the pooling);
- gradients: atol 2e-4 of the group's largest gradient, rtol 1e-3, as in
  ``tests/test_rasterize_pallas.py:182``;
- parameters after one Adam step: Adam's first update is about
  -lr * sign(g), so a gradient that is rounding noise in one package may
  flip its sign and move the parameter by up to 2 lr. Parameters are held
  to 1e-6 where |g| exceeds 1e-3 of the group's largest gradient, and to
  2 lr elsewhere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.core import se3 as j_se3
from gaussian_splatting_tpu.core.cameras import look_at, make_intrinsics
from gaussian_splatting_tpu.training import loss as j_loss
from gaussian_splatting_tpu.training import optimizer as j_opt
from gaussian_splatting_tpu.training import step as j_step
from gaussian_splatting_tpu.training.config import TrainingConfig as JConfig
from gaussian_splatting_tpu_torch.core import se3 as t_se3
from gaussian_splatting_tpu_torch.models.gaussians import (
    GaussianParams,
    train_state_from_numpy,
    train_state_to_numpy,
)
from gaussian_splatting_tpu_torch.training import loss as t_loss
from gaussian_splatting_tpu_torch.training import optimizer as t_opt
from gaussian_splatting_tpu_torch.training import step as t_step
from gaussian_splatting_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from gaussian_splatting_tpu_torch.training.config import TrainingConfig as TConfig
from torch_parity import (
    PARAM_KEYS,
    PORT_ONLY_FIELDS,
    jax_train_state,
    jax_train_state_arrays,
    to_jax,
    to_torch,
    train_state_arrays,
)

W, H = 64, 48


def _images(rng, *shape):
    return rng.uniform(-0.1, 1.1, size=shape).astype(np.float32)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-6), ("bfloat16", 1e-2)])
def test_photometric_loss_matches_jax(rng, dtype, atol):
    r, g = _images(rng, H, W, 3), np.clip(_images(rng, H, W, 3), 0, 1)
    jl, jm = j_loss.photometric_loss(*to_jax(r, g), 0.2, dtype=dtype)
    tl, tm = t_loss.photometric_loss(*to_torch(r, g), 0.2, dtype=dtype)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=atol)
    for k in ("l1", "ssim"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=atol, err_msg=k)
    np.testing.assert_allclose(float(tm["psnr"]), float(jm["psnr"]), rtol=1e-5)
    np.testing.assert_allclose(float(t_loss.ssim(*to_torch(r, r))), 1.0, rtol=1e-6)
    assert float(t_loss.psnr(*to_torch(g, g))) == 100.0


def test_stclamp_gradient_is_identity(rng):
    x, w = _images(rng, 5, 7), rng.normal(size=(5, 7)).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(j_loss.stclamp(a) * w))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    y = t_loss.stclamp(xt)
    (y * torch.as_tensor(w)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.clip(x, 0, 1))
    np.testing.assert_array_equal(xt.grad.numpy(), w)
    np.testing.assert_array_equal(np.asarray(jg), w)


def test_scale_ratio_reg_matches_jax(rng):
    ls = np.log(rng.uniform(0.001, 1.0, size=(50, 3))).astype(np.float32)
    alive = rng.uniform(size=50) > 0.3
    jv, jg = jax.value_and_grad(
        lambda a: j_loss.scale_ratio_reg(a, jnp.asarray(alive), 10.0, 0.1))(jnp.asarray(ls))
    lt = torch.as_tensor(ls).requires_grad_(True)
    tv = t_loss.scale_ratio_reg(lt, torch.as_tensor(alive), 10.0, 0.1)
    tv.backward()
    assert float(tv.detach()) > 0
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-9)


def test_config_fields_have_the_jax_names_and_defaults():
    # The port keeps only the fields it reads; each means what it means in
    # the JAX package; its own fields are listed, off by default.
    j_defaults = {f.name: f.default for f in dataclasses.fields(JConfig)}
    t_fields = dataclasses.fields(TConfig)
    assert len(t_fields) > 20
    for f in t_fields:
        if f.name in PORT_ONLY_FIELDS:
            assert f.name not in j_defaults, f.name
            continue
        assert f.name in j_defaults, f.name
        assert f.default == j_defaults[f.name], f.name
    assert TConfig().deform is False


def test_adam_update_and_schedules_match_jax(rng):
    cfg_t, cfg_j = TConfig(pose_start_iter=5), JConfig(pose_start_iter=5)
    arrays = train_state_arrays(rng, 40, moments=True)
    grads = {k: rng.normal(size=arrays[f"params/{k}"].shape).astype(np.float32)
             for k in PARAM_KEYS}
    js = jax_train_state(arrays)
    jlr = j_opt.group_lrs(cfg_j, j_opt.xyz_lr_schedule(cfg_j, jnp.int32(1234)))
    jp, jo = j_opt.adam_update(j_opt.GaussianParams(**{k: jnp.asarray(v) for k, v in grads.items()}),
                               js.opt, js.gauss.params, jlr, eps=cfg_j.adam_eps)
    ts = train_state_from_numpy(arrays, device="cpu")
    tlr = t_opt.group_lrs(cfg_t, t_opt.xyz_lr_schedule(cfg_t, torch.tensor(1234)))
    t_opt.adam_update(GaussianParams(**{k: torch.as_tensor(v) for k, v in grads.items()}),
                      ts.opt, ts.gauss.params, tlr, eps=cfg_t.adam_eps)
    assert int(ts.opt.step) == int(jo.step) == 4
    for k in PARAM_KEYS:
        for got, want in ((getattr(ts.gauss.params, k), getattr(jp, k)),
                          (getattr(ts.opt.mu, k), getattr(jo.mu, k)),
                          (getattr(ts.opt.nu, k), getattr(jo.nu, k))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-8,
                                       err_msg=k)
    for it in (0, 1, 4, 5, 1000, 300_000, 400_000):
        np.testing.assert_allclose(float(t_opt.xyz_lr_schedule(cfg_t, torch.tensor(it))),
                                   float(j_opt.xyz_lr_schedule(cfg_j, jnp.int32(it))),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(t_step.pose_lr_schedule(cfg_t, torch.tensor(it))),
                                   float(j_step.pose_lr_schedule(cfg_j, jnp.int32(it))),
                                   rtol=1e-5)


def _adam_as_written_before(p, g, m, v, lr, step, b1, b2, eps):
    """The in-place update and bias corrections as each update site wrote
    them before the port had one Adam (``optimizer.adam_step``)."""
    t = step.to(torch.float32)
    one = torch.ones((), dtype=torch.float32)
    c1, c2 = 1.0 - (one * b1) ** t, 1.0 - (one * b2) ** t
    m.mul_(b1).add_((1.0 - b1) * g)
    v.mul_(b2).add_((1.0 - b2) * g * g)
    p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + eps))


def _decay_as_written_before(it, init, final, max_steps):
    progress = torch.clamp_max(it.to(torch.float32) / float(max_steps), 1.0)
    return init * torch.pow(torch.full_like(progress, final / init), progress)


@pytest.mark.parametrize("group", ["gaussians", "poses", "mlp"])
def test_adam_step_and_decay_are_the_formulas_they_replace(rng, group):
    """The one Adam update and the one exponential decay equal, bit for bit,
    the copies they replace: the six gaussian groups (``adam_update``), the
    pose deltas (gated by their schedule) and the deformation network's
    tensors, each with its own rate schedule."""
    from gaussian_splatting_tpu_torch.models import deform as t_deform

    cfg = TConfig(pose_start_iter=500)
    b1, b2, eps = cfg.adam_b1, cfg.adam_b2, cfg.adam_eps
    if group == "gaussians":
        shapes = [(40, 3), (40, 4), (40, 3), (40, 1), (40, 1, 3), (40, 15, 3)]
        init, final, max_steps = (cfg.position_lr_init, cfg.position_lr_final,
                                  cfg.position_lr_max_steps)
        schedule = t_opt.xyz_lr_schedule
    elif group == "poses":
        shapes = [(4, 6)]
        init, final, max_steps = cfg.pose_lr_init, cfg.pose_lr_final, cfg.position_lr_max_steps
        schedule = t_step.pose_lr_schedule
    else:
        shapes = [s for _, s in t_deform.DeformSpec(depth=4, width=32, skip=2).shapes()]
        init, final = t_deform.LR_SCALE * cfg.position_lr_init, cfg.position_lr_final
        max_steps, schedule = t_deform.LR_MAX_STEPS, t_deform.lr_schedule
    for it in (0, 1000, max_steps + 1000):
        it = torch.tensor(it, dtype=torch.int32)
        want = _decay_as_written_before(it, init, final, max_steps)
        if group == "poses":
            want = torch.where(it >= cfg.pose_start_iter, want, torch.zeros_like(want))
        else:
            assert torch.equal(t_opt.exp_lr_decay(it, init, final, max_steps), want)
        assert torch.equal(schedule(cfg, it), want), int(it)

    def tensors():
        return [torch.as_tensor(rng.normal(size=s).astype(np.float32)) for s in shapes]

    params, grads, mus = tensors(), tensors(), tensors()
    nus = [torch.abs(v) for v in tensors()]
    if group == "poses":
        grads = [torch.where(schedule(cfg, torch.tensor(1000)) > 0.0, g, torch.zeros_like(g))
                 for g in grads]
    lrs = [schedule(cfg, torch.tensor(1000))] + [1e-3 * (i + 1) for i in range(len(shapes) - 1)]
    want = [[t.clone() for t in ts] for ts in (params, mus, nus)]
    before = params[0].clone()
    step = torch.tensor(7, dtype=torch.int32)
    for (p, m, v), g, lr in zip(zip(*want), grads, lrs):
        _adam_as_written_before(p, g, m, v, lr, step, b1, b2, eps)
    if group == "gaussians":
        opt = t_opt.AdamState(mu=GaussianParams(*mus), nu=GaussianParams(*nus),
                              step=torch.tensor(6, dtype=torch.int32))
        t_opt.adam_update(GaussianParams(*grads), opt, GaussianParams(*params),
                          GaussianParams(*lrs), b1=b1, b2=b2, eps=eps)
        assert torch.equal(opt.step, step)
    else:
        c1, c2 = t_opt.adam_bias_corrections(step, b1, b2)
        for p, g, m, v, lr in zip(params, grads, mus, nus, lrs):
            t_opt.adam_step(p, g, m, v, lr, c1, c2, b1, b2, eps)
    for got, exp in zip((params, mus, nus), want):
        for a, b in zip(got, exp):
            assert torch.equal(a, b)
    assert not torch.equal(params[0], before)


def test_se3_exp_matches_jax_with_finite_gradient_at_zero(rng):
    xi = np.concatenate([rng.normal(size=(4, 6)) * 0.5, np.zeros((1, 6)),
                         rng.normal(size=(1, 6)) * 1e-6]).astype(np.float32)
    np.testing.assert_allclose(t_se3.se3_exp(torch.as_tensor(xi)).numpy(),
                               np.asarray(j_se3.se3_exp(jnp.asarray(xi))), atol=1e-6)
    view = np.array(look_at((0.3, -0.2, -3.0), (0.0, 0.0, 0.0)))
    wts = rng.normal(size=(4, 4)).astype(np.float32)
    jg = jax.grad(lambda x: jnp.sum(j_se3.apply_pose_delta(jnp.asarray(view), x) * wts))(
        jnp.zeros(6, jnp.float32))
    x0 = torch.zeros(6, requires_grad=True)
    (t_se3.apply_pose_delta(torch.as_tensor(view), x0) * torch.as_tensor(wts)).sum().backward()
    assert torch.isfinite(x0.grad).all()
    np.testing.assert_allclose(x0.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


def _batch(rng, n_views):
    eyes = [(0.4, -0.3, -3.5), (-0.8, 0.2, -3.2)]
    views = np.stack([np.asarray(look_at(e, (0.0, 0.0, 0.0))) for e in eyes])
    Ks = np.stack([np.asarray(make_intrinsics(W, H, focal_px=60.0))] * 2)
    images = np.clip(_images(rng, 2, H, W, 3), 0, 1)
    view_idx = np.asarray([2, 0], np.int32) if n_views else None
    return images, views, Ks, view_idx


def _grad_from_first_moment(arrays, k):
    """One step from zero moments leaves mu = (1 - b1) g."""
    return arrays[f"adam_mu/{k}"] / 0.1


@pytest.mark.parametrize("poses", [False, True])
def test_train_step_matches_jax(rng, poses):
    """One step of ``make_train_step`` from the same state in both packages:
    64x48, batch 2, SH degree 3, the cuda backend (plain kernel versions)
    against the JAX ``pallas`` backend (interpret mode)."""
    _assert_step_matches_jax(rng, poses)


def test_train_step_with_sort_buckets_matches_jax(rng):
    """The same with ``sort_buckets=4`` (binning through the bucket
    partition, ``partition_headroom`` 1.5) in both packages."""
    _assert_step_matches_jax(rng, False, sort_buckets=4)


def test_train_step_with_class_budgets_matches_jax(rng):
    """The same with compact ``class_budgets`` in both packages."""
    _assert_step_matches_jax(rng, False, class_budgets=(160, 160, 128, 128, 128, 128, 128, 128))


@pytest.mark.parametrize("cfg", [
    {"sort_bands": 2, "class_budgets": (160, 160, 128, 128, 128, 128, 128, 128)},
    {"sort_depth_bits": 16}])
def test_train_step_with_binning_modes_matches_jax(rng, cfg):
    """The same with band-split binning on class budgets (each band
    enumerated under the full budgets) and with quantized depth keys."""
    _assert_step_matches_jax(rng, False, **cfg)


def _assert_step_matches_jax(rng, poses, **cfg):
    n_views = 3 if poses else 0
    arrays = train_state_arrays(rng, 150, n_views=n_views)
    images, views, Ks, view_idx = _batch(rng, n_views)
    kw = dict(optimize_poses=poses, **cfg)

    j_fn = j_step.make_train_step(JConfig(**kw), W, H, 3, "pallas", 2.0, donate=False)
    jb = j_step.ViewBatch(*to_jax(images, views, Ks),
                          view_idx=None if view_idx is None else jnp.asarray(view_idx))
    js, jm = j_fn(jax_train_state(arrays), jb)
    j_after = jax_train_state_arrays(js)

    t_fn = t_step.make_train_step(TConfig(**kw), W, H, 3, "cuda", 2.0, device="cpu")
    tb = t_step.ViewBatch(*to_torch(images, views, Ks),
                          view_idx=None if view_idx is None else torch.as_tensor(view_idx))
    ts, tm = t_fn(train_state_from_numpy(arrays, device="cpu"), tb)
    t_after = train_state_to_numpy(ts)

    assert set(tm) == set(jm)
    for k in jm:
        if k.startswith("stats/"):
            assert int(tm[k]) == int(jm[k]), k
        elif k.startswith("grad_norm/"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3, err_msg=k)
        else:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-7,
                                       err_msg=k)
    assert int(jm["stats/n_isect"]) > 0 and float(jm["loss"]) > 0

    for k in ("alive", "xyz_grad_count", "max_radii2d", "adam_step", "iteration"):
        np.testing.assert_array_equal(t_after[k], j_after[k], err_msg=k)
    lrs = {"means": float(jm["xyz_lr"]), "quats": 1e-3, "log_scales": 5e-3,
           "logit_opacities": 0.05, "features_dc": 2.5e-3, "features_rest": 1.25e-4}
    for k in PARAM_KEYS:
        gj, gt = _grad_from_first_moment(j_after, k), _grad_from_first_moment(t_after, k)
        scale = np.abs(gj).max() + 1e-12
        np.testing.assert_allclose(gt, gj, atol=2e-4 * scale, rtol=1e-3, err_msg=k)
        pj, pt = j_after[f"params/{k}"], t_after[f"params/{k}"]
        big = np.abs(gj) > 1e-3 * scale
        np.testing.assert_allclose(pt[big], pj[big], atol=1e-6, err_msg=k)
        assert np.abs(pt - pj).max() <= 2 * lrs[k] * (1 + 1e-4), k
    scale = np.abs(_grad_from_first_moment(j_after, "means")).max()
    np.testing.assert_allclose(t_after["xyz_grad_accum"], j_after["xyz_grad_accum"],
                               atol=2e-4 * scale, rtol=1e-3)
    if poses:
        gj = j_after["poses/mu"] / 0.1
        np.testing.assert_allclose(t_after["poses/mu"] / 0.1, gj,
                                   atol=2e-4 * np.abs(gj).max(), rtol=1e-3)
        assert (gj[1] == 0).all() and np.abs(gj[[0, 2]]).max() > 0  # view 1 not in batch
        assert np.abs(t_after["poses/deltas"] - j_after["poses/deltas"]).max() <= 2e-3


def test_checkpoints_round_trip_between_packages(rng, tmp_path):
    """A port checkpoint is read back by the JAX ``load_checkpoint`` and a
    JAX checkpoint by the port's, every array equal, metadata kept."""
    from gaussian_splatting_tpu.training.checkpoint import load_checkpoint as j_load
    from gaussian_splatting_tpu.training.checkpoint import save_checkpoint as j_save

    arrays = train_state_arrays(rng, 30, n_views=4, moments=True, iteration=17)
    t_path, j_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_checkpoint(t_path, train_state_from_numpy(arrays, device="cpu"), extra={"a": 1})
    j_state, j_meta = j_load(t_path)
    j_save(j_path, j_state, extra=j_meta)
    t_state, t_meta = load_checkpoint(j_path, device="cpu")
    assert j_meta == t_meta == {"a": 1}
    for got in (jax_train_state_arrays(j_state), train_state_to_numpy(t_state)):
        assert set(got) == set(arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert t_state.gauss.max_radii2d.dtype == torch.int32
    assert t_state.iteration.dtype == t_state.opt.step.dtype == torch.int32
