"""PyTorch port, test-time pose alignment: ``training.trainer.align_pose`` is
the one loop behind the trainer's validation and the eval CLI's
``--pose-align``. Each caller is held against its own JAX counterpart on the
same views, through the oracle (backend ``ref``) at 32x32 on the CPU:

- the trainer's (rate decaying 30x, the config's betas) against the JAX
  trainer's ``align_one`` (``gaussian_splatting_tpu/training/trainer.py:802``);
- the eval CLI's (constant rate, betas 0.9 / 0.999 / 1e-8) against the JAX
  eval CLI's loop (``gaussian_splatting_tpu/eval_cli.py:164-208``), both CLIs
  given the same dataset in place of their video front end.

The views are the true ones moved by a seeded se(3) delta, so alignment has
something to recover. Tolerances: aligned view matrices atol 1e-5; raw
metrics atol 1e-4 and the aligned PSNR 1e-3 dB (see the eval test); the
aligned PSNR never below the raw one.
"""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu import eval_cli as j_eval
from gaussian_splatting_tpu import train_cli as j_train
from gaussian_splatting_tpu.core.cameras import look_at, make_intrinsics
from gaussian_splatting_tpu.core.se3 import apply_pose_delta
from gaussian_splatting_tpu.models.gaussians import GaussianParams as JParams
from gaussian_splatting_tpu.ops.render import render as j_render
from gaussian_splatting_tpu.training import trainer as j_trainer
from gaussian_splatting_tpu.training.config import TrainingConfig as JConfig
from gaussian_splatting_tpu.video import processor as j_processor
from gaussian_splatting_tpu_torch import eval_cli as t_eval
from gaussian_splatting_tpu_torch import train_cli as t_train
from gaussian_splatting_tpu_torch.models.gaussians import state_from_numpy
from gaussian_splatting_tpu_torch.training import trainer as t_trainer
from gaussian_splatting_tpu_torch.training.config import TrainingConfig as TConfig
from gaussian_splatting_tpu_torch.training.export import write_ply
from gaussian_splatting_tpu_torch.video import processor as t_processor

W = H = 32
STEPS, LR = 8, 3e-3


def _scene(n_views=3, n=40):
    """(gaussian arrays, dataset arrays with moved views): the true views
    render the images, the dataset holds each view moved by a delta of
    ~0.02."""
    rng = np.random.default_rng(5)
    g = {"means": rng.normal(size=(n, 3)) * 0.6,
         "quats": np.tile([1.0, 0, 0, 0], (n, 1)),
         "log_scales": np.log(rng.uniform(0.08, 0.25, size=(n, 3))),
         "logit_opacities": np.full((n, 1), 2.0),
         "features_dc": (rng.uniform(0.1, 0.9, size=(n, 1, 3)) - 0.5) / 0.28209479177387814,
         "features_rest": np.zeros((n, 15, 3))}
    g = {k: v.astype(np.float32) for k, v in g.items()}
    K = np.asarray(make_intrinsics(W, H, focal_px=35.0))
    images, moved = [], []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        vm = look_at(eye=(2.5 * np.sin(ang), 0.4, -2.5 * np.cos(ang)), target=(0, 0, 0))
        sh = jnp.concatenate([g["features_dc"], g["features_rest"]], axis=1)
        img = j_render(g["means"], g["quats"], g["log_scales"], g["logit_opacities"], sh, vm,
                       K, W, H, sh_degree=0, backend="ref").render
        images.append((np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8))
        xi = (rng.normal(size=6) * 0.02).astype(np.float32)
        moved.append(np.asarray(apply_pose_delta(vm, jnp.asarray(xi))))
    return g, {"images": np.stack(images), "viewmats": np.stack(moved).astype(np.float32),
               "Ks": np.tile(K[None], (n_views, 1, 1)).astype(np.float32)}


@pytest.fixture(scope="module")
def scene():
    return _scene()


def test_trainer_alignment_matches_jax_trainer(scene):
    g, ds = scene
    kw = dict(backend="ref", val_pose_align_steps=STEPS, val_pose_align_lr=LR)
    _, _, align_one = j_trainer.GaussianTrainer(JConfig(**kw))._val_render_fn(
        0, W, H, len(g["means"]))
    jp = JParams(**{k: jnp.asarray(v) for k, v in g.items()})
    j_op = jp.masked_opacities(jnp.ones((len(g["means"]),), bool))
    tt = t_trainer.GaussianTrainer(TConfig(**kw), device="cpu")
    state = types.SimpleNamespace(gauss=state_from_numpy(g, device="cpu"))
    gained = 0
    for vm, K, img in zip(ds["viewmats"], ds["Ks"], ds["images"]):
        gt = img.astype(np.float32) / 255.0
        want = np.asarray(align_one(jp, j_op, jnp.asarray(vm), jnp.asarray(K), jnp.asarray(gt)))
        got = tt._align_pose(state, torch.as_tensor(vm), torch.as_tensor(K),
                             torch.as_tensor(gt), 0, W, H)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        mse = [float(torch.mean((tt._render_view(state, v, torch.as_tensor(K), 0, W, H)
                                 - torch.as_tensor(gt)) ** 2))
               for v in (torch.as_tensor(vm), got)]
        assert mse[1] <= mse[0]
        gained += mse[1] < mse[0]
    assert gained


@pytest.mark.parametrize("pose_align", [0, STEPS])
def test_eval_cli_alignment_matches_jax_eval_cli(scene, tmp_path, monkeypatch, pose_align):
    """Both eval CLIs on one PLY and one dataset (their video front end
    replaced by it): equal aligned views and metrics per view. The aligned
    views are read where each CLI's loop returns them (the JAX loop is the
    jitted ``align_view`` inside ``main``). Aligned renders reach 46 dB,
    where 1e-4 dB is 2.3e-5 of the MSE, under the float32 difference of
    the two oracles' images, so ``psnr_aligned`` is held at 1e-3 dB; the
    raw metrics at 1e-4."""
    import jax

    g, arrays = scene
    write_ply(str(tmp_path / "m.ply"), *(g[k] for k in (
        "means", "features_dc", "features_rest", "logit_opacities", "log_scales", "quats")))
    for proc, train, ds in ((j_processor, j_train, j_trainer.ViewDataset(**arrays)),
                            (t_processor, t_train, t_trainer.ViewDataset(**arrays))):
        monkeypatch.setattr(proc.MultiVideoProcessor, "process_videos",
                            lambda self, *a, **k: {})
        monkeypatch.setattr(train, "build_dataset", lambda merged, image_scale=1.0, ds=ds: ds)
    aligned = {"jax": [], "port": []}
    jit, align_pose = jax.jit, t_trainer.align_pose

    def recording_jit(fn, *a, **k):
        f = jit(fn, *a, **k)
        if getattr(fn, "__name__", "") != "align_view":
            return f

        def recorded(*x):
            out = f(*x)
            aligned["jax"].append(np.asarray(out))
            return out

        return recorded

    def recording_align_pose(*a, **k):
        aligned["port"].append(align_pose(*a, **k))
        return aligned["port"][-1]

    monkeypatch.setattr(jax, "jit", recording_jit)
    monkeypatch.setattr(t_trainer, "align_pose", recording_align_pose)
    common = ["--model", str(tmp_path / "m.ply"), "--videos", "unused.mp4", "--num-views", "3",
              "--backend", "ref", "--cache-dir", str(tmp_path / "cache"),
              "--pose-align", str(pose_align)]
    assert j_eval.main(common + ["--output", str(tmp_path / "j")]) == 0
    assert t_eval.main(common + ["--output", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert len(aligned["port"]) == len(aligned["jax"]) == (3 if pose_align else 0)
    for a, b in zip(aligned["port"], aligned["jax"]):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5)
    j = json.loads((tmp_path / "j" / "metrics.json").read_text())
    t = json.loads((tmp_path / "t" / "metrics.json").read_text())
    assert set(t) == set(j) and t["num_views"] == 3
    tol = {"l1": 1e-4, "ssim": 1e-4, "psnr": 1e-4, "psnr_aligned": 1e-3}
    for a, b in zip(t["per_view"] + [t], j["per_view"] + [j]):
        assert set(a) == set(b)
        for k in set(tol) & set(a):
            assert abs(a[k] - b[k]) <= tol[k], (k, a[k], b[k])
    if pose_align:
        assert all(r["psnr_aligned"] >= r["psnr"] for r in t["per_view"])
        assert t["psnr_aligned"] > t["psnr"]
