"""PyTorch port, the trainer: ``training/trainer.py``, ``training/export.py``,
``utils/metrics.py`` and the port's checkpoints against the JAX package on
the CPU (``device="cpu"``; the cuda backend runs its kernels' plain
versions there). The choices and the run compared with the JAX trainer
are in ``test_torch_trainer_parity.py``.

Tolerances: scene geometry equal; PLY arrays and checkpoint arrays equal;
a reloaded checkpoint renders bit for bit what the state renders.
"""

import json

import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops.tiling import class_caps
from gaussian_splatting_tpu.training import export as j_export
from gaussian_splatting_tpu.training import trainer as j_trainer
from gaussian_splatting_tpu_torch.models.gaussians import state_from_numpy
from gaussian_splatting_tpu_torch.training import export as t_export
from gaussian_splatting_tpu_torch.training import trainer as t_trainer
from gaussian_splatting_tpu_torch.training.checkpoint import load_checkpoint
from gaussian_splatting_tpu_torch.training.config import TrainingConfig as TConfig
from test_training import _synthetic_scene
from torch_parity import PARAM_KEYS


def _dataset(rng, **kw):
    ds, gt = _synthetic_scene(rng, **kw)
    return ds, t_trainer.ViewDataset(ds.images, ds.viewmats, ds.Ks), gt


def test_compute_scene_geometry_matches_jax(rng):
    pts = np.concatenate([rng.normal(size=(100, 3)), [[500.0, 0, 0]]])
    poses = [np.tile(np.eye(4)[None], (3, 1, 1))]
    poses[0][:, 2, 3] = 4.0
    for p, ps in ((pts, poses), (pts[:5], poses), (pts[:0], poses)):
        je, jm = j_trainer.compute_scene_geometry(p, ps)
        te, tm = t_trainer.compute_scene_geometry(p, ps)
        assert te == je
        np.testing.assert_array_equal(tm, jm)
    assert not t_trainer.compute_scene_geometry(pts, poses)[1][-1]


def test_ply_written_by_each_package_reads_in_the_other(rng, tmp_path):
    n = 12
    arrays = {"means": rng.normal(size=(n, 3)), "features_dc": rng.normal(size=(n, 1, 3)),
              "features_rest": rng.normal(size=(n, 15, 3)),
              "logit_opacities": rng.normal(size=(n, 1)), "log_scales": rng.normal(size=(n, 3)),
              "quats": rng.normal(size=(n, 4))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    order = ("means", "features_dc", "features_rest", "logit_opacities", "log_scales", "quats")
    t_export.write_ply(str(tmp_path / "t.ply"), *(arrays[k] for k in order))
    j_export.write_ply(str(tmp_path / "j.ply"), *(arrays[k] for k in order))
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    for got in (j_export.read_ply(str(tmp_path / "t.ply")),
                t_export.read_ply(str(tmp_path / "j.ply"))):
        for k in order:
            np.testing.assert_array_equal(got[k], arrays[k], err_msg=k)
    # export_state_ply writes the alive rows only.
    alive = np.arange(n) % 3 != 0
    st = state_from_numpy(dict(arrays, alive=alive), device="cpu")
    assert t_export.export_state_ply(st, str(tmp_path / "s.ply")) == alive.sum()
    back = j_export.read_ply(str(tmp_path / "s.ply"))
    np.testing.assert_array_equal(back["means"], arrays["means"][alive])


def _train_cfg(**kw):
    base = dict(iterations=24, batch_size=2, backend="cuda", initial_gaussians=60,
                max_gaussians=4096, densify_from_iteration=8, densify_interval=8,
                densify_topk_fraction=0.2, opacity_reset_interval=16, val_interval=12,
                checkpoint_interval=20, log_scalar_interval=4, log_hist_interval=12,
                log_image_interval=0, sh_increment_interval=12, sh_degree_max=1)
    base.update(kw)
    return TConfig(**base)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_trainer_end_to_end_and_resume(rng, tmp_path):
    """tests/test_training.py:337 on the port: compact binning chosen,
    densify, opacity reset, validation, histograms, checkpoints, final
    files; the JAX package reads the checkpoint and the PLY; a resume
    continues the counter."""
    from gaussian_splatting_tpu.training.checkpoint import load_checkpoint as j_load

    _, ds, gt = _dataset(rng, n_views=8)
    cfg = _train_cfg()
    trainer = t_trainer.GaussianTrainer(cfg, device="cpu")
    state = trainer.train(ds, str(tmp_path / "run"), points=gt, colors=None)
    run = tmp_path / "run"
    assert int(state.iteration) == 24
    for f in ("final.npz", "final.ply", "checkpoint_20.npz", "checkpoint_20.ply",
              "metrics.jsonl", "config.json"):
        assert (run / f).exists(), f
    assert trainer.config.class_budgets is not None
    recs = _records(run / "metrics.jsonl")
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 6 and np.isfinite(losses).all() and losses[-1] < losses[0]
    assert any("densify/n_after" in r for r in recs)
    assert any("val/psnr" in r for r in recs)
    assert any("hist/params/opacity" in r for r in recs)
    assert all(r["stats/n_budget_dropped"] == 0 for r in recs if "loss" in r)
    j_state, meta = j_load(str(run / "final.npz"))
    assert int(j_state.iteration) == 24
    assert meta["render"]["class_budgets"] == list(trainer.config.class_budgets)
    np.testing.assert_array_equal(np.asarray(j_state.gauss.params.means),
                                  state.gauss.params.means.numpy())
    ply = j_export.read_ply(str(run / "final.ply"))
    assert len(ply["means"]) == int(state.gauss.n_alive())
    # The reloaded checkpoint renders what the returned state renders.
    t_state, _ = load_checkpoint(str(run / "final.npz"), device="cpu")
    b = ds.viewmats[0], ds.Ks[0]
    a = trainer._render_view(state, torch.as_tensor(b[0]), torch.as_tensor(b[1]), 1, 32, 32)
    c = trainer._render_view(t_state, torch.as_tensor(b[0]), torch.as_tensor(b[1]), 1, 32, 32)
    assert torch.equal(a, c)

    trainer2 = t_trainer.GaussianTrainer(cfg.replace(iterations=28), device="cpu")
    state2 = trainer2.train(ds, str(tmp_path / "run2"), points=gt,
                            resume_from=str(run / "checkpoint_20.npz"))
    assert int(state2.iteration) == 28
    assert [r["_step"] for r in _records(tmp_path / "run2" / "metrics.jsonl")
            if "loss" in r] == [24, 28]


def test_tilecap_watchdog_raises_max_tiles(rng, tmp_path):
    """tests/test_training.py:409: a tile cap of 1 on big splats drops most
    intersections; the watchdog doubles max_tiles_per_gaussian and
    re-measures the class budgets for the new caps."""
    _, ds, gt = _dataset(rng, n_views=4)
    cfg = TConfig(iterations=6, batch_size=1, backend="cuda", initial_gaussians=48,
                  max_gaussians=512, init_opacity=0.6, densify_from_iteration=10_000,
                  opacity_reset_interval=10_000, val_interval=10_000,
                  checkpoint_interval=10_000, log_scalar_interval=1, sh_degree_max=0,
                  max_tiles_per_gaussian=1, auto_max_tiles=False)
    trainer = t_trainer.GaussianTrainer(cfg, device="cpu")
    trainer.train(ds, str(tmp_path), points=gt, colors=None)
    assert trainer.config.max_tiles_per_gaussian >= 2, "tile-cap watchdog never fired"
    assert len(trainer.config.class_budgets) == len(class_caps(
        trainer.config.max_tiles_per_gaussian))


def test_class_budget_watchdog_rebudgets(rng, tmp_path):
    """tests/test_trainer_mesh.py:96-102 on one device: starved class
    budgets overflow at every step; the watchdog re-measures them with
    escalating headroom."""
    _, ds, gt = _dataset(rng, n_views=4)
    L = len(class_caps(16))
    cfg = TConfig(iterations=6, batch_size=2, backend="cuda", initial_gaussians=1800,
                  max_gaussians=6000, densify_from_iteration=1000, val_interval=1000,
                  checkpoint_interval=1000, log_scalar_interval=1, sh_degree_max=0,
                  class_budgets=(128,) * L)
    trainer = t_trainer.GaussianTrainer(cfg, device="cpu")
    trainer.train(ds, str(tmp_path), points=gt)
    assert trainer._rebudget_count >= 1, "budget-overflow rebudget never fired"
    assert trainer.config.class_budgets != (128,) * L
    assert sum(trainer.config.class_budgets) > 128 * L
    recs = _records(tmp_path / "metrics.jsonl")
    assert recs[0]["stats/n_budget_dropped"] > 0


def test_grad_buffer_probe_grows_the_fraction(rng, tmp_path):
    """A starved gradient buffer: the probe (render_grad_meta) logs the
    exact occupancy and raises grad_buffer_frac."""
    _, ds, gt = _dataset(rng, n_views=4)
    cfg = TConfig(iterations=4, batch_size=1, backend="cuda", initial_gaussians=300,
                  densify_from_iteration=1000, val_interval=2, checkpoint_interval=1000,
                  log_scalar_interval=2, sh_degree_max=0, init_opacity=0.3,
                  grad_buffer_frac=0.02)
    trainer = t_trainer.GaussianTrainer(cfg, device="cpu")
    trainer.train(ds, str(tmp_path), points=gt)
    probes = [r for r in _records(tmp_path / "metrics.jsonl") if "stats/grad_buf_cap" in r]
    assert len(probes) == 2
    assert probes[0]["stats/grad_buf_dropped"] > 0 or (
        probes[0]["stats/grad_buf_written"] > 0.92 * probes[0]["stats/grad_buf_cap"])
    assert trainer.config.grad_buffer_frac == pytest.approx(0.02 * 1.35 ** 2)


def test_mesh_raises_naming_the_roadmap_item(rng, tmp_path):
    _, ds, gt = _dataset(rng, n_views=4)
    trainer = t_trainer.GaussianTrainer(TConfig(mesh_data=2, batch_size=2), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 7"):
        trainer.train(ds, str(tmp_path), points=gt)


def test_metrics_logger_writes_jsonl_images_histograms(tmp_path):
    from gaussian_splatting_tpu_torch.utils.metrics import MetricsLogger

    lg = MetricsLogger(str(tmp_path), config={"a": 1, "b": "x"})
    lg.log({"loss": torch.tensor(0.5), "n": 3}, step=2)
    lg.log_histogram("h", np.array([1.0, 2.0, np.nan, 3.0]), step=2)
    lg.log_image("val/x", np.zeros((4, 5, 3), np.float32), step=2)
    lg.log_artifact(str(tmp_path / "config.json"), "cfg")
    lg.finish()
    recs = _records(tmp_path / "metrics.jsonl")
    assert recs[0]["loss"] == 0.5 and recs[0]["_step"] == 2
    assert recs[1]["hist/h"]["n"] == 3
    assert (tmp_path / "images" / "val_x_2.png").exists()
    assert json.loads((tmp_path / "config.json").read_text()) == {"a": 1.0, "b": "x"}


@pytest.mark.parametrize("layout", ["model_state", "bare"])
def test_load_reference_pth_matches_jax(rng, tmp_path, layout):
    """A reference-format ``.pth`` (key aliases, one scale column) loads as
    in the JAX package."""
    from gaussian_splatting_tpu.training.checkpoint import load_reference_pth as j_load_pth
    from gaussian_splatting_tpu_torch.training.checkpoint import load_reference_pth

    n = 9
    sd = {"means3D": torch.randn(n, 3), "f_dc": torch.randn(n, 3),
          "f_rest": torch.randn(n, 45), "opacities": torch.randn(n),
          "scales": torch.randn(n, 1), "rotations": torch.randn(n, 4)}
    path = tmp_path / "ref.pth"
    torch.save({"iteration": 7, "model_state": sd} if layout == "model_state" else sd, path)
    j = j_load_pth(str(path))
    t = load_reference_pth(str(path), device="cpu")
    assert t.capacity == j.capacity == n and bool(t.alive.all())
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(getattr(t.params, k).numpy(),
                                      np.asarray(getattr(j.params, k)), err_msg=k)


def test_trainer_grows_capacity_and_refines_poses(rng, tmp_path):
    """900 gaussians in a 2,048-slot buffer, a quarter more at each
    densify event: the fourth event finds more than 0.85 of the buffer
    alive and grows it first (pre-growth checkpoint, Adam moments padded);
    with pose refinement on, the state carries one delta a view and
    validation reports the pose-aligned PSNR."""
    _, ds, gt = _dataset(rng, n_views=6)
    pts = np.concatenate([gt + 0.02 * np.random.default_rng(i).normal(size=gt.shape)
                          for i in range(10)]).astype(np.float32)
    cfg = TConfig(iterations=8, batch_size=1, backend="cuda", initial_gaussians=900,
                  max_gaussians=6000, init_opacity=0.1, densify_from_iteration=1,
                  densify_interval=2, densify_topk_fraction=0.25, val_interval=8,
                  checkpoint_interval=1000, log_scalar_interval=4, sh_degree_max=0,
                  log_image_interval=0, optimize_poses=True, val_pose_align_steps=2)
    trainer = t_trainer.GaussianTrainer(cfg, device="cpu")
    state = trainer.train(ds, str(tmp_path), points=pts)
    assert (tmp_path / "pre_growth.npz").exists()
    assert state.gauss.capacity > 2048 and state.gauss.capacity % 2048 == 0
    for k in ("means", "features_rest"):
        assert getattr(state.opt.mu, k).shape == getattr(state.gauss.params, k).shape
    assert tuple(state.poses.deltas.shape) == (6, 6) and bool(state.poses.deltas.abs().sum() > 0)
    recs = _records(tmp_path / "metrics.jsonl")
    assert max(r.get("densify/n_after", 0) for r in recs) > 2048  # past the old capacity
    assert any("val/psnr_aligned" in r for r in recs)
