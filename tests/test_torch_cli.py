"""PyTorch port, the two CLIs: ``gaussian_splatting_tpu_torch/train_cli.py``
and ``eval_cli.py`` against the JAX package's on the CPU (``--device cpu``;
the cuda backend runs its kernels' plain versions there), on a seeded
synthetic clip (``tests/synthetic_video.py``, 48 frames at 320x240, SfM at
stride 4).

Tolerances: configurations equal field by field (``pallas`` <-> ``cuda``);
datasets and loaded parameters equal array for array. The eval CLI's
metrics are compared in ``test_torch_eval_cli.py``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from gaussian_splatting_tpu import eval_cli as j_eval
from gaussian_splatting_tpu import train_cli as j_train
from gaussian_splatting_tpu.video.processor import MultiVideoProcessor
from gaussian_splatting_tpu_torch import eval_cli as t_eval
from gaussian_splatting_tpu_torch import train_cli as t_train
from synthetic_video import write_synthetic_video
from torch_parity import PARAM_KEYS, PORT_ONLY_FIELDS


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = tmp_path_factory.mktemp("vid") / "clip.mp4"
    write_synthetic_video(path, n_frames=48, width=320, height=240)
    return str(path)


@pytest.fixture(scope="module")
def run(clip, tmp_path_factory):
    """The port's train CLI on the clip: 10 iterations at half resolution,
    compact budgets chosen by the trainer, pose refinement on (so the
    checkpoint holds pose deltas)."""
    d = tmp_path_factory.mktemp("run")
    rc = t_train.main([
        "--videos", clip, "--output", str(d / "run"), "--iterations", "10",
        "--batch-size", "2", "--frame-stride", "4", "--initial-gaussians", "300",
        "--max-gaussians", "2000", "--backend", "cuda", "--device", "cpu",
        "--image-scale", "0.5", "--optimize-poses", "--cache-dir", str(d / "cache")])
    assert rc == 0
    return d


ARGVS = [
    [],
    ["--iterations", "50", "--batch-size", "2", "--frame-stride", "5", "--initial-gaussians",
     "1000", "--max-gaussians", "5000", "--matcher", "orb", "--image-scale", "0.5",
     "--sh-degree", "2", "--backend", "pallas", "--tile-size", "8", "--cache-dir", "c",
     "--densify-topk", "0.05", "--optimize-poses", "--pose-lr", "2e-3",
     "--pose-start-iter", "10", "--grad-buffer-frac", "0.8", "--wandb-mode", "offline",
     "--wandb-project", "p", "--wandb-run-name", "r"],
    ["--backend", "ref", "--mesh-data", "1", "--mesh-model", "1"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "every-flag", "ref"])
def test_config_from_args_matches_jax(argv):
    j_cfg = j_train.config_from_args(j_train.build_parser().parse_args(["--videos", "v"] + argv))
    t_argv = ["cuda" if a == "pallas" else a for a in argv]
    t_cfg = t_train.config_from_args(t_train.build_parser().parse_args(["--videos", "v"]
                                                                       + t_argv))
    want = dataclasses.asdict(j_cfg)
    if want["backend"] == "pallas":
        want["backend"] = "cuda"
    got = dataclasses.asdict(t_cfg)
    # The port's own fields (Deformable 3D Gaussians) stay at their
    # defaults under the JAX CLI's flags.
    defaults = dataclasses.asdict(type(t_cfg)())
    for k in PORT_ONLY_FIELDS:
        assert got.pop(k) == defaults[k], k
    assert got == want


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_build_dataset_matches_jax(run, clip, scale):
    merged = MultiVideoProcessor(cache_dir=str(run / "cache")).process_videos(
        [clip], stride=4, use_cache=True)
    j = j_train.build_dataset(merged, image_scale=scale)
    t = t_train.build_dataset(merged, image_scale=scale)
    assert t.num_views >= 5
    for k in ("images", "viewmats", "Ks"):
        np.testing.assert_array_equal(getattr(t, k), np.asarray(getattr(j, k)), err_msg=k)


def _pth(run):
    path = run / "ref.pth"
    if not path.exists():
        n = 7
        g = torch.Generator().manual_seed(0)
        torch.save({"iteration": 3, "model_state": {
            "xyz": torch.randn(n, 3, generator=g), "features_dc": torch.randn(n, 1, 3, generator=g),
            "features_rest": torch.randn(n, 15, 3, generator=g),
            "opacity": torch.randn(n, 1, generator=g), "scaling": torch.randn(n, 3, generator=g),
            "rotation": torch.randn(n, 4, generator=g)}}, path)
    return path


@pytest.mark.parametrize("fmt", ["npz", "pth", "ply"])
def test_load_model_matches_jax(run, fmt):
    path = {"npz": run / "run" / "final.npz", "ply": run / "run" / "final.ply",
            "pth": _pth(run)}[fmt]
    jg, jm = j_eval.load_model(str(path))
    tg, tm = t_eval.load_model(str(path), device="cpu")
    assert tg.capacity == jg.capacity
    np.testing.assert_array_equal(tg.alive.numpy(), np.asarray(jg.alive))
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(getattr(tg.params, k).numpy(),
                                      np.asarray(getattr(jg.params, k)), err_msg=k)
    assert set(tm) == set(jm)
    if fmt == "npz":
        assert tm["render"] == jm["render"] and tm["render"]["class_budgets"]
        np.testing.assert_array_equal(tm["pose_deltas"], jm["pose_deltas"])
        assert np.abs(tm["pose_deltas"]).max() > 0


@pytest.mark.parametrize("flags", [["--multihost"], ["--mesh-data", "2"],
                                   ["--mesh-model", "2"]], ids=["multihost", "mesh-data",
                                                                "mesh-model"])
def test_multihost_and_mesh_raise(flags, tmp_path, monkeypatch):
    """Outside torchrun and with no coordinator set, ``--multihost`` and a
    mesh of 2 raise before reading any video, naming torchrun."""
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
              "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        t_train.main(["--videos", str(tmp_path / "missing.mp4"), "--device", "cpu"] + flags)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_cli_writes_its_files_and_resumes(run, clip):
    """tests/test_cli_end_to_end.py's train half on the port, then
    ``--resume`` continues the iteration counter."""
    from gaussian_splatting_tpu.training.checkpoint import load_checkpoint as j_load

    out = run / "run"
    for f in ("final.npz", "final.ply", "metrics.jsonl", "config.json", "debug_reproj.png"):
        assert (out / f).exists(), f
    recs = _records(out / "metrics.jsonl")
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 1 and np.isfinite(losses).all()
    assert json.loads((out / "config.json").read_text())["iterations"] == 10
    rc = t_train.main([
        "--videos", clip, "--output", str(run / "resumed"), "--iterations", "12",
        "--batch-size", "2", "--frame-stride", "4", "--backend", "cuda", "--device", "cpu",
        "--image-scale", "0.5", "--optimize-poses", "--cache-dir", str(run / "cache"),
        "--use-sfm-cache", "--resume", str(out / "final.npz")])
    assert rc == 0
    state, _ = j_load(str(run / "resumed" / "final.npz"))
    assert int(state.iteration) == 12
