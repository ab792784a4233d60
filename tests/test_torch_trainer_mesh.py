"""PyTorch port, the trainer on a mesh: ``GaussianTrainer`` with
``mesh_data=2, mesh_tile=2`` in 4 spawned CPU ranks over gloo
(``torch_mesh_workers.trainer_job``) against the port's single-device
trainer from the same seeds, in the setting of
``tests/test_trainer_mesh.py:14-80`` scaled down (16 iterations, densify
events at 5, 10 and 15 taking the top half, the third one growing the
capacity from 4096: 1800 initial gaussians, capacity 1.5 x 1800 rounded up
to 2048).

The population trajectory is held exactly: the densify selection takes
the top k of n_alive by rank, so the float32 reduction-order noise between
the mesh's and the single device's gradients must not change any event's
counts. Only rank 0 writes files.
"""

import json

import numpy as np
import pytest
import torch

from gaussian_splatting_tpu_torch import train_cli
from gaussian_splatting_tpu_torch.training.checkpoint import load_checkpoint
from gaussian_splatting_tpu_torch.training.config import TrainingConfig
from gaussian_splatting_tpu_torch.training.trainer import GaussianTrainer, ViewDataset
from gaussian_splatting_tpu_torch.models.gaussians import train_state_to_numpy
from test_training import _synthetic_scene
from torch_mesh_workers import run_ranks, trainer_job

CFG = dict(iterations=16, batch_size=2, backend="ref", initial_gaussians=1800,
           max_gaussians=6000, densify_from_iteration=4, densify_interval=5,
           densify_topk_fraction=0.5, val_interval=1000, checkpoint_interval=1000,
           log_scalar_interval=5, sh_increment_interval=100, sh_degree_max=0,
           log_image_interval=0)
DENSIFY_KEYS = ("densify/cloned", "densify/split", "densify/pruned", "densify/n_before",
                "densify/n_after")


def _events(records):
    return [{k: r[k] for k in DENSIFY_KEYS} for r in records if "densify/n_after" in r]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank mesh run, then the single-device run."""
    rng = np.random.default_rng(0)
    ds, gt_means = _synthetic_scene(rng, n_views=6)
    points = np.concatenate([
        gt_means + 0.02 * np.random.default_rng(i).normal(size=gt_means.shape).astype(np.float32)
        for i in range(20)])  # 600 points -> n_init = 3x = 1800 in a capacity of 4096
    arrays = (ds.images, ds.viewmats, ds.Ks)
    tmp = tmp_path_factory.mktemp("trainer_mesh")
    ranks = run_ranks(trainer_job, 4, tmp, dict(CFG, mesh_data=2, mesh_tile=2), arrays, points,
                      str(tmp / "mesh"))
    single = GaussianTrainer(TrainingConfig(**CFG), device="cpu")
    state = single.train(ViewDataset(*arrays), str(tmp / "single"), points=points)
    with open(tmp / "single" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    return {"ranks": ranks, "dir": tmp / "mesh",
            "single": {"capacity": int(state.gauss.capacity),
                       "n_alive": int(state.gauss.n_alive()), "records": records}}


def test_mesh_trainer_matches_single_device_trainer(runs):
    """Densify events and capacity growth equal event for event; the
    capacity stays divisible by the model axis."""
    single = runs["single"]
    ev_s = _events(single["records"])
    assert len(ev_s) == 3, ev_s
    assert any(e["densify/cloned"] + e["densify/split"] > 0 for e in ev_s)
    assert single["capacity"] > 4096, "capacity growth never fired"
    for out in runs["ranks"]:
        assert out["mesh"] == out["cli_mesh"] == {"data": 2, "model": 2}
        assert out["iteration"] == CFG["iterations"]
        assert out["capacity"] == single["capacity"] and out["capacity"] % 2 == 0
        assert out["n_alive"] == single["n_alive"]
    ev_m = _events(runs["ranks"][0]["records"])
    assert ev_m == ev_s, (ev_m, ev_s)
    losses_m = [r["loss"] for r in runs["ranks"][0]["records"] if "loss" in r]
    losses_s = [r["loss"] for r in single["records"] if "loss" in r]
    assert len(losses_m) == len(losses_s) == 3 and np.isfinite(losses_m).all()
    np.testing.assert_allclose(losses_m, losses_s, rtol=1e-4)


def test_only_rank_zero_writes(runs):
    saves = [out["saves"] for out in runs["ranks"]]
    assert saves[0] == ["pre_growth.npz", "final.npz"], saves[0]
    assert saves[1:] == [[], [], []]
    names = {p.name for p in runs["dir"].iterdir()}
    assert {"final.npz", "final.ply", "metrics.jsonl", "config.json",
            "pre_growth.npz"} <= names
    logged = [r["_step"] for r in runs["ranks"][0]["records"] if "loss" in r]
    assert logged == [5, 10, 15]  # one record a log, not one a rank


def test_final_npz_reloads_to_the_gathered_state(runs):
    """``train`` returns the gathered state on every rank; ``final.npz``
    reloads in one process equal to it."""
    loaded, meta = load_checkpoint(str(runs["dir"] / "final.npz"), device="cpu")
    got = train_state_to_numpy(loaded)
    want = runs["ranks"][0]["state"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert meta["render"]["backend"] == "ref"


def test_mesh_without_its_processes_names_torchrun(monkeypatch, tmp_path):
    """A world that is not D x M: ``train_cli`` raises an error naming
    torchrun before reading any video, and so does the trainer's mesh."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node=4"):
        train_cli.main(["--videos", str(tmp_path / "none.mp4"), "--output", str(tmp_path / "o"),
                        "--device", "cpu", "--mesh-data", "2", "--mesh-model", "2"])
    trainer = GaussianTrainer(TrainingConfig(**dict(CFG, mesh_data=2)), device="cpu")
    ds = ViewDataset(np.zeros((2, 16, 16, 3), np.uint8), np.tile(np.eye(4, dtype=np.float32),
                                                                 (2, 1, 1)),
                     np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)))
    with pytest.raises(ValueError, match=r"mesh \(2x1\) needs 2 devices, have 1"):
        trainer.train(ds, str(tmp_path / "t"))
    assert not (tmp_path / "t").exists()
    assert not torch.distributed.is_initialized()
