"""PyTorch port, the mesh: ``parallel/mesh.py`` and
``parallel/sharded_step.py`` on the CPU over gloo, against the JAX
package's sharded step on its 8-device virtual CPU mesh and against the
port's own single-device step.

One spawned job of 4 ranks (``torch_mesh_workers.sharded_step_job``) runs
every mesh case of this file; the JAX side and the port's single-device
steps run in the test process.

Tolerances, as ``tests/test_parallel.py:82-91``: loss rtol 2e-6 (atol
1e-7), L1 rtol 1e-5 (atol 1e-6): the same float32 sums in another order.
Parameters after one Adam step under the sign-flip rule
(``tests/test_torch_training.py``): within 1e-5 where |g| exceeds 1e-3 of
the group's largest gradient, within 2 lr elsewhere. Pose deltas rtol
1e-4, atol 1e-7, as ``tests/test_parallel.py:157``.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.models.gaussians import init_from_points as j_init
from gaussian_splatting_tpu.parallel.mesh import make_mesh as j_make_mesh
from gaussian_splatting_tpu.parallel.sharded_step import (
    make_sharded_train_step as j_sharded_step,
)
from gaussian_splatting_tpu.parallel.sharded_step import pad_images_for_bands as j_pad
from gaussian_splatting_tpu.training.config import TrainingConfig as JConfig
from gaussian_splatting_tpu.training.optimizer import adam_init as j_adam_init
from gaussian_splatting_tpu.training.step import TrainState as JTrainState
from gaussian_splatting_tpu.training.step import ViewBatch as JViewBatch
from gaussian_splatting_tpu.training.step import pose_state_init as j_pose_init
from gaussian_splatting_tpu_torch.core.cameras import look_at, make_intrinsics
from gaussian_splatting_tpu_torch.models.gaussians import (
    train_state_from_numpy,
    train_state_to_numpy,
)
from gaussian_splatting_tpu_torch.parallel import mesh as t_mesh
from gaussian_splatting_tpu_torch.parallel import pad_images_for_bands
from gaussian_splatting_tpu_torch.parallel.sharded_step import (
    band_geometry,
    shard_state,
)
from gaussian_splatting_tpu_torch.training.config import TrainingConfig
from gaussian_splatting_tpu_torch.training.step import ViewBatch, make_train_step
from test_training import _synthetic_scene
from torch_mesh_workers import run_ranks, sharded_step_job
from torch_parity import PARAM_KEYS, jax_train_state_arrays, train_state_arrays

LRS = {"quats": 1e-3, "log_scales": 5e-3, "logit_opacities": 0.05, "features_dc": 2.5e-3,
       "features_rest": 1.25e-4}
N_STEPS = 20  # as tests/test_parallel.py:49
CUDA_W = CUDA_H = 64  # two bands of 32 rows, no pad row


def _jax_case(seed, poses):
    """``tests/test_parallel.py::_setup`` (4 views at 32x32, 64 gaussians in
    a capacity of 128), batch of views 0 and 1: the state arrays, the
    batch, and the JAX sharded step's state and metrics at 2x2."""
    rng = np.random.default_rng(seed)
    ds, gt_means = _synthetic_scene(rng, n_views=4, width=32, height=32)
    g = j_init(gt_means + rng.normal(size=gt_means.shape).astype(np.float32) * 0.05,
               None, 64, capacity=128)
    ts = JTrainState(gauss=g, opt=j_adam_init(g.params), iteration=jnp.zeros((), jnp.int32))
    kw = dict(batch_size=2, backend="ref")
    vidx = None
    if poses:
        ts = ts._replace(poses=j_pose_init(ds.viewmats.shape[0]),
                         iteration=jnp.full((), 5, jnp.int32))
        kw.update(optimize_poses=True, pose_start_iter=0, pose_lr_init=1e-3,
                  pose_lr_final=1e-4)
        vidx = np.asarray([0, 1], np.int32)
    arrays = jax_train_state_arrays(ts)
    images = ds.images[:2].astype(np.float32) / 255.0
    batch = (images, ds.viewmats[:2].astype(np.float32), ds.Ks[:2].astype(np.float32), vidx)
    step, _, h_pad = j_sharded_step(JConfig(**kw), j_make_mesh(data=2, model=2), 32, 32, 0,
                                    "ref", 2.0, donate=False)
    jb = JViewBatch(images=j_pad(jnp.asarray(images), h_pad), viewmats=jnp.asarray(batch[1]),
                    Ks=jnp.asarray(batch[2]),
                    view_idx=None if vidx is None else jnp.asarray(vidx))
    js, jm = step(ts, jb)
    return ({"cfg": kw, "arrays": arrays, "batch": batch},
            jax_train_state_arrays(js), {k: float(v) for k, v in jm.items()})


def _cuda_case(seed):
    """150 gaussians with SH degree 3 and dead slots, 2 views at 64x64."""
    rng = np.random.default_rng(seed)
    arrays = train_state_arrays(rng, 150)
    eyes = [(0.4, -0.3, -3.5), (-0.8, 0.2, -3.2)]
    views = np.stack([look_at(e, (0.0, 0.0, 0.0), device="cpu").numpy() for e in eyes])
    Ks = np.stack([make_intrinsics(CUDA_W, CUDA_H, focal_px=60.0, device="cpu").numpy()] * 2)
    images = rng.uniform(0, 1, size=(2, CUDA_H, CUDA_W, 3)).astype(np.float32)
    return {"cfg": {"batch_size": 2}, "arrays": arrays, "batch": (images, views, Ks, None)}


def _single_step(case, width, height, backend, sh_degree):
    """The port's single-device step on a case: (state arrays, metrics)."""
    images, views, Ks, vidx = case["batch"]
    step = make_train_step(TrainingConfig(**case["cfg"]), width, height, sh_degree, backend,
                           2.0, device="cpu")
    state = train_state_from_numpy({k: np.array(v) for k, v in case["arrays"].items()},
                                   device="cpu")
    batch = ViewBatch(torch.as_tensor(images), torch.as_tensor(views), torch.as_tensor(Ks),
                      None if vidx is None else torch.as_tensor(vidx))
    state, m = step(state, batch)
    return train_state_to_numpy(state), {k: float(v) for k, v in m.items()}


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Everything this file asserts on: the 4-rank job's results beside the
    JAX sharded step's and the port's single-device step's."""
    dense, j_dense, jm_dense = _jax_case(0, poses=False)
    poses, j_poses, jm_poses = _jax_case(0, poses=True)
    cuda = _cuda_case(1)
    case = {"width": 32, "height": 32, "dense": dense, "poses": poses, "cuda": cuda,
            "cuda_width": CUDA_W, "cuda_height": CUDA_H, "n_steps": N_STEPS}
    ranks = run_ranks(sharded_step_job, 4, tmp_path_factory.mktemp("mesh"), case)
    return {"ranks": ranks, "case": case,
            "jax": {"dense": (j_dense, jm_dense), "poses": (j_poses, jm_poses)},
            "single": {"dense": _single_step(dense, 32, 32, "ref", 0),
                       "poses": _single_step(poses, 32, 32, "ref", 0),
                       "cuda": _single_step(cuda, CUDA_W, CUDA_H, "cuda", 3)}}


def _grad(arrays, k):
    """One step from zero moments leaves mu = (1 - b1) g."""
    return arrays[f"adam_mu/{k}"] / 0.1


def _assert_step_close(got, got_m, want, want_m, xyz_lr):
    np.testing.assert_allclose(got_m["l1"], want_m["l1"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_m["loss"], want_m["loss"], rtol=2e-6, atol=1e-7)
    lrs = dict(LRS, means=xyz_lr)
    for k in PARAM_KEYS:
        g = _grad(want, k)
        big = np.abs(g) > 1e-3 * (np.abs(g).max() + 1e-30)
        diff = np.abs(got[f"params/{k}"] - want[f"params/{k}"])
        assert diff[big].max(initial=0.0) < 1e-5, (k, diff[big].max())
        assert diff.max() <= 2 * lrs[k] * (1 + 1e-4), (k, diff.max())
    for k in ("alive", "xyz_grad_count", "max_radii2d", "adam_step", "iteration"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_make_mesh_shape_coords_and_errors(mesh_run):
    ranks = mesh_run["ranks"]
    for r, out in enumerate(ranks):
        shape, coord, model_ranks, rank = out["mesh"]
        assert shape == {"data": 2, "model": 2}
        assert rank == r and coord == (r // 2, r % 2)
        assert model_ranks == (2 * (r // 2), 2 * (r // 2) + 1)
        too_small, too_large = out["errors"][1], out["errors"][0]
        assert too_small == "mesh (4x2) needs 8 devices, have 4"
        assert "torchrun" in too_large


def test_make_mesh_one_by_one_in_process_and_needs_processes():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match=r"mesh \(2x2\) needs 4 devices, have 1.*torchrun"):
        t_mesh.make_mesh(2, 2, device="cpu")
    mesh = t_mesh.make_mesh(1, 1, device="cpu")
    try:
        assert mesh.shape == {"data": 1, "model": 1} and mesh.coord == (0, 0)
        assert mesh.device == torch.device("cpu") and dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_init_multihost_reads_jax_and_torchrun_variables(monkeypatch):
    calls = []
    monkeypatch.setattr(t_mesh.dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(t_mesh.dist, "get_rank", lambda: calls[-1][1]["rank"])
    monkeypatch.setattr(t_mesh.dist, "get_world_size", lambda: calls[-1][1]["world_size"])
    monkeypatch.setattr(t_mesh.dist, "get_backend", lambda: calls[-1][0][0])
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
              "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        t_mesh.init_multihost(device="cpu")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "1")
    assert t_mesh.init_multihost(device="cpu") == 1
    (backend,), kw = calls[-1]
    assert backend == "gloo" and kw["init_method"] == "tcp://10.0.0.1:1234"
    assert (kw["world_size"], kw["rank"]) == (2, 1)
    assert t_mesh.init_multihost("h:9", 4, 0, device="cpu") == 0  # arguments win
    assert calls[-1][1]["init_method"] == "tcp://h:9" and calls[-1][1]["world_size"] == 4
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(k)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert t_mesh.init_multihost(device="cpu") == 3
    kw = calls[-1][1]
    assert kw["init_method"] == "tcp://localhost:29500" and kw["world_size"] == 4


def test_pad_images_for_bands_and_band_geometry(rng):
    assert band_geometry(32, 16, 2) == (16, 32)
    assert band_geometry(48, 16, 2) == (32, 64)
    assert band_geometry(1080, 16, 1) == (1088, 1088)
    assert band_geometry(1080, 16, 4) == (272, 1088)
    imgs = rng.uniform(size=(2, 40, 24, 3)).astype(np.float32)
    got = pad_images_for_bands(torch.as_tensor(imgs), 64).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_pad(jnp.asarray(imgs), 64)))
    assert got.shape == (2, 64, 24, 3) and not got[:, 40:].any()
    same = torch.as_tensor(imgs)
    assert pad_images_for_bands(same, 40) is same


def test_shard_state_rejects_indivisible_capacity(rng):
    state = train_state_from_numpy(train_state_arrays(rng, 10), device="cpu")
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 3}, coord=(0, 1))
    with pytest.raises(ValueError, match="capacity 10 must divide model axis 3"):
        shard_state(state, mesh)
    half = shard_state(state, types.SimpleNamespace(shape={"data": 1, "model": 2},
                                                    coord=(0, 1)))
    np.testing.assert_array_equal(half.gauss.params.means.numpy(),
                                  state.gauss.params.means[5:].numpy())
    assert half.opt.step is state.opt.step and half.iteration is state.iteration


@pytest.mark.parametrize("name", ["dense", "poses"])
def test_sharded_step_matches_jax_sharded_step(mesh_run, name):
    """The 2x2 step against the JAX ``make_sharded_train_step`` on the 2x2
    virtual mesh: backend ``ref``, SH degree 0; every rank ends with the
    same gathered state."""
    want, want_m = mesh_run["jax"][name]
    for out in mesh_run["ranks"]:
        got, got_m = out[name][:2]
        _assert_step_close(got, got_m, want, want_m, want_m["xyz_lr"])
        assert set(got_m) == set(want_m)


@pytest.mark.parametrize("name", ["dense", "poses"])
def test_sharded_step_matches_single_device_step(mesh_run, name):
    want, want_m = mesh_run["single"][name]
    got, got_m = mesh_run["ranks"][0][name][:2]
    _assert_step_close(got, got_m, want, want_m, want_m["xyz_lr"])


def test_sharded_pose_refine_matches_jax(mesh_run):
    """Pose refinement at 2x2: the replicated (V, 6) deltas get the global
    gradient (an all-reduce over the world) and the same Adam update as the
    JAX sharded step; views outside the batch stay exactly zero."""
    want, want_m = mesh_run["jax"]["poses"]
    single = mesh_run["single"]["poses"][0]["poses/deltas"]
    assert np.abs(want["poses/deltas"][:2]).max() > 0, "pose update must actually move"
    for out in mesh_run["ranks"]:
        got, got_m = out["poses"][:2]
        np.testing.assert_allclose(got["poses/deltas"], want["poses/deltas"], rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(got["poses/deltas"], single, rtol=1e-4, atol=1e-7)
        assert np.all(got["poses/deltas"][2:] == 0)
        np.testing.assert_allclose(got_m["grad_norm/poses"], want_m["grad_norm/poses"],
                                   rtol=1e-4, atol=1e-7)


def test_zero_sharded_state_placement(mesh_run):
    """ZeRO: after a step every capacity-leading tensor holds C/M rows on
    every rank; the pose state and the counters are whole."""
    C = 128
    for out in mesh_run["ranks"]:
        shapes = out["poses"][2]
        for k, shape in shapes.items():
            if k.startswith("poses/"):
                assert shape == (4, 6), k
            elif k in ("adam_step", "iteration"):
                assert shape == (), k
            else:
                assert shape[0] == C // 2, (k, shape)


def test_step_collectives(mesh_run):
    """One step's collectives, the counterpart of
    ``tests/test_parallel.py:165-187``: the screen-space gather over
    ``model`` and its reduce-scatter transpose (once a view), the halo
    exchange in the forward and the backward, and no all-reduce of a
    capacity-length tensor over ``model``."""
    C = 128
    for out in mesh_run["ranks"]:
        coll = out["dense"][3]
        ops = [(op, axis) for op, axis, _ in coll]
        assert ops.count(("all_gather", "model")) == 1  # one view a data rank
        assert ops.count(("reduce_scatter", "model")) == 1
        assert ops.count(("halo", "model")) == 2  # forward and backward
        assert ("all_reduce", "data") in ops and ("all_reduce", "world") in ops
        assert not [c for c in coll if c[0] == "all_reduce" and c[1] == "model" and c[2] >= C]
        gather = [n for op, _, n in coll if op == "all_gather"][0]
        assert gather == C * 11


def test_sharded_steps_descend(mesh_run):
    for out in mesh_run["ranks"]:
        losses = out["losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert len({tuple(out["losses"]) for out in mesh_run["ranks"]}) == 1


def test_cuda_backend_one_by_two_matches_single_device(mesh_run):
    """The kernel backend (its plain versions on the CPU) on a 1x2 mesh,
    two bands of 32 rows at 64x64, SH degree 3: the overflow counters equal
    the single-device step's, the loss and parameters within the
    tolerances above."""
    want, want_m = mesh_run["single"]["cuda"]
    for out in mesh_run["ranks"][:2]:
        got, got_m, _, _, (band_h, h_pad) = out["cuda"]
        assert (band_h, h_pad) == (32, 64)
        for k in ("n_isect", "n_dropped", "n_budget_dropped", "n_grad_dropped"):
            assert got_m[f"stats/{k}"] == want_m[f"stats/{k}"], k
        assert want_m["stats/n_isect"] > 0
        _assert_step_close(got, got_m, want, want_m, want_m["xyz_lr"])
    assert "cuda" not in mesh_run["ranks"][2]
