"""Worker processes for the port's mesh tests (``test_torch_parallel.py``,
``test_torch_trainer_mesh.py``): each job runs in ``world`` spawned CPU
processes joined by a gloo process group, rendezvous through a file under
the test's temporary directory. This module imports only torch, numpy and
the port: spawned children import it to find their job, and importing JAX
there would cost seconds a rank.

A job is ``job(rank, world, tmp, *args)``; what it returns on each rank
is pickled to ``<tmp>/rank<r>.pkl`` and ``run_ranks`` returns the list.
"""

import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=60)


def init_gloo(rank, world, path):
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=world, timeout=TIMEOUT)


def _entry(rank, job, world, tmp, args):
    torch.set_num_threads(1)
    init_gloo(rank, world, os.path.join(tmp, "pg"))
    out = job(rank, world, tmp, *args)
    if dist.is_initialized():
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(job, world, tmp, *args):
    import torch.multiprocessing as mp

    mp.start_processes(_entry, args=(job, world, str(tmp), args), nprocs=world,
                       start_method="spawn")
    out = []
    for r in range(world):
        with open(os.path.join(str(tmp), f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# ---- the sharded step (test_torch_parallel.py) ------------------------------


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def _one_step(mesh, cfg, arrays, images, viewmats, Ks, view_idx, width, height, backend,
              sh_degree=0):
    """One sharded step from ``arrays``: (gathered state arrays, metrics,
    the shard shapes of the capacity-leading tensors, the collectives)."""
    from gaussian_splatting_tpu_torch.models.gaussians import (
        train_state_from_numpy,
        train_state_to_numpy,
    )
    from gaussian_splatting_tpu_torch.parallel import make_sharded_train_step
    from gaussian_splatting_tpu_torch.parallel import sharded_step as ss
    from gaussian_splatting_tpu_torch.training.step import ViewBatch

    step, band_h, h_pad = make_sharded_train_step(cfg, mesh, width, height, sh_degree,
                                                  backend, 2.0)
    state = ss.shard_state(train_state_from_numpy(
        {k: np.array(v) for k, v in arrays.items()}, device="cpu"), mesh)
    batch = ViewBatch(ss.pad_images_for_bands(torch.as_tensor(images), h_pad),
                      torch.as_tensor(viewmats), torch.as_tensor(Ks),
                      None if view_idx is None else torch.as_tensor(view_idx))
    ss.reset_collectives()
    state, m = step(state, batch)
    coll = ss.collectives()
    shapes = {k: tuple(v.shape) for k, v in train_state_to_numpy(state).items()}
    full = train_state_to_numpy(ss.gather_state(state, mesh))
    return full, _metrics(m), shapes, coll, (band_h, h_pad)


def sharded_step_job(rank, world, tmp, case):
    """The 2x2 mesh: the mesh's shape and errors, the dense and pose steps
    on backend ``ref``, a few steps that must descend, then a 1x2 mesh on
    ranks 0-1 for the ``cuda`` backend (its kernels' plain versions)."""
    from gaussian_splatting_tpu_torch.parallel import make_mesh
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig

    out = {}
    mesh = make_mesh(2, 2, device="cpu")
    out["mesh"] = (mesh.shape, mesh.coord, mesh.model_ranks, mesh.rank)
    errors = []
    for shape in ((1, 2), (4, 2)):
        try:
            make_mesh(*shape, device="cpu")
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    W, H = case["width"], case["height"]
    for name in ("dense", "poses"):
        c = case[name]
        out[name] = _one_step(mesh, TrainingConfig(**c["cfg"]), c["arrays"], *c["batch"], W, H,
                              "ref")
    # A few steps from the dense case's state must descend.
    from gaussian_splatting_tpu_torch.models.gaussians import train_state_from_numpy
    from gaussian_splatting_tpu_torch.parallel import make_sharded_train_step
    from gaussian_splatting_tpu_torch.parallel import sharded_step as ss
    from gaussian_splatting_tpu_torch.training.step import ViewBatch

    c = case["dense"]
    step, _, _ = make_sharded_train_step(TrainingConfig(**c["cfg"]), mesh, W, H, 0, "ref", 2.0)
    state = ss.shard_state(train_state_from_numpy(
        {k: np.array(v) for k, v in c["arrays"].items()}, device="cpu"), mesh)
    batch = ViewBatch(*(torch.as_tensor(x) for x in c["batch"][:3]))
    out["losses"] = [float(step(state, batch)[1]["loss"]) for _ in range(case["n_steps"])]

    dist.destroy_process_group()
    if rank < 2:
        init_gloo(rank, 2, os.path.join(tmp, "pg2"))
        mesh = make_mesh(1, 2, device="cpu")
        c = case["cuda"]
        out["cuda"] = _one_step(mesh, TrainingConfig(**c["cfg"]), c["arrays"], *c["batch"],
                                case["cuda_width"], case["cuda_height"], "cuda",
                                sh_degree=3)
    return out


# ---- the trainer on a mesh (test_torch_trainer_mesh.py) ---------------------


def trainer_job(rank, world, tmp, cfg_kw, ds_arrays, points, out_dir):
    """``GaussianTrainer.train`` on the mesh its config names, with
    ``save_checkpoint`` counted; and ``train_cli.make_cli_mesh`` on the same
    world."""
    import json

    from gaussian_splatting_tpu_torch import train_cli
    from gaussian_splatting_tpu_torch.models.gaussians import train_state_to_numpy
    from gaussian_splatting_tpu_torch.training import trainer as trainer_mod
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig

    saves = []
    save = trainer_mod.save_checkpoint

    def counted(path, *a, **k):
        saves.append(os.path.basename(path))
        return save(path, *a, **k)

    trainer_mod.save_checkpoint = counted
    cfg = TrainingConfig(**cfg_kw)
    trainer = trainer_mod.GaussianTrainer(cfg, device="cpu")
    state = trainer.train(trainer_mod.ViewDataset(*ds_arrays), out_dir, points=points)
    cli_mesh = train_cli.make_cli_mesh(cfg, False, torch.device("cpu"))
    out = {"saves": saves, "capacity": int(state.gauss.capacity),
           "n_alive": int(state.gauss.n_alive()), "mesh": trainer.mesh.shape,
           "cli_mesh": cli_mesh.shape, "iteration": int(state.iteration)}
    if rank == 0:
        out["state"] = train_state_to_numpy(state)
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            out["records"] = [json.loads(line) for line in f]
    return out
