"""The device mesh and multi-process bring-up on ``torch.distributed``
(counterpart of ``gaussian_splatting_tpu/parallel/mesh.py``).

A ("data", "model") mesh of D x M ranks, the rendering workload's analogs
of the classic axes:

- ``data``  view parallelism: the camera batch shards across ranks;
- ``model`` used twice a step: phase 1 projects and shades 1/M of the
  gaussians on each rank and all-gathers the compact screen-space tensors;
  phase 2 shards the image's tile rows (bands) over the same axis, each
  rank rasterizing its band against all gaussians. The gathers'
  reduce-scatter brings the per-gaussian gradients back already sharded
  (``parallel/sharded_step.py``).

One process drives one device. The JAX package runs a mesh from a single
process over all its devices; a PyTorch mesh of D x M > 1 needs D x M
processes, started by ``torchrun --nproc-per-node=D*M`` on one host or by
``init_multihost`` on each of several hosts. Collectives run over NCCL
between CUDA devices and over gloo on the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from gaussian_splatting_tpu_torch._device import DeviceLike, resolve_device

log = logging.getLogger(__name__)


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_multihost(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, device: DeviceLike = None,
                   timeout: Optional[datetime.timedelta] = None) -> int:
    """Multi-process bring-up before any mesh or device use:
    ``torch.distributed.init_process_group`` over NCCL when the process's
    device is CUDA (the default), over gloo when the caller asks for the
    CPU. Returns this process's rank.

    The arguments fall back to the JAX package's environment variables
    (``COORDINATOR_ADDRESS`` as ``host:port``, ``NUM_PROCESSES``,
    ``PROCESS_ID``) and then to torchrun's (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``). A CUDA process takes the device
    ``cuda:LOCAL_RANK`` (0 when ``LOCAL_RANK`` is unset) and makes it
    current."""
    dev = resolve_device(device)
    env = os.environ
    coordinator = coordinator or env.get("COORDINATOR_ADDRESS")
    if not coordinator and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    n = num_processes or env.get("NUM_PROCESSES") or env.get("WORLD_SIZE")
    pid = process_id if process_id is not None else env.get("PROCESS_ID", env.get("RANK"))
    if not coordinator or n is None or pid is None:
        raise ValueError(
            "multi-process bring-up needs a coordinator address, a process count and a "
            "process id: pass them, set COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID, "
            "or start the processes with torchrun")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(_backend_for(dev), init_method=f"tcp://{coordinator}",
                            world_size=int(n), rank=int(pid), **kw)
    log.info("multi-process initialized: rank %d of %d over %s on %s", dist.get_rank(),
             dist.get_world_size(), dist.get_backend(), dev)
    return dist.get_rank()


@dataclasses.dataclass
class Mesh:
    """A ("data", "model") mesh over the initialized process group, as this
    rank sees it: ``shape`` {"data": D, "model": M}, this rank's ``coord``
    (d, m), the process groups along each axis, the world group, the global
    ranks of this rank's model group (in m order) and the rank's device."""

    shape: dict
    coord: Tuple[int, int]
    data_group: object
    model_group: object
    world_group: object
    model_ranks: Tuple[int, ...]
    device: torch.device

    @property
    def rank(self) -> int:
        return dist.get_rank()


def make_mesh(data: int = 1, model: int = 1, device: DeviceLike = None) -> Mesh:
    """The ("data", "model") mesh of ``data`` x ``model`` ranks over the
    initialized process group, built with
    ``torch.distributed.device_mesh.init_device_mesh``; rank r sits at
    (r // model, r % model). ``device`` is this rank's device (CUDA unless
    given; the current CUDA device). A 1 x 1 mesh with no process group
    initialized starts a group of one (NCCL on CUDA, gloo on the CPU)
    in-process. Raises ``ValueError`` when the world holds fewer or more
    ranks than the mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    need = data * model
    if not dist.is_initialized():
        if need > 1:
            raise ValueError(f"mesh ({data}x{model}) needs {need} devices, have 1: run one "
                             f"process a device (torchrun --nproc-per-node={need})")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(_backend_for(dev), store=dist.HashStore(), rank=0,
                                world_size=1)
    have = dist.get_world_size()
    if have < need:
        raise ValueError(f"mesh ({data}x{model}) needs {need} devices, have {have}")
    if have > need:
        raise ValueError(f"mesh ({data}x{model}) takes {need} processes, the world has "
                         f"{have}: start torchrun with --nproc-per-node={need}")
    dm = init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))
    d, m = dm.get_coordinate()
    model_group = dm.get_group("model")
    return Mesh(shape={"data": data, "model": model}, coord=(int(d), int(m)),
                data_group=dm.get_group("data"), model_group=model_group,
                world_group=dist.group.WORLD,
                model_ranks=tuple(dist.get_process_group_ranks(model_group)), device=dev)
