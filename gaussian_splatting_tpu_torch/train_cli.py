"""Training CLI (counterpart of ``gaussian_splatting_tpu/train_cli.py``):
videos -> SfM -> train -> export, with resume.

Usage:
  python -m gaussian_splatting_tpu_torch.train_cli --videos a.mp4 [b.mp4 ...] \
      --output runs/exp1 [--iterations N] [--resume ckpt.npz] [--device cpu] ...

On a mesh of D x M devices, one process a device:
  torchrun --nproc-per-node=D*M -m gaussian_splatting_tpu_torch.train_cli \
      --mesh-data D --mesh-model M --videos a.mp4 --output runs/exp1 ...

``--backend`` takes the port's names (``auto`` = ``cuda``, ``cuda``, ``ref``)
and ``--device`` (default ``cuda``) names the device the trainer runs on;
without CUDA a run raises unless it asks for the CPU.

A mesh (``--mesh-data`` x ``--mesh-model`` > 1) trains through
``parallel/sharded_step.py``. The JAX package drives a mesh from one
process; PyTorch needs one process a device, so such a run starts under
``torchrun --nproc-per-node=D*M`` (the CLI initializes the process group
from torchrun's variables) or, across hosts, with ``--multihost`` on each
host (``parallel.init_multihost``: ``COORDINATOR_ADDRESS``,
``NUM_PROCESSES``, ``PROCESS_ID``, or torchrun's variables). A world whose
size is not D x M raises. Rank 0 alone runs SfM and broadcasts its result
to the other ranks, so every rank trains on the same points and poses
without a shared cache directory; rank 0 alone writes the output.

The JAX package's persistent compile cache (``utils/cache.
enable_compile_cache``) has no counterpart: the port's kernels are built
once by ``ops/_build.py``.
"""

import argparse
import dataclasses
import logging
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="3D gaussian splatting trainer (PyTorch/CUDA)")
    p.add_argument("--videos", nargs="+", required=True, help="input video path(s)")
    p.add_argument("--output", default="./output", help="output directory")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--frame-stride", type=int, default=None)
    p.add_argument("--initial-gaussians", type=int, default=None)
    p.add_argument("--max-gaussians", type=int, default=None)
    p.add_argument("--matcher", choices=["sift", "orb"], default=None)
    p.add_argument("--focal-px", type=float, default=None)
    p.add_argument("--focal-35mm", type=float, default=None)
    p.add_argument("--image-scale", type=float, default=None)
    p.add_argument("--sh-degree", type=int, default=None)
    p.add_argument("--backend", choices=["auto", "cuda", "ref"], default=None)
    p.add_argument("--device", default="cuda",
                   help="device the trainer runs on (cuda, cuda:N or cpu)")
    p.add_argument("--tile-size", type=int, default=None)
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--use-sfm-cache", action="store_true",
                   help="reuse cached SfM results (reference forces re-run)")
    p.add_argument("--densify-topk", type=float, default=None,
                   help="densify the top FRACTION of gaussians by grad rank "
                        "each event (scale-free alternative to the absolute "
                        "grad threshold)")
    p.add_argument("--optimize-poses", action="store_true",
                   help="refine camera poses jointly with the gaussians "
                        "(per-train-view se(3) deltas; the SfM bootstrap "
                        "poses are only a coarse init)")
    p.add_argument("--pose-lr", type=float, default=None,
                   help="initial pose learning rate (decays to pose_lr_final)")
    p.add_argument("--pose-start-iter", type=int, default=None,
                   help="iteration at which pose refinement starts")
    p.add_argument("--grad-buffer-frac", type=float, default=None,
                   help="gradient-buffer capacity as a fraction of the exact "
                        "bound (<1 shrinks the backward reduce sort; the "
                        "trainer probes occupancy and grows it on drops)")
    p.add_argument("--deform", action="store_true",
                   help="Deformable 3D Gaussians: a deformation MLP moves the gaussians by "
                        "each frame's time (a dynamic scene; one device)")
    p.add_argument("--deform-field", choices=("mlp", "hexplane"), default=None,
                   help="with --deform: 'mlp' (Deformable 3D Gaussians, the default) or "
                        "'hexplane' (4D Gaussian Splatting: a multi-resolution HexPlane "
                        "field and a small decoder, offsets before the activations)")
    p.add_argument("--deform-warmup", type=int, default=None,
                   help="static iterations before the deformation starts (4DGS's coarse "
                        "stage)")
    p.add_argument("--surfels", action="store_true",
                   help="2D Gaussian Splatting: flat surfels with the depth-distortion and "
                        "normal-consistency terms, for depth, normals and surfaces (one device)")
    p.add_argument("--resume", default=None, help="checkpoint .npz to resume from")
    p.add_argument("--mesh-data", type=int, default=None)
    p.add_argument("--mesh-model", type=int, default=None)
    p.add_argument("--multihost", action="store_true",
                   help="multi-host training: initialize the process group from "
                        "COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID (or torchrun's "
                        "variables) before any device use")
    p.add_argument("--wandb-mode", default=None)
    p.add_argument("--wandb-project", default=None)
    p.add_argument("--wandb-run-name", default=None)
    return p


def config_from_args(args):
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig

    cfg = TrainingConfig()
    mapping = {
        "iterations": "iterations", "batch_size": "batch_size",
        "frame_stride": "frame_stride", "initial_gaussians": "initial_gaussians",
        "max_gaussians": "max_gaussians", "matcher": "matcher",
        "image_scale": "image_scale", "sh_degree": "sh_degree_max",
        "backend": "backend", "tile_size": "tile_size", "cache_dir": "cache_dir",
        "mesh_data": "mesh_data", "mesh_model": "mesh_tile",
        "densify_topk": "densify_topk_fraction",
        "pose_lr": "pose_lr_init", "pose_start_iter": "pose_start_iter",
        "grad_buffer_frac": "grad_buffer_frac", "deform_warmup": "deform_warmup",
        "deform_field": "deform_field",
        "wandb_mode": "wandb_mode", "wandb_project": "wandb_project",
        "wandb_run_name": "wandb_run_name",
    }
    overrides = {}
    for argname, field in mapping.items():
        v = getattr(args, argname, None)
        if v is not None:
            overrides[field] = v
    if getattr(args, "optimize_poses", False):
        overrides["optimize_poses"] = True
    if getattr(args, "deform", False):
        overrides["deform"] = True
    if getattr(args, "surfels", False):
        overrides["surfels"] = True
    return dataclasses.replace(cfg, **overrides)


def build_dataset(merged, image_scale=1.0):
    """merged_data dict -> ViewDataset (single shared resolution). Each
    frame's time is its index over its video's last kept index, in [0, 1]:
    the deformation's t."""
    import cv2

    from gaussian_splatting_tpu_torch.training.trainer import ViewDataset
    from gaussian_splatting_tpu_torch.video.loader import VideoLoader

    images, viewmats, Ks, times = [], [], [], []
    target_wh = None
    for vi, info in enumerate(merged["video_info"]):
        loader = VideoLoader(info["path"])
        poses = np.asarray(merged["all_poses"][vi])
        K = np.asarray(merged["all_intrinsics"][vi], np.float64).copy()
        fidx = np.asarray(merged["frame_indices"][vi])
        loader.preload(fidx[: len(poses)].tolist())
        last = max(int(fidx[: len(poses)].max()) if len(poses) else 0, 1)
        for j, fi in enumerate(fidx[: len(poses)]):
            frame = loader.get_frame(int(fi))
            if frame is None:
                continue
            if image_scale != 1.0:
                frame = cv2.resize(frame, None, fx=image_scale, fy=image_scale,
                                   interpolation=cv2.INTER_AREA)
            h, w = frame.shape[:2]
            if target_wh is None:
                target_wh = (w, h)
            elif (w, h) != target_wh:
                frame = cv2.resize(frame, target_wh)
            Kj = K * image_scale
            Kj[2, 2] = 1.0
            images.append(frame[:, :, ::-1].copy())  # BGR -> RGB
            viewmats.append(poses[j].astype(np.float32))
            Ks.append(Kj.astype(np.float32))
            times.append(float(fi) / last)
        loader.release()
    return ViewDataset(
        images=np.stack(images), viewmats=np.stack(viewmats), Ks=np.stack(Ks),
        times=np.asarray(times, np.float32),
    )


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)

    from gaussian_splatting_tpu_torch._device import resolve_device
    from gaussian_splatting_tpu_torch.training.trainer import GaussianTrainer
    from gaussian_splatting_tpu_torch.utils.metrics import MetricsLogger
    from gaussian_splatting_tpu_torch.video.processor import MultiVideoProcessor

    device = resolve_device(args.device)  # before SfM: a missing card fails at once
    mesh = make_cli_mesh(cfg, args.multihost, device)
    is_main = mesh is None or mesh.rank == 0
    merged = None
    if is_main:
        proc = MultiVideoProcessor(
            cache_dir=cfg.cache_dir, matcher=cfg.matcher,
            focal_px=args.focal_px, focal_35mm=args.focal_35mm,
        )
        merged = proc.process_videos(
            args.videos, stride=cfg.frame_stride, use_cache=args.use_sfm_cache
        )
    if mesh is not None:
        import torch.distributed as dist

        box = [merged]
        dist.broadcast_object_list(box, src=0)
        merged = box[0]
    dataset = build_dataset(merged, image_scale=cfg.image_scale)

    logger = MetricsLogger(
        args.output, config=dataclasses.asdict(cfg),
        wandb_mode=cfg.wandb_mode, wandb_project=cfg.wandb_project,
        wandb_entity=cfg.wandb_entity, wandb_run_name=cfg.wandb_run_name,
        wandb_tags=cfg.wandb_tags,
    ) if is_main else None
    trainer = GaussianTrainer(cfg, logger=logger, device=device, mesh=mesh)
    trainer.train(
        dataset, args.output,
        points=np.asarray(merged["points_3d"]),
        colors=np.asarray(merged["colors"]),
        resume_from=args.resume,
    )
    if logger is not None:
        logger.finish()
    return 0


def make_cli_mesh(cfg, multihost: bool, device):
    """The run's mesh, or None on one device. With ``multihost``, or a mesh
    above 1 x 1 under torchrun, the process group is initialized first
    (``parallel.init_multihost``). Raises when the world does not hold
    exactly mesh_data x mesh_tile processes."""
    n = cfg.mesh_data * cfg.mesh_tile
    if not multihost and n == 1:
        return None
    import torch.distributed as dist

    from gaussian_splatting_tpu_torch.parallel.mesh import init_multihost, make_mesh

    if not dist.is_initialized() and (multihost or "WORLD_SIZE" in os.environ):
        init_multihost(device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(
            f"a {cfg.mesh_data}x{cfg.mesh_tile} mesh runs one process a device, {n} in all, "
            f"and this run has {world}: start it with torchrun --nproc-per-node={n} "
            f"(or --multihost on each host)")
    return make_mesh(cfg.mesh_data, cfg.mesh_tile, device=device)


if __name__ == "__main__":
    sys.exit(main())
