"""Eval CLI (counterpart of ``gaussian_splatting_tpu/eval_cli.py``): load a
checkpoint (ours ``.npz``, a reference-style ``.pth``, or a ``.ply``), render
N evenly-spaced views against ground-truth frames, report L1/SSIM/PSNR, save
side-by-side PNGs, and re-export a PLY.

Usage:
  python -m gaussian_splatting_tpu_torch.eval_cli --model final.npz \
      --videos input.mp4 [--num-views 12] [--output eval_out] [--device cpu]

``--backend`` (``auto`` = ``cuda``, ``cuda``, ``ref``) and ``--device``
(default ``cuda``) work as in ``train_cli``. The render settings, the
compact class budgets among them, come from the checkpoint's metadata.
``--pose-align`` runs ``training.trainer.align_pose`` at a constant rate
with betas (0.9, 0.999, 1e-8), as the JAX eval CLI does; the trainer's
validation decays its rate instead. The video and image imports stay inside
``main``, so ``load_model`` imports without OpenCV.
"""

import argparse
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)


def load_model(path: str, device=None):
    """(GaussianState on ``device``, CUDA unless given; metadata dict) from a
    ``.npz`` checkpoint (its pose deltas under ``meta["pose_deltas"]``; a
    deforming checkpoint's canonical gaussians, with a warning), a
    reference ``.pth`` or a ``.ply``."""
    from gaussian_splatting_tpu_torch.training.checkpoint import (
        load_checkpoint,
        load_reference_pth,
    )

    if path.endswith(".npz"):
        state, meta = load_checkpoint(path, device=device)
        if state.deform is not None:
            # No per-view time here (Deformable 3D Gaussians and 4D Gaussian
            # Splatting alike): the canonical gaussians are evaluated.
            log.warning("%s holds a deformation (%s); evaluating its canonical scene, "
                        "undeformed", path, type(state.deform).__name__)
        if state.poses is not None:
            meta = dict(meta)
            meta["pose_deltas"] = state.poses.deltas.cpu().numpy()
        return state.gauss, meta
    if path.endswith(".pth"):
        return load_reference_pth(path, device=device), {}
    if path.endswith(".ply"):
        import dataclasses

        import torch

        from gaussian_splatting_tpu_torch.models.gaussians import (
            PARAM_KEYS,
            GaussianParams,
            empty_state,
        )
        from gaussian_splatting_tpu_torch.training.export import read_ply

        d = read_ply(path)
        n = len(d["means"])
        st = empty_state(max(n, 1), device=device)
        dev = st.alive.device
        params = GaussianParams(**{k: torch.tensor(d[k], device=dev) for k in PARAM_KEYS})
        return dataclasses.replace(st, params=params,
                                   alive=torch.ones((n,), dtype=torch.bool, device=dev)), {}
    raise ValueError(f"unknown model format: {path}")


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True, help=".npz / .pth / .ply checkpoint")
    p.add_argument("--videos", nargs="+", required=True)
    p.add_argument("--output", default="./eval_out")
    p.add_argument("--num-views", type=int, default=12)
    p.add_argument("--frame-stride", type=int, default=30)
    p.add_argument("--matcher", default="sift")
    p.add_argument("--use-sfm-cache", action="store_true", default=True)
    p.add_argument("--backend", choices=["auto", "cuda", "ref"], default="auto")
    p.add_argument("--device", default="cuda",
                   help="device the renders run on (cuda, cuda:N or cpu)")
    p.add_argument("--cache-dir", default="./cache")
    p.add_argument("--pose-align", type=int, default=0, metavar="STEPS",
                   help="test-time pose alignment: optimize one se(3) delta "
                        "per evaluated view (gaussians frozen) for STEPS Adam "
                        "steps before scoring — the BARF/CamP eval protocol "
                        "for models whose train poses were refined; reports "
                        "psnr_aligned next to the raw psnr")
    p.add_argument("--pose-align-lr", type=float, default=3e-3)
    args = p.parse_args(argv)

    import torch
    from PIL import Image

    from gaussian_splatting_tpu_torch._device import resolve_device
    from gaussian_splatting_tpu_torch.ops.render import render, resolve_backend
    from gaussian_splatting_tpu_torch.train_cli import build_dataset
    from gaussian_splatting_tpu_torch.training.export import export_state_ply
    from gaussian_splatting_tpu_torch.training.loss import psnr as psnr_fn
    from gaussian_splatting_tpu_torch.training.loss import ssim as ssim_fn
    from gaussian_splatting_tpu_torch.video.processor import MultiVideoProcessor

    dev = resolve_device(args.device)
    backend = resolve_backend(args.backend)
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    gauss, meta = load_model(args.model, device=dev)
    n_exported = export_state_ply(gauss, str(out / "model.ply"))
    log.info("model: %d gaussians", n_exported)

    proc = MultiVideoProcessor(matcher=args.matcher, cache_dir=args.cache_dir)
    merged = proc.process_videos(args.videos, stride=args.frame_stride,
                                 use_cache=args.use_sfm_cache)
    ds = build_dataset(merged)
    V = ds.num_views
    sel = np.unique(np.linspace(0, V - 1, min(args.num_views, V)).astype(int))

    width, height = ds.width, ds.height
    params = gauss.params
    masked_op = params.masked_opacities(gauss.alive)

    # Render with the training run's raster settings from the checkpoint
    # meta (tile cap, chunk, class budgets, SH degree) — a model trained
    # with an adaptive 256-tile cap must not be re-truncated to the default
    # 16 at eval time.
    rmeta = meta.get("render", {}) if isinstance(meta, dict) else {}
    tile_size = int(rmeta.get("tile_size", 16))
    raster_chunk = int(rmeta.get("raster_chunk", 256))
    max_tiles = int(rmeta.get("max_tiles_per_gaussian", 16))
    sh_degree = int(rmeta.get("sh_degree_max", 3))
    rasterize_mode = str(rmeta.get("rasterize_mode", "classic"))
    sort_buckets = int(rmeta.get("sort_buckets", 0))
    reduce_slices = int(rmeta.get("reduce_slices", 0))
    bucket_headroom = float(rmeta.get("partition_headroom", 1.5))
    budgets = rmeta.get("class_budgets")
    budgets = tuple(int(b) for b in budgets) if budgets else None
    if rmeta:
        log.info("render settings from checkpoint meta: tile=%d chunk=%d "
                 "max_tiles=%d sh=%d budgets=%s",
                 tile_size, raster_chunk, max_tiles, sh_degree, budgets)

    def render_raw(viewmat, K):
        return render(params.means, params.quats, params.log_scales, masked_op,
                      params.sh_coeffs, viewmat, K, width, height,
                      sh_degree=sh_degree, backend=backend,
                      tile_size=tile_size, raster_chunk=raster_chunk,
                      max_tiles_per_gaussian=max_tiles, class_budgets=budgets,
                      sort_buckets=sort_buckets, bucket_headroom=bucket_headroom,
                      reduce_slices=reduce_slices, rasterize_mode=rasterize_mode,
                      depth_grad=False, device=dev).render

    def render_view(viewmat, K):
        with torch.no_grad():
            return torch.clamp(render_raw(viewmat, K), 0.0, 1.0)

    # A model trained with --optimize-poses lives in its refined-pose gauge:
    # apply the checkpointed per-view deltas when this dataset is the same
    # one it trained on (same SfM cache -> same view count/order).
    viewmats = np.asarray(ds.viewmats)
    deltas = meta.get("pose_deltas") if isinstance(meta, dict) else None
    if deltas is not None and len(deltas) == V:
        from gaussian_splatting_tpu_torch.core.se3 import se3_exp

        viewmats = (se3_exp(torch.as_tensor(deltas)) @ torch.as_tensor(viewmats)).numpy()
        log.info("applied %d checkpointed train-pose deltas "
                 "(max |delta| %.2e)", V, float(np.abs(deltas).max()))
    elif deltas is not None:
        log.warning("checkpoint has %d pose deltas but dataset has %d views "
                    "— not applied", len(deltas), V)

    rows = []
    for i in sel:
        t0 = time.perf_counter()
        gt = torch.as_tensor(ds.images[i], device=dev).to(torch.float32) / 255.0
        vm = torch.as_tensor(viewmats[i], device=dev)
        K = torch.as_tensor(ds.Ks[i], device=dev)
        img = render_view(vm, K)
        m = {
            "view": int(i),
            "l1": float(torch.mean(torch.abs(img - gt))),
            "ssim": float(ssim_fn(img, gt)),
            "psnr": float(psnr_fn(img, gt)),
        }
        t1 = time.perf_counter()
        if args.pose_align > 0:
            from gaussian_splatting_tpu_torch.training.trainer import align_pose

            aligned = align_pose(lambda v: render_raw(v, K), vm, gt, args.pose_align,
                                 args.pose_align_lr, lr_decay=1.0, b1=0.9, b2=0.999, eps=1e-8)
            img = render_view(aligned, K)
            m["psnr_aligned"] = float(psnr_fn(img, gt))
        t2 = time.perf_counter()
        rows.append(m)
        side = np.concatenate([img.cpu().numpy(), gt.cpu().numpy()], axis=1)
        Image.fromarray((side * 255).astype(np.uint8)).save(
            out / f"view_{int(i):04d}.png")
        log.info("view %d: L1 %.4f SSIM %.4f PSNR %.2f (host ms: render + metrics %.1f, "
                 "alignment %.1f, png %.1f)", i, m["l1"], m["ssim"], m["psnr"],
                 (t1 - t0) * 1e3, (t2 - t1) * 1e3, (time.perf_counter() - t2) * 1e3)

    summary = {
        "num_views": len(rows),
        "l1": float(np.mean([r["l1"] for r in rows])),
        "ssim": float(np.mean([r["ssim"] for r in rows])),
        "psnr": float(np.mean([r["psnr"] for r in rows])),
        "per_view": rows,
    }
    if rows and "psnr_aligned" in rows[0]:
        summary["psnr_aligned"] = float(
            np.mean([r["psnr_aligned"] for r in rows]))
    with open(out / "metrics.json", "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: summary[k] for k in summary if k != "per_view"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
