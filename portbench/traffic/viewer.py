"""Viewer traffic: one viewer, closed loop, a new pose every frame.

Set-up makes the cell's true scene on the device from the seed and a
``GaussianRasterizer`` with its render cache off. A continuous camera path
gives one numpy world-to-camera matrix a frame, as an interactive
viewer passes them. Each frame runs from the call of ``render_single`` to
the synchronize after it. Warm-up renders poses before the path's window
part; frames drawn from the seed are kept and held against the reference
once the window has closed.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import harness
from portbench import scene as S
from portbench.reference import render as R
from portbench.trace import Stretch


def run(ctx: harness.Ctx) -> harness.Outcome:
    from gaussian_splatting_tpu_torch.ops.facade import GaussianRasterizer

    dev = ctx.device
    c, tr, lim = ctx.config, ctx.workload["traffic"], ctx.workload["limits"]
    W, H, N, deg = c["width"], c["height"], c["gaussians"], c["sh_degree"]
    cams = c["cameras"]

    harness.note(ctx, f"{ctx.cell}: seed {ctx.seed}, {N} gaussians, {W}x{H}")
    scene = S.true_scene(N, c["scene"], ctx.seed, dev)
    params = {"means3D": scene["means"], "rotations": scene["quats"],
              "scales": scene["log_scales"], "opacities": scene["logit_opacities"],
              "shs": torch.cat([scene["features_dc"], scene["features_rest"]], dim=1)}
    K = R.intrinsics(W, H, cams["focal_px"]).numpy()
    warm = int(tr["warmup_frames"])
    path = S.path_views(warm + int(tr["max_frames"]) + int(tr["trace_frames"]), cams)
    rng = S.numpy_rng(ctx.seed, 6)
    sample_every = int(tr["sample_every"])
    offset = int(rng.integers(0, sample_every))
    raster = GaussianRasterizer(W, H, backend="auto", enable_caching=False, sh_degree=deg,
                                device=dev)

    def frame(i):
        return raster.render_single(params, {"world_view_transform": path[i], "K": K})

    harness.reset_peak(dev)
    for i in range(warm):
        frame(i)
    harness.sync(dev)
    t_open = time.perf_counter()
    setup_s = time.time() - ctx.t_start
    times, kept = [], {}
    deadline = t_open + ctx.seconds
    n = 0
    while time.perf_counter() < deadline or n == 0:
        if warm + n >= len(path):
            raise RuntimeError("the camera path ran out before the window closed")
        t0 = time.perf_counter()
        out = frame(warm + n)
        harness.sync(dev)
        times.append(time.perf_counter() - t0)
        if n % sample_every == offset and len(kept) < int(tr["max_checked"]):
            kept[warm + n] = out.render
        n += 1
    t_close = time.perf_counter()
    stretch = None
    if ctx.trace:
        # The profiler slows the host and leaves it slower after it stops:
        # the traced frames come after the window.
        stretch = Stretch(dev)
        stretch.start()
        for i in range(int(tr["trace_frames"])):
            frame(warm + n + i)
        harness.sync(dev)
        stretch.stop(int(tr["trace_frames"]))
    peak = harness.peak_bytes(dev)
    window_s = t_close - t_open
    hits = raster.cache_stats()["hits"]
    harness.note(ctx, f"window closed: {n} frames in {window_s:.3f} s, set-up {setup_s:.2f} s")
    summary = stretch.summarize(ctx.trace_file) if stretch else None

    # ---- the reference ----------------------------------------------------------
    errs, pairs, isects = [], [], []
    sh = params["shs"]
    for i, img in sorted(kept.items()):
        want, b, n_pairs = R.render(scene["means"], scene["quats"], scene["log_scales"],
                                    scene["logit_opacities"], sh, torch.as_tensor(path[i]),
                                    torch.as_tensor(K), W, H, deg, ts=raster.tile_size)
        errs.append(float((img.float() - want).abs().max()))
        pairs.append(n_pairs)
        isects.append(b.n_isect)
        del want, b
    del kept
    gc.collect()
    harness.note(ctx, f"reference: frames {len(errs)}, errors {errs}, intersections {isects}, "
                      f"pairs {pairs}")
    times_ms = 1e3 * np.asarray(times)
    view = {"pairs": float(np.mean(pairs)), "n_isect": float(np.mean(isects)),
            "pixels": float(W * H), "tiles": float(R.cdiv(W, raster.tile_size)
                                                   * R.cdiv(H, raster.tile_size))}
    layer = {"kind": "render", "trace": summary, "view": view, "views_per_unit": 1,
             "n_gaussians": float(N), "sh_degree": deg, "window_s": window_s, "units": n}
    checks = {"frame_max_abs_err": max(errs), "cache_hits": float(hits)}
    return harness.Outcome(
        attempted=n, failed=0,
        end_to_end={"render_frames_per_s": n / window_s,
                    "render_ms_p95": float(np.percentile(times_ms, 95)),
                    "setup_s": setup_s, "peak_mem_gib": peak / 2**30},
        checks={k: [float(v), float(lim[k])] for k, v in checks.items()},
        peak_bytes=peak, layer=layer)
