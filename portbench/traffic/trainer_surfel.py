"""Surfel-trainer traffic: a 2D Gaussian Splatting training job (surfels,
batch 4 at 1080p) resumed from a checkpoint, closed loop.

It is the trainer traffic of ``traffic/trainer.py``, reused by import, with
surfels: the configuration's scene is made as the static cell makes it, and
each point becomes a surfel tangent to its surface (the shells, the ground
disc and the dome; a seeded twist about the normal), with the first two of
its three scales. The targets are rendered by the surfel reference
(``reference/surfel.py``) from that true scene; the checkpoint holds the
noisy surfels at the resume iteration, with Adam moments as the static state
has them. Spans are on from the window's open; a traced run's stretch hands
its attribution to the readers (``span_stretch``).

Checks, each beside its limit: the trainer cell's four, with the reference's
surfel steps, and ``surfel_map_gap``: of the first step's views, the worst
over the normal, expected-depth and distortion maps of max |program -
reference| over the reference map's RMS, on the pixels whose reference
alpha exceeds 0.5, and of the share of those pixels whose median depth
differs from the reference's by more than 1e-5 of it (another median
entry). A non-finite value in the program's maps reads as an infinite gap,
or as a differing median.
"""

from __future__ import annotations

import gc
import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import harness
from portbench import scene as S
from portbench import spans
from portbench.reference import render as R
from portbench.reference import surfel as RS
from portbench.reference import train as RT

T = harness.traffic_driver("trainer")
# A traced run's stretch records the program's spans and attributes to them.
T.Stretch = spans.SpanStretch
LEAVES = RT.PARAM_KEYS
MEDIAN_RTOL = 1e-5


class SurfelRecorder(T.Recorder):
    """The trainer cell's recorder, which also turns the program's spans on
    at the window's open and keeps the first step's rendered maps."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.maps0 = []
        self.spans_on = False
        self.prog = spans._profiling()

    def boundary(self):
        super().boundary()
        if self.in_window and not self.spans_on and self.prog is not None:
            self.prog.reset()
            self.prog.enable()
            self.spans_on = True

    def capture(self, render_fn):
        """``render_fn`` (the step's ``render``) keeping the first step's
        views' normal, depth, alpha, distortion and median depth maps on the
        host."""
        def capturing(*a, **k):
            out = render_fn(*a, **k)
            if self.steps == 0 and torch.is_grad_enabled() and out.normal is not None:
                self.maps0.append(torch.cat(
                    [out.depth[..., None], out.alpha[..., None], out.normal,
                     out.distortion[..., None], out.median_depth[..., None]], -1
                ).detach().float().cpu())
            return out

        return capturing


def _rotmat_to_quat(Rm: torch.Tensor) -> torch.Tensor:
    """(N, 4) w-first unit quaternions of rotations (N, 3, 3), the largest
    of the four candidate components first for stability."""
    m = Rm
    tr = m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]
    cands = torch.stack([tr, m[:, 0, 0], m[:, 1, 1], m[:, 2, 2]], -1)
    k = cands.argmax(-1)
    q = torch.empty((m.shape[0], 4), dtype=m.dtype, device=m.device)
    s = torch.sqrt(torch.clamp_min(1.0 + 2.0 * cands.gather(1, k[:, None])[:, 0] - tr, 1e-12))
    w = [m[:, 2, 1] - m[:, 1, 2], m[:, 0, 2] - m[:, 2, 0], m[:, 1, 0] - m[:, 0, 1]]
    o = [m[:, 0, 1] + m[:, 1, 0], m[:, 0, 2] + m[:, 2, 0], m[:, 1, 2] + m[:, 2, 1]]
    rows = {
        0: (0.5 * s, w[0] / (2 * s), w[1] / (2 * s), w[2] / (2 * s)),
        1: (w[0] / (2 * s), 0.5 * s, o[0] / (2 * s), o[1] / (2 * s)),
        2: (w[1] / (2 * s), o[0] / (2 * s), 0.5 * s, o[2] / (2 * s)),
        3: (w[2] / (2 * s), o[1] / (2 * s), o[2] / (2 * s), 0.5 * s),
    }
    for i, r in rows.items():
        sel = k == i
        q[sel] = torch.stack([x[sel] for x in r], -1)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def surface_normals(means: torch.Tensor, layout: dict) -> torch.Tensor:
    """(n, 3) unit normals of the scene's surfaces at its points, in
    ``scene.surface_points``' order: each shell point's nearest shell (by
    its ellipsoid equation) and that ellipsoid's gradient, the ground's +y,
    the dome's radial direction."""
    n = means.shape[0]
    n_obj = int(n * layout["object_share"])
    n_ground = int(n * layout["ground_share"])
    dev = means.device
    centres = torch.tensor(layout["object_centres"], device=dev)
    axes = torch.tensor(layout["object_axes"], device=dev)
    obj = means[:n_obj]
    rel = (obj[:, None, :] - centres[None]) / axes[None]
    which = (torch.linalg.norm(rel, dim=-1) - 1.0).abs().argmin(1)
    grad = (obj - centres[which]) / axes[which] ** 2
    ground = torch.zeros((n_ground, 3), device=dev)
    ground[:, 1] = 1.0
    dome = means[n_obj + n_ground:]
    out = torch.cat([grad, ground, dome])
    return out / torch.clamp_min(torch.linalg.norm(out, dim=-1, keepdim=True), 1e-12)


def true_surfels(c: dict, seed: int, dev):
    """The configuration's scene with each point a surfel tangent to its
    surface: rotations whose third column is the surface normal, a seeded
    twist about it, the first two scales."""
    scene = S.true_scene(c["gaussians"], c["scene"], seed, dev)
    nrm = surface_normals(scene["means"], c["scene"])
    g = S.generator(dev, seed, 9)
    ref = torch.randn(nrm.shape, generator=g, device=dev)
    tu = ref - (ref * nrm).sum(-1, keepdim=True) * nrm
    tu = tu / torch.clamp_min(torch.linalg.norm(tu, dim=-1, keepdim=True), 1e-12)
    tv = torch.linalg.cross(nrm, tu)
    scene["quats"] = _rotmat_to_quat(torch.stack([tu, tv, nrm], -1))
    scene["log_scales"] = scene["log_scales"][:, :2].contiguous()
    return scene


def targets(scene, viewmats, K, width: int, height: int, sh_degree: int) -> np.ndarray:
    """(V, H, W, 3) uint8 images of the true surfels, rendered by the
    reference (tile cap 16, no class budgets)."""
    dev = scene["means"].device
    sh = torch.cat([scene["features_dc"], scene["features_rest"]], dim=1)
    out = np.empty((len(viewmats), height, width, 3), np.uint8)
    for i, vm in enumerate(viewmats):
        maps, _, _ = RS.render(scene["means"], scene["quats"], scene["log_scales"],
                               scene["logit_opacities"], sh, vm.to(dev), K.to(dev), width,
                               height, sh_degree)
        img = maps[..., :3]
        out[i] = torch.floor(torch.clamp(img, 0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy()
        del maps
    return out


def make_inputs(c: dict, tr: dict, seed: int, dev, note=lambda msg: None):
    """The cell's inputs from the seed: the targets rendered by the surfel
    reference from the true surfels, and the noisy state as a checkpoint
    (``ckpt``, in memory) with the host arrays the reference starts from."""
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig

    tcfg = TrainingConfig(**c["training"])
    W, H, N, deg = c["width"], c["height"], c["gaussians"], c["sh_degree"]
    V = int(c["views"])
    scene = true_surfels(c, seed, dev)
    viewmats = S.orbit_views(V, c["cameras"])
    K = R.intrinsics(W, H, c["cameras"]["focal_px"])
    extent = S.scene_extent(scene["means"], viewmats)
    note(f"surfel scene made, extent {extent:.4f}")
    t = time.perf_counter()
    images = targets(scene, viewmats, K, W, H, deg)
    targets_s = time.perf_counter() - t
    note(f"{V} targets rendered by the surfel reference in {targets_s:.2f} s")
    state = S.noisy(scene, c["noise"], seed)
    del scene
    capacity = -(-int(N * c["state"]["capacity_ratio"]) // 2048) * 2048
    it0 = int(tr["resume_iteration"])
    ckpt, init = S.checkpoint(state, capacity, it0, extent,
                              {**c["state"], "densify_grads_threshold":
                               tcfg.densify_grads_threshold}, seed)
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return SimpleNamespace(tcfg=tcfg, W=W, H=H, N=N, deg=deg, V=V, viewmats=viewmats, K=K,
                           extent=extent, images=images, targets_s=targets_s, capacity=capacity,
                           it0=it0, ckpt=ckpt, init=init)


def footprint_counts(params, alive, viewmats, Ks, width: int, height: int, ts: int):
    """The nonzero tile counts of the alive surfels' binning ellipses over
    the trainer's measured views, as the trainer measures them."""
    out = []
    alive_np = alive.cpu().numpy()
    sh0 = torch.zeros((params["means"].shape[0], 1, 3), device=params["means"].device)
    with torch.no_grad():
        for i in RT.measured_views(len(viewmats)):
            s = RS.project(params["means"], params["quats"], params["log_scales"],
                           params["logit_opacities"], sh0, viewmats[i], Ks[i], width, height, 0)
            nt = RT.tile_counts_host(s.screen, alive_np, width, height, ts)
            if len(nt):
                out.append(nt)
    return out


def reference_config(tcfg, c: dict, extent: float) -> dict:
    out = T.reference_config(tcfg, c, extent)
    out.update(surfel_lambda_dist=tcfg.surfel_lambda_dist,
               surfel_lambda_normal=tcfg.surfel_lambda_normal,
               surfel_depth_ratio=tcfg.surfel_depth_ratio)
    return out


def reference_run(inp, c: dict, n_steps: int, dev, dtype=torch.float32, faults=None):
    """The surfel reference's first ``n_steps`` steps from the checkpoint's
    arrays, with the tile cap, the class budgets and the batches worked out
    again."""
    tcfg = inp.tcfg
    alive = inp.init["alive"]
    ref_k = [inp.K] * inp.V
    p_dev = {k: torch.as_tensor(inp.init[k], device=dev) for k in LEAVES}
    counts = footprint_counts(p_dev, torch.as_tensor(alive, device=dev), inp.viewmats, ref_k,
                              inp.W, inp.H, tcfg.tile_size)
    del p_dev
    max_t = (RT.choose_max_tiles(counts, inp.capacity, tcfg.max_tiles_per_gaussian,
                                 tcfg.max_sort_entries)
             if tcfg.auto_max_tiles else tcfg.max_tiles_per_gaussian)
    budgets = tcfg.class_budgets
    if tcfg.binning in ("auto", "compact") and budgets is None:
        budgets = RT.choose_class_budgets(counts, inp.capacity, max_t, tcfg.max_sort_entries)
    batches = RT.batch_schedule(inp.V, tcfg.batch_size, n_steps, tcfg.val_seed,
                                tcfg.val_fraction, tcfg.val_max_views)
    rcfg = reference_config(tcfg, c, inp.extent)
    ref = RS.reference_steps(inp.init, alive, inp.viewmats, ref_k, inp.images, batches, rcfg,
                             inp.deg, max_t, budgets, inp.it0, inp.it0, dev, dtype=dtype,
                             faults=faults)
    ref.update(max_t=max_t, budgets=budgets, rcfg=rcfg)
    return ref


def map_gaps(got, want) -> dict:
    """The parts of ``surfel_map_gap`` of the first step's views, each the
    worst over the views: ``got`` and ``want`` are lists of (H, W, >= 7)
    maps [depth sum, alpha, normal (3), distortion, median depth, ...], one
    a view in the same order."""
    out = {"normal": 0.0, "expected_depth": 0.0, "distortion": 0.0, "median_share": 0.0}
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        mask = w[..., 1] > 0.5
        if not bool(mask.any()):
            continue
        ed_g = g[..., 0] / g[..., 1].clamp_min(1e-10)
        ed_w = w[..., 0] / w[..., 1].clamp_min(1e-10)
        for name, a, b in (("normal", g[..., 2:5][mask], w[..., 2:5][mask]),
                           ("expected_depth", ed_g[mask], ed_w[mask]),
                           ("distortion", g[..., 5][mask], w[..., 5][mask])):
            gap = float((a - b).abs().max()) / max(float(b.pow(2).mean().sqrt()), 1e-30)
            # A NaN would drop out of max(); any non-finite gap is the worst.
            out[name] = max(out[name], gap) if math.isfinite(gap) else math.inf
        mg, mw = g[..., 6][mask], w[..., 6][mask]
        differ = ~((mg - mw).abs() <= MEDIAN_RTOL * mw.abs())
        out["median_share"] = max(out["median_share"], float(differ.double().mean()))
    return out


def map_gap(got, want) -> float:
    """``surfel_map_gap``: the worst of ``map_gaps``."""
    return max(map_gaps(got, want).values())


def densify_differences(rec, rcfg: dict, seed: int, device):
    """``traffic/trainer.py``'s count of differing slots, with the surfel
    reference's densify."""
    d = rec.densify_in
    t = {k: torch.as_tensor(v, device=device) for k, v in d.items()}
    cap = t["alive"].shape[0]
    out = RS.densify({k: t[k] for k in LEAVES}, {k: t["mu/" + k] for k in LEAVES},
                     {k: t["nu/" + k] for k in LEAVES}, t["alive"], t["accum"], t["count"],
                     rcfg, rec.densify_extent, RT.split_normals(cap, seed, device))
    got = rec.densify_out
    differ = got["alive"] != out["alive"].cpu().numpy()
    for k in LEAVES:
        for name, tab in ((k, out["params"]), ("mu/" + k, out["mu"]), ("nu/" + k, out["nu"])):
            want = tab[k].cpu().numpy().reshape(cap, -1)
            differ |= (got[name].reshape(cap, -1) != want).any(1)
    return int(differ.sum()), {k: out[k] for k in ("n_cloned", "n_split", "n_pruned")}


def run(ctx: harness.Ctx) -> harness.Outcome:
    from gaussian_splatting_tpu_torch.training import step as program_step
    from gaussian_splatting_tpu_torch.training.trainer import GaussianTrainer, ViewDataset
    from gaussian_splatting_tpu_torch.utils.metrics import MetricsLogger

    dev = ctx.device
    c, tr, lim = ctx.config, ctx.workload["traffic"], ctx.workload["limits"]
    harness.note(ctx, f"{ctx.cell}: seed {ctx.seed}, {c['gaussians']} surfels, "
                      f"{c['width']}x{c['height']}")
    inp = make_inputs(c, tr, ctx.seed, dev, lambda msg: harness.note(ctx, msg))
    tcfg, W, H = inp.tcfg, inp.W, inp.H
    dataset = ViewDataset(images=inp.images, viewmats=inp.viewmats.numpy(),
                          Ks=np.repeat(inp.K.numpy()[None], inp.V, 0))

    # ---- the program: set-up, warm-up, window ---------------------------------
    rec = SurfelRecorder(ctx, int(tr["warmup_steps"]), int(tr["reference_steps"]),
                         int(tr["trace_steps"]), tcfg.adam_b1, inp.targets_s)
    trainer = T._trainer_class(GaussianTrainer, rec)(
        tcfg, logger=T._logger_class(MetricsLogger, rec)(ctx.out_dir), device=dev)
    harness.note(ctx, f"checkpoint at iteration {inp.it0}, capacity {inp.capacity}")
    harness.reset_peak(dev)
    render_fn = program_step.render
    program_step.render = rec.capture(render_fn)
    try:
        trainer.train(dataset, ctx.out_dir, resume_from=inp.ckpt)
        raise RuntimeError("the trainer ran out of iterations before the window closed")
    except T.WindowClosed:
        pass
    finally:
        program_step.render = render_fn
        if rec.prog is not None and rec.spans_on:
            rec.prog.disable()
    peak = harness.peak_bytes(dev)
    window_s = rec.t_close - rec.t_open
    iters = rec.window_steps
    harness.note(ctx, f"window closed: {iters} steps in {window_s:.3f} s, set-up "
                      f"{rec.setup_s:.2f} s, binning {rec.binning}")
    del trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    summary = attribution = None
    if rec.stretch is not None:
        summary = rec.stretch.summarize(ctx.trace_file)
        attribution = rec.stretch.attribution()
        if attribution is not None and summary.units:
            by = {}
            for path, v in attribution.device_s.items():
                leaf = path.rsplit("/", 1)[-1] or "(no span)"
                by[leaf] = by.get(leaf, 0.0) + v
            harness.note(ctx, "device ms a step by innermost span: " + ", ".join(
                f"{k} {1e3 * v / summary.units:.3f}"
                for k, v in sorted(by.items(), key=lambda kv: -kv[1])))

    # ---- the reference ----------------------------------------------------------
    ref = reference_run(inp, c, int(tr["reference_steps"]), dev)
    harness.note(ctx, f"reference: max_t {ref['max_t']}, budgets {ref['budgets']}, "
                      f"intersections {ref['isects']}, pairs {ref['pairs']}, losses "
                      f"{ref['losses']}, gradient norms {ref['grad_norms']}")
    got = {"losses": rec.losses, "grad_norms": rec.grad_norms,
           "change_norms": {k: float(np.linalg.norm((rec.params_after[k].astype(np.float64)
                                                     - inp.init[k].astype(np.float64)).ravel()))
                            for k in LEAVES}}
    checks = T.step_gaps(got, ref)
    checks["densify_slots_differ"], counts = densify_differences(rec, ref["rcfg"],
                                                                 tcfg.val_seed, dev)
    gaps = (map_gaps(rec.maps0, ref["maps"]) if len(rec.maps0) == len(ref["maps"])
            else {"views": float("nan")})
    checks["surfel_map_gap"] = max(gaps.values())
    harness.note(ctx, f"reference densify: {counts}; map gaps {gaps}")
    harness.note(ctx, f"program: losses {rec.losses}, gradient norms {rec.grad_norms}, "
                      f"changes {got['change_norms']}; reference changes {ref['change_norms']}")
    view = {"pairs": float(np.mean(ref["pairs"])), "n_isect": float(np.mean(ref["isects"])),
            "pixels": float(W * H), "tiles": float(R.cdiv(W, tcfg.tile_size)
                                                   * R.cdiv(H, tcfg.tile_size))}
    layer = {"kind": "train", "trace": summary, "view": view, "views_per_unit": tcfg.batch_size,
             "n_gaussians": float(inp.init["alive"].sum()), "sh_degree": inp.deg,
             "event_s": rec.event_s, "window_s": window_s, "units": iters,
             "span_stretch": attribution, "surfel": True}
    return harness.Outcome(
        attempted=iters, failed=rec.failed,
        end_to_end={"train_iter_ms": 1e3 * window_s / iters, "setup_s": rec.setup_s,
                    "peak_mem_gib": peak / 2**30},
        checks={k: [float(v), float(lim[k])] for k, v in checks.items()},
        peak_bytes=peak, layer=layer)
