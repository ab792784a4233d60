"""Trainer traffic: a training job resumed from a checkpoint, closed loop.

Set-up makes the cell's true scene on the device from the seed, renders the
target views with the reference, writes the noisy state as a checkpoint (in
the trainer's ``.npz`` layout, held in memory) and hands it to
``GaussianTrainer.train(resume_from=...)``. A subclass of the trainer wraps
each step: the first ``warmup_steps`` steps (one densify event among them)
are set-up, the window opens at the next step boundary and closes at the
first boundary after ``--seconds``, where the subclass stops the trainer (a
traced run first profiles ``trace_steps`` more steps).
The reference follows the first steps from the same checkpoint and checks
the first densify event from the program's own state before it.
"""

from __future__ import annotations

import gc
import math
import time
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from portbench import harness
from portbench import scene as S
from portbench.reference import render as R
from portbench.reference import train as RT
from portbench.trace import Stretch

LEAVES = RT.PARAM_KEYS


class WindowClosed(Exception):
    """Raised at the first step boundary after the window's end."""


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _trainer_class(base, rec):
    """``base`` (``GaussianTrainer``) with the benchmark's hooks, reporting
    to ``rec``."""

    class BenchTrainer(base):
        def _make_step(self, *a):
            rec.binning.append((self.config.max_tiles_per_gaussian, self.config.class_budgets))
            return rec.wrap(super()._make_step(*a))

        def _densify(self, state, extent, it):
            first = rec.densify_in is None
            if first:
                rec.densify_in = _densify_snapshot(state, with_inputs=True)
                rec.densify_extent = float(extent)
            out = rec.timed("densify", super()._densify, state, extent, it)
            if first:
                rec.densify_out = _densify_snapshot(out, with_inputs=False)
            return out

        def _grow(self, *a):
            return rec.timed("grow", super()._grow, *a)

        def _watch_budgets(self, *a):
            return rec.timed("watch budgets", super()._watch_budgets, *a)

        def _watch_tile_cap(self, *a):
            return rec.timed("watch tile cap", super()._watch_tile_cap, *a)

        def _probe_grad_buffer(self, *a):
            return rec.timed("probe grad buffer", super()._probe_grad_buffer, *a)

        def validate(self, *a):
            return rec.timed("validate", super().validate, *a)

    return BenchTrainer


def _logger_class(base, rec):
    class BenchLogger(base):
        def log(self, data, step=None):
            if "loss" in data and not math.isfinite(float(data["loss"])) and rec.in_window:
                rec.failed += 1
            return rec.timed("log write", super().log, data, step)

        def log_image(self, *a, **k):
            return rec.timed("log write", super().log_image, *a, **k)

    return BenchLogger


def _densify_snapshot(state, with_inputs: bool) -> Dict[str, np.ndarray]:
    g = state.gauss
    out = {k: _host(getattr(g.params, k)) for k in LEAVES}
    out.update({"mu/" + k: _host(getattr(state.opt.mu, k)) for k in LEAVES})
    out.update({"nu/" + k: _host(getattr(state.opt.nu, k)) for k in LEAVES})
    out["alive"] = _host(g.alive)
    if with_inputs:
        out["accum"] = _host(g.xyz_grad_accum)
        out["count"] = _host(g.xyz_grad_count)
    return out


class Recorder:
    """The window's clock and what the checks read from the program."""

    def __init__(self, ctx: harness.Ctx, warmup: int, ref_steps: int, trace_steps: int,
                 b1: float, reference_s: float):
        self.ctx = ctx
        self.reference_s = reference_s
        self.dev = ctx.device
        self.warmup, self.ref_steps, self.trace_steps = warmup, ref_steps, trace_steps
        self.b1 = b1
        self.steps = 0
        self.losses, self.grad_norms, self.params_after = [], {}, None
        self.densify_in = self.densify_out = None
        self.densify_extent = None
        self.in_window = False
        self.t_open = self.t_close = None
        self.open_step = None
        self.failed = 0
        self.event_s: Dict[str, float] = {}
        self._depth = 0
        self.stretch = None
        self.binning = []
        self.close_step = self.stretch_step = None

    def timed(self, name, fn, *a, **k):
        """Host time of an event, synchronized, in a traced run's window."""
        if not (self.ctx.trace and self.in_window) or self._depth:
            return fn(*a, **k)
        self._depth += 1
        harness.sync(self.dev)
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            harness.sync(self.dev)
            self.event_s[name] = self.event_s.get(name, 0.0) + time.perf_counter() - t
            self._depth -= 1

    def boundary(self):
        """Called before every step: opens and closes the window; a traced
        run then profiles ``trace_steps`` more steps (the profiler slows the
        host, and a CUDA trace leaves it slower after it stops, so the
        stretch comes last and the window's numbers are taken before it)."""
        n = self.steps
        if n == self.ref_steps:
            self.params_after = {}
        if n == self.warmup and self.open_step is None:
            if self.densify_out is None:
                raise RuntimeError("no densify event in the warm-up")
            harness.sync(self.dev)
            self.t_open = time.perf_counter()
            self.setup_s = time.time() - self.ctx.t_start - self.reference_s
            self.in_window, self.open_step = True, n
            self.deadline = self.t_open + self.ctx.seconds
        if self.stretch is not None:
            if n - self.stretch_step == self.trace_steps:
                harness.sync(self.dev)
                self.stretch.stop(self.trace_steps)
                raise WindowClosed()
            return
        if self.in_window and n > self.open_step and time.perf_counter() >= self.deadline:
            harness.sync(self.dev)
            self.t_close = time.perf_counter()
            self.in_window = False
            self.close_step = n
            if not self.ctx.trace:
                raise WindowClosed()
            self.stretch, self.stretch_step = Stretch(self.dev), n
            self.stretch.start()

    def wrap(self, step):
        def wrapped(state, batch):
            self.boundary()
            if self.params_after == {}:
                self.params_after = {k: _host(getattr(state.gauss.params, k)) for k in LEAVES}
            state, metrics = step(state, batch)
            self.steps += 1
            if self.steps <= self.ref_steps:
                self.losses.append(float(metrics["loss"]))
            if self.steps == 1:
                self.grad_norms = {k: float(torch.linalg.norm(getattr(state.opt.mu, k)))
                                   / (1.0 - self.b1) for k in LEAVES}
            return state, metrics

        return wrapped

    @property
    def window_steps(self) -> int:
        return self.close_step - self.open_step


def reference_config(tcfg, c: dict, extent: float) -> dict:
    keys = ("tile_size", "raster_chunk", "lambda_dssim", "adam_b1", "adam_b2", "adam_eps",
            "lr_rotation", "lr_scaling", "lr_opacity", "lr_features_dc", "lr_features_rest",
            "position_lr_init", "position_lr_final", "position_lr_max_steps",
            "scale_reg_max_ratio", "scale_reg_weight", "scale_clamp_ratio",
            "densify_grads_threshold", "densify_min_opacity", "densify_clone_extent_ratio",
            "densify_prune_extent_ratio", "max_gaussians")
    out = {k: getattr(tcfg, k) for k in keys}
    out.update(width=c["width"], height=c["height"], extent=extent)
    return out


def densify_differences(rec: Recorder, rcfg: dict, seed: int, device):
    """Slots whose alive flag, parameters or moments differ between the
    program's first densify event and the reference's, both from the
    program's state before it, and the reference's counts of that event."""
    d = rec.densify_in
    t = {k: torch.as_tensor(v, device=device) for k, v in d.items()}
    cap = t["alive"].shape[0]
    out = RT.densify({k: t[k] for k in LEAVES}, {k: t["mu/" + k] for k in LEAVES},
                     {k: t["nu/" + k] for k in LEAVES}, t["alive"], t["accum"], t["count"],
                     rcfg, rec.densify_extent, RT.split_normals(cap, seed, device))
    got = rec.densify_out
    differ = got["alive"] != out["alive"].cpu().numpy()
    for k in LEAVES:
        for name, tab in ((k, out["params"]), ("mu/" + k, out["mu"]), ("nu/" + k, out["nu"])):
            want = tab[k].cpu().numpy().reshape(cap, -1)
            differ |= (got[name].reshape(cap, -1) != want).any(1)
    return int(differ.sum()), {k: out[k] for k in ("n_cloned", "n_split", "n_pruned")}


def make_inputs(c: dict, tr: dict, seed: int, dev, note=lambda msg: None):
    """The cell's inputs from the seed: the target views rendered by the
    reference from the true scene, and the noisy state as a checkpoint
    (``ckpt``, in memory) with the host arrays the reference starts from
    (``init``). ``targets_s`` is the reference's time on the targets, which
    set-up does not count."""
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig

    W, H, N, deg = c["width"], c["height"], c["gaussians"], c["sh_degree"]
    V = int(c["views"])
    tcfg = TrainingConfig(**c["training"])
    scene = S.true_scene(N, c["scene"], seed, dev)
    viewmats = S.orbit_views(V, c["cameras"])
    K = R.intrinsics(W, H, c["cameras"]["focal_px"])
    extent = S.scene_extent(scene["means"], viewmats)
    note(f"scene made, extent {extent:.4f}")
    t = time.perf_counter()
    images = S.targets(scene, viewmats, K, W, H, deg)
    targets_s = time.perf_counter() - t
    note(f"{V} targets rendered by the reference in {targets_s:.2f} s")
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


def reference_run(inp, c: dict, n_steps: int, dev, dtype=torch.float32,
                  drop_half: bool = False):
    """The reference's first ``n_steps`` steps from the checkpoint's arrays,
    with the tile cap, the class budgets and the batches worked out again."""
    tcfg = inp.tcfg
    alive = inp.init["alive"]
    ref_k = [inp.K] * inp.V
    p_dev = {k: torch.as_tensor(inp.init[k], device=dev) for k in LEAVES}
    counts = RT.footprint_counts(p_dev, torch.as_tensor(alive, device=dev), inp.viewmats,
                                 ref_k, inp.W, inp.H, tcfg.tile_size)
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
    ref = RT.reference_steps(inp.init, alive, inp.viewmats, ref_k, inp.images, batches, rcfg,
                             inp.deg, max_t, budgets, inp.it0, inp.it0, dev, dtype=dtype,
                             drop_half=drop_half)
    ref.update(max_t=max_t, budgets=budgets, rcfg=rcfg)
    return ref


def step_gaps(got: dict, ref: dict) -> dict:
    """The three numbers a step comparison reads: the largest relative gap
    of a step's loss, and the worst leaf's gap of the first gradient's norm
    and of the change's norm (leaves whose reference gradient is under a
    thousandth of the median leaf's left out of the change)."""
    gmed = float(np.median(list(ref["grad_norms"].values())))
    moved = [k for k in LEAVES if ref["grad_norms"][k] >= 1e-3 * gmed]
    return {
        "loss_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
        "grad_norm_gap": max(RT.leaf_gaps(got["grad_norms"], ref["grad_norms"]).values()),
        "change_norm_gap": max(RT.leaf_gaps(got["change_norms"], ref["change_norms"],
                                            moved).values()),
    }


def run(ctx: harness.Ctx) -> harness.Outcome:
    from gaussian_splatting_tpu_torch.training.trainer import GaussianTrainer, ViewDataset
    from gaussian_splatting_tpu_torch.utils.metrics import MetricsLogger

    dev = ctx.device
    c, tr, lim = ctx.config, ctx.workload["traffic"], ctx.workload["limits"]
    harness.note(ctx, f"{ctx.cell}: seed {ctx.seed}, {c['gaussians']} gaussians, "
                      f"{c['width']}x{c['height']}")
    inp = make_inputs(c, tr, ctx.seed, dev, lambda msg: harness.note(ctx, msg))
    tcfg, W, H = inp.tcfg, inp.W, inp.H
    dataset = ViewDataset(images=inp.images, viewmats=inp.viewmats.numpy(),
                          Ks=np.repeat(inp.K.numpy()[None], inp.V, 0))

    # ---- the program: set-up, warm-up, window ---------------------------------
    rec = Recorder(ctx, int(tr["warmup_steps"]), int(tr["reference_steps"]),
                   int(tr["trace_steps"]), tcfg.adam_b1, inp.targets_s)
    trainer = _trainer_class(GaussianTrainer, rec)(
        tcfg, logger=_logger_class(MetricsLogger, rec)(ctx.out_dir), device=dev)
    harness.note(ctx, f"checkpoint at iteration {inp.it0}, capacity {inp.capacity}")
    harness.reset_peak(dev)
    try:
        trainer.train(dataset, ctx.out_dir, resume_from=inp.ckpt)
        raise RuntimeError("the trainer ran out of iterations before the window closed")
    except WindowClosed:
        pass
    peak = harness.peak_bytes(dev)
    window_s = rec.t_close - rec.t_open
    iters = rec.window_steps
    harness.note(ctx, f"window closed: {iters} steps in {window_s:.3f} s, set-up "
                      f"{rec.setup_s:.2f} s, binning {rec.binning}")
    del trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    summary = None
    if rec.stretch is not None:
        summary = rec.stretch.summarize(ctx.trace_file)

    # ---- the reference ----------------------------------------------------------
    ref = reference_run(inp, c, int(tr["reference_steps"]), dev)
    harness.note(ctx, f"reference: max_t {ref['max_t']}, budgets {ref['budgets']}, "
                      f"intersections {ref['isects']}, pairs {ref['pairs']}, losses "
                      f"{ref['losses']}, gradient norms {ref['grad_norms']}")
    got = {"losses": rec.losses, "grad_norms": rec.grad_norms,
           "change_norms": {k: float(np.linalg.norm((rec.params_after[k].astype(np.float64)
                                                     - inp.init[k].astype(np.float64)).ravel()))
                            for k in LEAVES}}
    checks = step_gaps(got, ref)
    checks["densify_slots_differ"], counts = densify_differences(rec, ref["rcfg"], tcfg.val_seed,
                                                                 dev)
    harness.note(ctx, f"reference densify: {counts}")
    harness.note(ctx, f"program: losses {rec.losses}, gradient norms {rec.grad_norms}, "
                      f"changes {got['change_norms']}; reference changes {ref['change_norms']}")
    view = {"pairs": float(np.mean(ref["pairs"])), "n_isect": float(np.mean(ref["isects"])),
            "pixels": float(W * H), "tiles": float(R.cdiv(W, tcfg.tile_size)
                                                   * R.cdiv(H, tcfg.tile_size))}
    layer = {"kind": "train", "trace": summary, "view": view, "views_per_unit": tcfg.batch_size,
             "n_gaussians": float(inp.init["alive"].sum()), "sh_degree": inp.deg,
             "event_s": rec.event_s, "window_s": window_s, "units": iters}
    return harness.Outcome(
        attempted=iters, failed=rec.failed,
        end_to_end={"train_iter_ms": 1e3 * window_s / iters, "setup_s": rec.setup_s,
                    "peak_mem_gib": peak / 2**30},
        checks={k: [float(v), float(lim[k])] for k, v in checks.items()},
        peak_bytes=peak, layer=layer)
