"""Deformable-trainer traffic: a Deformable 3D Gaussians training job (one
frame and its time a step) resumed from a checkpoint, closed loop.

It is the trainer traffic of ``traffic/trainer.py``, reused by import, with
a moving scene: the configuration's ``deform`` section gives the published
network, a seeded "true" network (``torch.nn.Linear``'s initialisation, its
heads scaled so that the offsets reach the configured RMS) moves the true
scene, and each target view is rendered by the reference at its time v / (V
- 1). The checkpoint holds the noisy gaussians and the true network plus
seeded noise, with Adam moments as the static state has them (mu 0, nu the
square of each tensor's gradient RMS as the reference measures it). Spans are on from the window's open;
a traced run's stretch hands its attribution to the readers
(``span_stretch``), with the rows the MLP took a view (``deform``).

Checks, each beside its limit: the trainer cell's four (the MLP's tensors
among the leaves of ``grad_norm_gap`` and ``change_norm_gap``) and
``deform_rel_err``, the largest |offset - reference offset| of the first
step's view over the RMS of the reference's offsets of the alive slots,
the worst of dx, dr and ds.
"""

from __future__ import annotations

import gc
import io
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import harness
from portbench import scene as S
from portbench import spans
from portbench.reference import deform as RD
from portbench.reference import render as R
from portbench.reference import train as RT

T = harness.traffic_driver("trainer")
# A traced run's stretch records the program's spans and attributes to them.
T.Stretch = spans.SpanStretch
LEAVES = RT.PARAM_KEYS


class DeformRecorder(T.Recorder):
    """The trainer cell's recorder, which also keeps the MLP's first
    gradient norms and its tensors after the reference's steps, the first
    step's offsets, and turns the program's spans on at the window's open."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.net_grad_norms = None
        self.net_after = None
        self.offsets0 = None
        self.spans_on = False
        self.prog = spans._profiling()
        self.stretch_rows = None

    def _rows(self) -> int:
        return self.prog.counters().get("deform.rows", 0) if self.prog is not None else 0

    def boundary(self):
        """The trainer cell's boundary; spans on from the window's open, and
        the counter ``deform.rows`` read at the stretch's two ends."""
        tracing = self.stretch is not None
        try:
            super().boundary()
        except T.WindowClosed:
            if tracing:
                self.stretch_rows = self._rows() - self.stretch_rows
            raise
        if not tracing and self.stretch is not None:
            self.stretch_rows = self._rows()
        if self.in_window and not self.spans_on and self.prog is not None:
            self.prog.reset()
            self.prog.enable()
            self.spans_on = True

    def wrap(self, step):
        inner = super().wrap(step)

        def wrapped(state, batch):
            if self.steps == self.ref_steps and self.net_after is None:
                self.net_after = {k: T._host(v) for k, v in state.deform.params.items()}
            out = inner(state, batch)
            if self.steps == 1:
                self.net_grad_norms = {k: float(torch.linalg.norm(v)) / (1.0 - self.b1)
                                       for k, v in out[0].deform.mu.items()}
            return out

        return wrapped

    def capture(self, offsets_fn):
        """``offsets_fn`` (the program's ``models.deform.offsets``) keeping
        the first training call's offsets on the host."""
        def capturing(*a, **k):
            out = offsets_fn(*a, **k)
            if self.offsets0 is None and self.steps == 0 and torch.is_grad_enabled():
                self.offsets0 = [T._host(o) for o in out]
            return out

        return capturing


def time_noise_sd(sched: dict, iteration: int, n_frames: int) -> float:
    """The annealing noise's standard deviation the trainer draws with, by
    the configuration's ``deform_schedule``."""
    if iteration >= sched["time_noise_steps"]:
        return 0.0
    return (sched["time_noise"] * (1.0 - iteration / float(sched["time_noise_steps"]))
            / max(n_frames, 1))


def true_network(c: dict, scene: dict, extent: float, seed: int, dev):
    """The seeded true network, its heads scaled so that over a sample of
    the scene at three times dx's RMS is ``motion.dx_rel`` x the extent, dr's
    ``motion.dr_rms`` and ds's ``motion.ds_rel`` x the median scale."""
    spec, mo = c["deform"], c["motion"]
    net = RD.init_net(spec, S.generator(dev, seed, 7), dev)
    x = scene["means"][:: max(1, scene["means"].shape[0] // 65536)]
    outs = [RD.mlp(net, spec, x, t) for t in (0.0, 0.5, 1.0)]
    med_scale = float(torch.exp(scene["log_scales"]).median())
    want = (mo["dx_rel"] * extent, mo["dr_rms"], mo["ds_rel"] * med_scale)
    for j, (name, _) in enumerate(RD.HEADS):
        rms = float(torch.cat([o[j] for o in outs]).pow(2).mean().sqrt())
        net[f"{name}.weight"] *= want[j] / rms
        net[f"{name}.bias"] *= want[j] / rms
    return net


def make_inputs(c: dict, tr: dict, seed: int, dev, note=lambda msg: None):
    """The cell's inputs from the seed: the targets rendered by the
    reference from the true scene moved by the true network at each view's
    time, and the checkpoint of the noisy state with the network (``ckpt``,
    in memory), with the host arrays and the network the reference starts
    from."""
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig

    tcfg = TrainingConfig(**c["training"])
    W, H, N, deg = c["width"], c["height"], c["gaussians"], c["sh_degree"]
    V = int(c["views"])
    spec = c["deform"]
    scene = S.true_scene(N, c["scene"], seed, dev)
    viewmats = S.orbit_views(V, c["cameras"])
    K = R.intrinsics(W, H, c["cameras"]["focal_px"])
    extent = S.scene_extent(scene["means"], viewmats)
    times = (np.arange(V, dtype=np.float64) / max(V - 1, 1)).astype(np.float32)
    net_true = true_network(c, scene, extent, seed, dev)
    note(f"scene made, extent {extent:.4f}")
    t0 = time.perf_counter()
    rows = torch.arange(N, device=dev)
    images = np.empty((V, H, W, 3), np.uint8)
    for v in range(V):
        offs = RD.offsets(net_true, spec, scene["means"], rows, float(times[v]))
        moved = RD.deformed_params(scene, offs)
        images[v] = S.targets(moved, viewmats[v:v + 1], K, W, H, deg)[0]
        del offs, moved
    targets_s = time.perf_counter() - t0
    note(f"{V} targets rendered by the reference at their times in {targets_s:.2f} s")
    state = S.noisy(scene, c["noise"], seed)
    del scene
    capacity = -(-int(N * c["state"]["capacity_ratio"]) // 2048) * 2048
    it0 = int(tr["resume_iteration"])
    ckpt, init = S.checkpoint(state, capacity, it0, extent,
                              {**c["state"], "densify_grads_threshold":
                               tcfg.densify_grads_threshold}, seed)
    del state
    ds = c["deform_state"]
    g = S.generator(dev, seed, 8)
    net0 = {k: v + ds["weight_noise"] * v.pow(2).mean().sqrt()
            * torch.randn(v.shape, generator=g, device=dev) for k, v in net_true.items()}
    net_nu = {k: torch.full_like(v, float(ds["nu_rms"][k]) ** 2) for k, v in net0.items()}
    arrays = dict(np.load(ckpt))
    for k in net0:
        arrays[f"deform/params/{k}"] = T._host(net0[k])
        arrays[f"deform/adam_mu/{k}"] = np.zeros(net0[k].shape, np.float32)
        arrays[f"deform/adam_nu/{k}"] = T._host(net_nu[k])
    arrays["deform/spec"] = np.asarray([spec[k] for k in ("depth", "width", "skip",
                                                         "multires_x", "multires_t")],
                                       np.int32)
    ckpt = io.BytesIO()
    np.savez(ckpt, **arrays)
    ckpt.seek(0)
    del arrays, net_true
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return SimpleNamespace(tcfg=tcfg, W=W, H=H, N=N, deg=deg, V=V, viewmats=viewmats, K=K,
                           extent=extent, images=images, targets_s=targets_s, capacity=capacity,
                           it0=it0, ckpt=ckpt, init=init, times=times, net0=net0,
                           net_nu=net_nu, spec=spec)


def reference_run(inp, c: dict, n_steps: int, dev):
    """The reference's first ``n_steps`` steps, with the tile cap, the class
    budgets, the batches and the times' annealing noise worked out again."""
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
    # The trainer draws one normal a view from a generator on the device
    # seeded val_seed + 2 and adds sd x it to the view's float32 time.
    g = torch.Generator(device=dev).manual_seed(tcfg.val_seed + 2)
    times = []
    for i, views in enumerate(batches):
        t = torch.as_tensor(inp.times[np.asarray(views)], device=dev)
        sd = time_noise_sd(c["deform_schedule"], inp.it0 + i, inp.V)
        if sd > 0.0:
            t = t + sd * torch.randn(t.shape, generator=g, device=dev)
        times.append(t.cpu().numpy())
    rcfg = T.reference_config(tcfg, c, inp.extent)
    sched = c["deform_schedule"]
    rcfg.update(deform_lr_init=sched["lr_scale"] * tcfg.position_lr_init,
                deform_lr_final=tcfg.position_lr_final, deform_lr_max_steps=sched["lr_max_steps"])
    ref = RD.reference_steps(inp.init, inp.net0, inp.net_nu, inp.spec, alive, inp.viewmats,
                             ref_k, inp.images, times, batches, rcfg, inp.deg, max_t, budgets,
                             inp.it0, inp.it0, dev)
    ref.update(max_t=max_t, budgets=budgets, rcfg=rcfg, times=times)
    return ref


def deform_rel_err(got, want, alive: np.ndarray) -> float:
    """The worst of dx, dr, ds of max |got - want| over the RMS of want,
    over the alive slots."""
    out = 0.0
    for a, b in zip(got, want):
        b = b.detach().cpu().numpy()[alive].astype(np.float64)
        a = np.asarray(a)[alive].astype(np.float64)
        rms = float(np.sqrt(np.mean(b * b)))
        out = max(out, float(np.abs(a - b).max()) / max(rms, 1e-30))
    return out


def step_gaps(got: dict, ref: dict, keys) -> dict:
    """``traffic/trainer.py``'s three step numbers over ``keys``, the six
    groups and the MLP's tensors."""
    gmed = float(np.median(list(ref["grad_norms"].values())))
    moved = [k for k in keys if ref["grad_norms"][k] >= 1e-3 * gmed]
    return {
        "loss_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
        "grad_norm_gap": max(RT.leaf_gaps(got["grad_norms"], ref["grad_norms"]).values()),
        "change_norm_gap": max(RT.leaf_gaps(got["change_norms"], ref["change_norms"],
                                            moved).values()),
    }


def run(ctx: harness.Ctx) -> harness.Outcome:
    from gaussian_splatting_tpu_torch.models import deform as program_deform
    from gaussian_splatting_tpu_torch.training.trainer import GaussianTrainer, ViewDataset
    from gaussian_splatting_tpu_torch.utils.metrics import MetricsLogger

    dev = ctx.device
    c, tr, lim = ctx.config, ctx.workload["traffic"], ctx.workload["limits"]
    harness.note(ctx, f"{ctx.cell}: seed {ctx.seed}, {c['gaussians']} gaussians, "
                      f"{c['width']}x{c['height']}, deformation {c['deform']}")
    inp = make_inputs(c, tr, ctx.seed, dev, lambda msg: harness.note(ctx, msg))
    tcfg, W, H = inp.tcfg, inp.W, inp.H
    dataset = ViewDataset(images=inp.images, viewmats=inp.viewmats.numpy(),
                          Ks=np.repeat(inp.K.numpy()[None], inp.V, 0), times=inp.times)

    # ---- the program: set-up, warm-up, window ---------------------------------
    rec = DeformRecorder(ctx, int(tr["warmup_steps"]), int(tr["reference_steps"]),
                         int(tr["trace_steps"]), tcfg.adam_b1, inp.targets_s)
    trainer = T._trainer_class(GaussianTrainer, rec)(
        tcfg, logger=T._logger_class(MetricsLogger, rec)(ctx.out_dir), device=dev)
    harness.note(ctx, f"checkpoint at iteration {inp.it0}, capacity {inp.capacity}")
    harness.reset_peak(dev)
    offsets_fn = program_deform.offsets
    program_deform.offsets = rec.capture(offsets_fn)
    try:
        trainer.train(dataset, ctx.out_dir, resume_from=inp.ckpt)
        raise RuntimeError("the trainer ran out of iterations before the window closed")
    except T.WindowClosed:
        pass
    finally:
        program_deform.offsets = offsets_fn
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

    # ---- the reference ----------------------------------------------------------
    ref = reference_run(inp, c, int(tr["reference_steps"]), dev)
    harness.note(ctx, f"reference: max_t {ref['max_t']}, budgets {ref['budgets']}, "
                      f"intersections {ref['isects']}, pairs {ref['pairs']}, times "
                      f"{[t.tolist() for t in ref['times']]}, losses {ref['losses']}")
    keys = list(LEAVES) + list(inp.net0)
    init = {**inp.init, **{k: T._host(v) for k, v in inp.net0.items()}}
    after = {**rec.params_after, **rec.net_after}
    got = {"losses": rec.losses, "grad_norms": {**rec.grad_norms, **rec.net_grad_norms},
           "change_norms": {k: float(np.linalg.norm((after[k].astype(np.float64)
                                                     - init[k].astype(np.float64)).ravel()))
                            for k in keys}}
    checks = step_gaps(got, ref, keys)
    checks["densify_slots_differ"], counts = T.densify_differences(rec, ref["rcfg"],
                                                                   tcfg.val_seed, dev)
    alive = inp.init["alive"]
    checks["deform_rel_err"] = (deform_rel_err(rec.offsets0, ref["offsets"], alive)
                                if rec.offsets0 is not None else float("nan"))
    harness.note(ctx, f"reference densify: {counts}")
    harness.note(ctx, f"gradient norms program {got['grad_norms']} reference "
                      f"{ref['grad_norms']}")
    harness.note(ctx, f"changes program {got['change_norms']} reference "
                      f"{ref['change_norms']}")
    view = {"pairs": float(np.mean(ref["pairs"])), "n_isect": float(np.mean(ref["isects"])),
            "pixels": float(W * H), "tiles": float(R.cdiv(W, tcfg.tile_size)
                                                   * R.cdiv(H, tcfg.tile_size))}
    rows = (rec.stretch_rows / (rec.trace_steps * tcfg.batch_size)
            if summary is not None and rec.stretch_rows else None)
    layer = {"kind": "train", "trace": summary, "view": view,
             "views_per_unit": tcfg.batch_size, "n_gaussians": float(alive.sum()),
             "sh_degree": inp.deg, "event_s": rec.event_s, "window_s": window_s, "units": iters,
             "span_stretch": attribution,
             "deform": {"spec": inp.spec, "rows_per_view": rows,
                        "params": float(sum(v.numel() for v in inp.net0.values()))}}
    return harness.Outcome(
        attempted=iters, failed=rec.failed,
        end_to_end={"train_iter_ms": 1e3 * window_s / iters, "setup_s": rec.setup_s,
                    "peak_mem_gib": peak / 2**30},
        checks={k: [float(v), float(lim[k])] for k, v in checks.items()},
        peak_bytes=peak, layer=layer)
