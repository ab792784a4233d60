"""HexPlane-trainer traffic: a 4D Gaussian Splatting training job (batch 4 at
1080p, each view at its own time) resumed from a checkpoint, closed loop.

It is the deformable trainer traffic of ``traffic/trainer_deform.py`` (and
through it ``traffic/trainer.py``), reused by import, with the HexPlane
field of the configuration's ``hexplane`` section in place of the MLP: the
configuration's "true" field (drawn from ``motion.field_seed``: spatial
planes as the published init draws them, time planes 1 +
``motion.time_plane_amp`` x uniform noise, the init's decoder with its
heads' last linears scaled so that the offsets reach the configured RMS)
moves the true scene, offsets added before the activations, and each
target view is rendered by the reference at its time v / (V - 1). The
checkpoint holds the noisy gaussians and the true field plus seeded noise
with the box of the true scene's points, Adam moments as the static state
has them (mu 0, nu the square of each tensor's gradient RMS as the
reference measures it). Spans are on from the window's open; a traced run's
stretch hands its attribution to the readers (``span_stretch``), with the
rows the field took a view, under the layer key ``hexplane``.

Checks, each beside its limit: the trainer cell's four (the field's 26
tensors among the leaves of ``grad_norm_gap`` and ``change_norm_gap``),
``deform_rel_err``, the worst over the first step's four views of
``trainer_deform.deform_rel_err`` (the largest |offset - reference offset|
over the RMS of the reference's offsets of the alive slots, the worst of dx,
dr and ds), and ``means_grad_gap``, the means' own gap of the first
gradient's norm: the field's path into the means moves it by 3e-5-1e-3,
inside the worst leaf's sound ``grad_norm_gap``. The trainer measures the compact
binning's footprints on the gaussians the field moves (each measured view
at its time); the reference does the same.
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
from portbench.reference import hexplane as RH
from portbench.reference import render as R

D = harness.traffic_driver("trainer_deform")
T = D.T
LEAVES = D.LEAVES


class HexPlaneRecorder(D.DeformRecorder):
    """The deformable cell's recorder; the field's tensors are the
    network's, and every offset of the first step is kept."""

    def capture(self, offsets_fn):
        """``offsets_fn`` (the program's ``models.hexplane.offsets``) keeping
        the first step's offsets of each view on the host."""
        self.offsets0 = []

        def capturing(*a, **k):
            out = offsets_fn(*a, **k)
            if self.steps == 0 and torch.is_grad_enabled():
                self.offsets0.append([T._host(o) for o in out])
            return out

        return capturing


def true_field(c: dict, scene: dict, box: torch.Tensor, extent: float, dev):
    """The configuration's true field, drawn from ``motion.field_seed`` (one
    motion for every run, as the scene's object places are fixed): the
    init's spatial planes and decoder, time planes 1 + ``time_plane_amp`` x
    uniform(-1, 1), the heads' last linears scaled so that over a sample of
    the scene at three times dx's RMS is ``motion.dx_rel`` x the extent,
    dr's ``motion.dr_rms`` and ds's ``motion.ds_rms``."""
    spec, mo = c["hexplane"], c["motion"]
    g = S.generator(dev, int(mo["field_seed"]), 9)
    net = RH.init_field(spec, g, dev)
    for name in RH.plane_names(spec):
        if 3 in RH.PAIRS[int(name.rsplit(".", 1)[1])]:
            net[name] += mo["time_plane_amp"] * (
                torch.rand(net[name].shape, generator=g, device=dev) * 2.0 - 1.0)
    x = scene["means"][:: max(1, scene["means"].shape[0] // 65536)]
    outs = [RH.block_offsets(net, spec, box, x, t) for t in (0.0, 0.5, 1.0)]
    want = {"pos_deform": (0, mo["dx_rel"] * extent), "rotations_deform": (1, mo["dr_rms"]),
            "scales_deform": (2, mo["ds_rms"])}
    for name, (j, rms_want) in want.items():
        rms = float(torch.cat([o[j] for o in outs]).pow(2).mean().sqrt())
        net[f"{name}.3.weight"] *= rms_want / rms
        net[f"{name}.3.bias"] *= rms_want / rms
    return net


def make_inputs(c: dict, tr: dict, seed: int, dev, note=lambda msg: None):
    """The cell's inputs from the seed: the targets rendered by the
    reference from the true scene moved by the true field at each view's
    time, and the checkpoint of the noisy state with the field (``ckpt``,
    in memory), with the host arrays and the field the reference starts
    from."""
    from gaussian_splatting_tpu_torch.training.config import TrainingConfig

    tcfg = TrainingConfig(**c["training"])
    W, H, N, deg = c["width"], c["height"], c["gaussians"], c["sh_degree"]
    V = int(c["views"])
    spec = c["hexplane"]
    scene = S.true_scene(N, c["scene"], seed, dev)
    viewmats = S.orbit_views(V, c["cameras"])
    K = R.intrinsics(W, H, c["cameras"]["focal_px"])
    extent = S.scene_extent(scene["means"], viewmats)
    times = (np.arange(V, dtype=np.float64) / max(V - 1, 1)).astype(np.float32)
    box = torch.stack([scene["means"].min(0).values, scene["means"].max(0).values])
    net_true = true_field(c, scene, box, extent, dev)
    note(f"scene made, extent {extent:.4f}, box {box.tolist()}")
    t0 = time.perf_counter()
    rows = torch.arange(N, device=dev)
    images = np.empty((V, H, W, 3), np.uint8)
    for v in range(V):
        offs = RH.offsets(net_true, spec, box, scene["means"], rows, float(times[v]))
        moved = RH.deformed_params(scene, offs)
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
    hs = c["hexplane_state"]
    g = S.generator(dev, seed, 10)
    net0 = {k: v + hs["weight_noise"] * v.pow(2).mean().sqrt()
            * torch.randn(v.shape, generator=g, device=dev) for k, v in net_true.items()}
    net_nu = {k: torch.full_like(v, float(hs["nu_rms"][k]) ** 2) for k, v in net0.items()}
    arrays = dict(np.load(ckpt))
    for k in net0:
        arrays[f"hexplane/params/{k}"] = T._host(net0[k])
        arrays[f"hexplane/adam_mu/{k}"] = np.zeros(net0[k].shape, np.float32)
        arrays[f"hexplane/adam_nu/{k}"] = T._host(net_nu[k])
    arrays["hexplane/box"] = T._host(box)
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
                           net_nu=net_nu, spec=spec, box=box)


def reference_run(inp, c: dict, n_steps: int, dev, dtype=torch.float32, faults=None):
    """The reference's first ``n_steps`` steps, with the tile cap, the class
    budgets and the batches worked out again; ``dtype`` and ``faults`` as
    ``reference/hexplane.py::reference_steps`` takes them."""
    tcfg = inp.tcfg
    alive = inp.init["alive"]
    ref_k = [inp.K] * inp.V
    # The footprints of the gaussians the field moves, each measured view's
    # at its time, as the trainer measures them.
    p_dev = {k: torch.as_tensor(inp.init[k], device=dev) for k in LEAVES}
    alive_t = torch.as_tensor(alive, device=dev)
    rows = torch.nonzero(alive_t).reshape(-1)
    counts = []
    for i in D.RT.measured_views(inp.V):
        offs = RH.offsets(inp.net0, inp.spec, inp.box, p_dev["means"], rows, float(inp.times[i]))
        counts += D.RT.footprint_counts(RH.deformed_params(p_dev, offs), alive_t,
                                        inp.viewmats[i:i + 1], ref_k[i:i + 1], inp.W, inp.H,
                                        tcfg.tile_size)
        del offs
    del p_dev
    max_t = (D.RT.choose_max_tiles(counts, inp.capacity, tcfg.max_tiles_per_gaussian,
                                   tcfg.max_sort_entries)
             if tcfg.auto_max_tiles else tcfg.max_tiles_per_gaussian)
    budgets = tcfg.class_budgets
    if tcfg.binning in ("auto", "compact") and budgets is None:
        budgets = D.RT.choose_class_budgets(counts, inp.capacity, max_t, tcfg.max_sort_entries)
    batches = D.RT.batch_schedule(inp.V, tcfg.batch_size, n_steps, tcfg.val_seed,
                                  tcfg.val_fraction, tcfg.val_max_views)
    times = [inp.times[np.asarray(views)] for views in batches]
    rcfg = T.reference_config(tcfg, c, inp.extent)
    ref = RH.reference_steps(inp.init, inp.net0, inp.net_nu, inp.spec, c["hexplane_schedule"],
                             inp.box, alive, inp.viewmats, ref_k, inp.images, times, batches,
                             rcfg, inp.deg, max_t, budgets, inp.it0, inp.it0,
                             tcfg.deform_warmup, dev, dtype=dtype, faults=faults)
    ref.update(max_t=max_t, budgets=budgets, rcfg=rcfg, times=times)
    return ref


def means_grad_gap(got: dict, ref: dict) -> float:
    """|the first gradient's norm of the means - the reference's| over the
    reference's: the means' own share of ``grad_norm_gap``, whose worst leaf
    (a decoder head's bias summed over 1M rows) can hide it."""
    return abs(got["grad_norms"]["means"] - ref["grad_norms"]["means"]) / ref["grad_norms"]["means"]


def deform_rel_err(got, want, alive: np.ndarray) -> float:
    """The worst over the views of ``trainer_deform.deform_rel_err``; NaN
    unless the program's offsets of every view were kept."""
    if not got or len(got) != len(want):
        return float("nan")
    return max(D.deform_rel_err(a, b, alive) for a, b in zip(got, want))


def run(ctx: harness.Ctx) -> harness.Outcome:
    from gaussian_splatting_tpu_torch.models import hexplane as program_hexplane
    from gaussian_splatting_tpu_torch.training.trainer import GaussianTrainer, ViewDataset
    from gaussian_splatting_tpu_torch.utils.metrics import MetricsLogger

    dev = ctx.device
    c, tr, lim = ctx.config, ctx.workload["traffic"], ctx.workload["limits"]
    harness.note(ctx, f"{ctx.cell}: seed {ctx.seed}, {c['gaussians']} gaussians, "
                      f"{c['width']}x{c['height']}, HexPlane field {c['hexplane']}")
    inp = make_inputs(c, tr, ctx.seed, dev, lambda msg: harness.note(ctx, msg))
    tcfg, W, H = inp.tcfg, inp.W, inp.H
    dataset = ViewDataset(images=inp.images, viewmats=inp.viewmats.numpy(),
                          Ks=np.repeat(inp.K.numpy()[None], inp.V, 0), times=inp.times)

    # ---- the program: set-up, warm-up, window ---------------------------------
    rec = HexPlaneRecorder(ctx, int(tr["warmup_steps"]), int(tr["reference_steps"]),
                           int(tr["trace_steps"]), tcfg.adam_b1, inp.targets_s)
    trainer = T._trainer_class(GaussianTrainer, rec)(
        tcfg, logger=T._logger_class(MetricsLogger, rec)(ctx.out_dir), device=dev)
    harness.note(ctx, f"checkpoint at iteration {inp.it0}, capacity {inp.capacity}")
    harness.reset_peak(dev)
    offsets_fn = program_hexplane.offsets
    program_hexplane.offsets = rec.capture(offsets_fn)
    try:
        trainer.train(dataset, ctx.out_dir, resume_from=inp.ckpt)
        raise RuntimeError("the trainer ran out of iterations before the window closed")
    except T.WindowClosed:
        pass
    finally:
        program_hexplane.offsets = offsets_fn
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
    checks = D.step_gaps(got, ref, keys)
    checks["densify_slots_differ"], counts = T.densify_differences(rec, ref["rcfg"],
                                                                   tcfg.val_seed, dev)
    alive = inp.init["alive"]
    checks["deform_rel_err"] = deform_rel_err(rec.offsets0, ref["offsets"], alive)
    checks["means_grad_gap"] = means_grad_gap(got, ref)
    harness.note(ctx, f"reference densify: {counts}")
    harness.note(ctx, f"gradient norms program {got['grad_norms']} reference "
                      f"{ref['grad_norms']}")
    harness.note(ctx, f"changes program {got['change_norms']} reference "
                      f"{ref['change_norms']}")
    view = {"pairs": float(np.mean(ref["pairs"])), "n_isect": float(np.mean(ref["isects"])),
            "pixels": float(W * H), "tiles": float(R.cdiv(W, tcfg.tile_size)
                                                   * R.cdiv(H, tcfg.tile_size))}
    rows = rec.stretch_rows if summary is not None and rec.stretch_rows else None
    layer = {"kind": "train", "trace": summary, "view": view,
             "views_per_unit": tcfg.batch_size, "n_gaussians": float(alive.sum()),
             "sh_degree": inp.deg, "event_s": rec.event_s, "window_s": window_s, "units": iters,
             "span_stretch": attribution,
             "hexplane": {"spec": inp.spec, "stretch_rows": rows,
                          "rows_per_view": (rows / (rec.trace_steps * tcfg.batch_size)
                                            if rows else None),
                          "plane_floats": float(sum(v.numel() for k, v in inp.net0.items()
                                                    if k.startswith("grids."))),
                          "decoder_params": float(sum(v.numel() for k, v in inp.net0.items()
                                                      if not k.startswith("grids.")))}}
    return harness.Outcome(
        attempted=iters, failed=rec.failed,
        end_to_end={"train_iter_ms": 1e3 * window_s / iters, "setup_s": rec.setup_s,
                    "peak_mem_gib": peak / 2**30},
        checks={k: [float(v), float(lim[k])] for k, v in checks.items()},
        peak_bytes=peak, layer=layer)
