"""Mesh-trainer traffic: the trainer traffic of ``traffic/trainer.py``
(reused by import: its inputs, recorder, events and checks) on a
``mesh_data`` x ``mesh_tile`` mesh, one process a card over NCCL, as
``train_cli --mesh-data D --mesh-model M`` runs under ``torchrun``.

The process the harness runs is rank 0 on the card it was given; it starts
the other ranks itself (this file run as a script, one a card, ``cuda:r``),
makes the inputs and broadcasts them (the targets, the checkpoint's bytes,
the extent), and keeps the clock: every ``DECIDE_EVERY`` steps in the window
it tells every rank over a gloo group whether the window has closed, so that
every rank takes the same steps (the window closes up to ``DECIDE_EVERY`` - 1
steps past its deadline, and its time is taken at the step it closes on);
between two decisions the ranks' hosts run free of each other, as under
``torchrun``. Rank 0 notes the median step time of each quarter of the
window, read at the step boundaries on the host. A traced run profiles rank
0's stretch.
After the window every rank reports its peak memory (``peak_mem_gib`` is
the largest) and whether JAX or the JAX package was loaded in it (which
fails the run); rank 0 then holds the gathered state's first steps and its
first densify against the plain reference with the trainer cell's four
limits: the trainer cell's reference of the same batch, each view rendered
band by band as the mesh renders it (``reference/mesh.py``). Runs on the
CPU too (gloo, four processes), as the benchmark's tests run it.
"""

from __future__ import annotations

import argparse
import datetime
import gc
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from portbench import harness  # noqa: E402
from portbench import scene as S  # noqa: E402
from portbench.reference import mesh as RM  # noqa: E402
from portbench.reference import render as R  # noqa: E402
from portbench.reference import train as RT  # noqa: E402

T = harness.traffic_driver("trainer")
LEAVES = T.LEAVES
TIMEOUT = datetime.timedelta(seconds=300)
DECIDE_EVERY = 10


class MeshRecorder(T.Recorder):
    """The trainer cell's recorder on one rank of the mesh: rank 0 decides
    when the window closes and every rank follows; the first gradient norms
    and the parameters after the reference's steps are read from the
    gathered state."""

    def __init__(self, *a, rank: int, signal_group, mesh_ref, children=()):
        super().__init__(*a)
        self.rank = rank
        self.signal_group = signal_group
        self.mesh_ref = mesh_ref
        self.children = list(children)
        self.stamps = []

    def _decide(self, close: bool) -> bool:
        flag = torch.tensor([int(close)], dtype=torch.int64)
        dist.broadcast(flag, src=0, group=self.signal_group)
        return bool(flag.item())

    def _check_children(self):
        for p in self.children:
            if p.poll() not in (None, 0):
                raise RuntimeError(f"a rank of the mesh exited with code {p.returncode}")

    def boundary(self):
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
        if self.stretch_step is not None:
            if n - self.stretch_step == self.trace_steps:
                harness.sync(self.dev)
                if self.stretch is not None:
                    self.stretch.stop(self.trace_steps)
                raise T.WindowClosed()
            return
        if self.in_window and self.rank == 0:
            self.stamps.append(time.perf_counter())
        if self.in_window and n > self.open_step and (n - self.open_step) % DECIDE_EVERY == 0:
            close = False
            if self.rank == 0:
                self._check_children()
                close = time.perf_counter() >= self.deadline
            if self._decide(close):
                harness.sync(self.dev)
                self.t_close = time.perf_counter()
                self.in_window = False
                self.close_step = n
                if not self.ctx.trace:
                    raise T.WindowClosed()
                self.stretch_step = n
                if self.rank == 0:
                    self.stretch = T.Stretch(self.dev)
                    self.stretch.start()

    def wrap(self, step):
        from gaussian_splatting_tpu_torch.parallel.sharded_step import gather_state

        def wrapped(state, batch):
            self.boundary()
            if self.params_after == {}:
                whole = gather_state(state, self.mesh_ref)
                self.params_after = {k: T._host(getattr(whole.gauss.params, k)) for k in LEAVES}
                del whole
            state, metrics = step(state, batch)
            self.steps += 1
            if self.steps <= self.ref_steps:
                self.losses.append(float(metrics["loss"]))
            if self.steps == 1:
                whole = gather_state(state, self.mesh_ref)
                self.grad_norms = {k: float(torch.linalg.norm(getattr(whole.opt.mu, k)))
                                   / (1.0 - self.b1) for k in LEAVES}
                del whole
            return state, metrics

        return wrapped


def quarter_medians(stamps) -> list:
    """The median interval (ms) between step boundaries in each quarter of
    the window, from rank 0's host stamps."""
    d = np.diff(np.asarray(stamps)) * 1e3
    return [round(float(np.median(q)), 2) for q in np.array_split(d, 4) if len(q)]


def reference_run(inp, c: dict, n_steps: int, dev):
    """``traffic/trainer.py``'s reference run on the mesh's terms: the tile
    cap from the whole image's footprints, the class budgets from the
    bands', each view rendered band by band (``reference/mesh.py``)."""
    tcfg, M = inp.tcfg, inp.tcfg.mesh_tile
    p_dev = {k: torch.as_tensor(inp.init[k], device=dev) for k in LEAVES}
    alive = torch.as_tensor(inp.init["alive"], device=dev)
    ref_k = [inp.K] * inp.V
    counts = RT.footprint_counts(p_dev, alive, inp.viewmats, ref_k, inp.W, inp.H,
                                 tcfg.tile_size)
    max_t = (RT.choose_max_tiles(counts, inp.capacity, tcfg.max_tiles_per_gaussian,
                                 tcfg.max_sort_entries)
             if tcfg.auto_max_tiles else tcfg.max_tiles_per_gaussian)
    budgets = tcfg.class_budgets
    if tcfg.binning in ("auto", "compact") and budgets is None:
        band_counts = RM.band_footprint_counts(p_dev, alive, inp.viewmats, ref_k, inp.W, inp.H,
                                               tcfg.tile_size, M)
        budgets = RT.choose_class_budgets(band_counts, inp.capacity, max_t,
                                          tcfg.max_sort_entries)
    del p_dev
    batches = RT.batch_schedule(inp.V, tcfg.batch_size, n_steps, tcfg.val_seed,
                                tcfg.val_fraction, tcfg.val_max_views)
    rcfg = T.reference_config(tcfg, c, inp.extent)
    ref = RM.banded_reference(M).reference_steps(
        inp.init, inp.init["alive"], inp.viewmats, ref_k, inp.images, batches, rcfg, inp.deg,
        max_t, budgets, inp.it0, inp.it0, dev)
    ref.update(max_t=max_t, budgets=budgets, rcfg=rcfg)
    return ref


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _broadcast_bytes(data, dev, src: int = 0) -> bytes:
    """``data`` (bytes on rank ``src``, None elsewhere) on every rank."""
    n = torch.tensor([len(data) if data is not None else 0], dtype=torch.int64, device=dev)
    dist.broadcast(n, src=src)
    buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev) if data is not None
           else torch.empty(int(n.item()), dtype=torch.uint8, device=dev))
    dist.broadcast(buf, src=src)
    return buf.cpu().numpy().tobytes()


def _shared_inputs(ctx, rank: int, dev):
    """Rank 0 makes the inputs (``traffic/trainer.py``'s ``make_inputs``) and
    every rank receives the targets, the checkpoint and the extent."""
    c, tr = ctx.config, ctx.workload["traffic"]
    inp = None
    if rank == 0:
        inp = T.make_inputs(c, tr, ctx.seed, dev, lambda msg: harness.note(ctx, msg))
        extent = torch.tensor([inp.extent], dtype=torch.float64, device=dev)
        images = torch.as_tensor(inp.images).to(dev)
        ckpt = inp.ckpt.getvalue()
    else:
        extent = torch.zeros(1, dtype=torch.float64, device=dev)
        V, H, W = int(c["views"]), c["height"], c["width"]
        images = torch.empty((V, H, W, 3), dtype=torch.uint8, device=dev)
        ckpt = None
    dist.broadcast(extent, src=0)
    dist.broadcast(images, src=0)
    ckpt = _broadcast_bytes(ckpt, dev)
    if inp is None:
        from types import SimpleNamespace

        from gaussian_splatting_tpu_torch.training.config import TrainingConfig

        viewmats = S.orbit_views(int(c["views"]), c["cameras"])
        inp = SimpleNamespace(tcfg=TrainingConfig(**c["training"]), viewmats=viewmats,
                              K=R.intrinsics(c["width"], c["height"], c["cameras"]["focal_px"]),
                              V=int(c["views"]), W=c["width"], H=c["height"], targets_s=0.0,
                              it0=int(tr["resume_iteration"]))
    inp.images = images.cpu().numpy()
    inp.extent = float(extent.item())
    inp.ckpt = io.BytesIO(ckpt)
    inp.tcfg = inp.tcfg.replace(mesh_data=int(tr["mesh_data"]), mesh_tile=int(tr["mesh_tile"]))
    return inp


def _train(ctx, rank: int, signal_group, children=()):
    """One rank's run of the program: set-up, warm-up, window (and a traced
    stretch); returns the recorder, the inputs and this rank's peak."""
    from gaussian_splatting_tpu_torch.parallel.mesh import make_mesh
    from gaussian_splatting_tpu_torch.training.trainer import GaussianTrainer, ViewDataset
    from gaussian_splatting_tpu_torch.utils.metrics import MetricsLogger

    dev, tr = ctx.device, ctx.workload["traffic"]
    inp = _shared_inputs(ctx, rank, dev)
    tcfg = inp.tcfg
    mesh = make_mesh(tcfg.mesh_data, tcfg.mesh_tile, device=dev)
    dataset = ViewDataset(images=inp.images, viewmats=inp.viewmats.numpy(),
                          Ks=np.repeat(inp.K.numpy()[None], inp.V, 0))
    rec = MeshRecorder(ctx, int(tr["warmup_steps"]), int(tr["reference_steps"]),
                       int(tr["trace_steps"]), tcfg.adam_b1, inp.targets_s, rank=rank,
                       signal_group=signal_group, mesh_ref=mesh, children=children)
    trainer = T._trainer_class(GaussianTrainer, rec)(
        tcfg, logger=T._logger_class(MetricsLogger, rec)(ctx.out_dir), device=dev, mesh=mesh)
    harness.reset_peak(dev)
    try:
        trainer.train(dataset, ctx.out_dir, resume_from=inp.ckpt)
        raise RuntimeError("the trainer ran out of iterations before the window closed")
    except T.WindowClosed:
        pass
    peak = harness.peak_bytes(dev)
    del trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec, inp, peak


def _report(peak: int, signal_group) -> tuple:
    """(the largest peak, whether any rank loaded JAX) over the mesh."""
    v = torch.tensor([peak, int(bool(harness.forbidden_modules()))], dtype=torch.int64)
    dist.all_reduce(v, op=dist.ReduceOp.MAX, group=signal_group)
    return int(v[0]), bool(v[1])


def _init(rank: int, world: int, port: int, dev) -> object:
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=TIMEOUT)
    return dist.new_group(backend="gloo", timeout=TIMEOUT)


def _watch(children, done: threading.Event) -> None:
    """Until ``done``: a rank that exits with an error ends this process
    too (rank 0 may be waiting in a collective for it), the others first."""
    while not done.wait(1.0):
        bad = [p.returncode for p in children if p.poll() not in (None, 0)]
        if bad:
            print(f"portbench: a rank of the mesh exited with code {bad[0]}", file=sys.stderr,
                  flush=True)
            for p in children:
                if p.poll() is None:
                    p.kill()
            os._exit(3)


def run(ctx: harness.Ctx) -> harness.Outcome:
    dev = ctx.device
    c, tr, lim = ctx.config, ctx.workload["traffic"], ctx.workload["limits"]
    world = int(tr["mesh_data"]) * int(tr["mesh_tile"])
    harness.note(ctx, f"{ctx.cell}: seed {ctx.seed}, {c['gaussians']} gaussians, "
                      f"{c['width']}x{c['height']}, a {tr['mesh_data']}x{tr['mesh_tile']} mesh")
    if dev.type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"the mesh needs {world} CUDA devices")
    port = _free_port()
    spec = Path(ctx.out_dir) / "mesh_spec.json"
    spec.write_text(json.dumps({"cell": ctx.cell, "config": c, "workload": ctx.workload}))
    children = []
    done = threading.Event()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(harness.ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    try:
        for r in range(1, world):
            children.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--rank", str(r), "--world",
                 str(world), "--port", str(port), "--spec", str(spec), "--seed", str(ctx.seed),
                 "--seconds", str(ctx.seconds), "--trace", str(int(ctx.trace)), "--device",
                 dev.type, "--t-start", repr(ctx.t_start)],
                stdout=sys.stderr, stderr=sys.stderr, env=env))
        threading.Thread(target=_watch, args=(children, done), daemon=True).start()
        signal_group = _init(0, world, port, dev)
        rec, inp, peak = _train(ctx, 0, signal_group, children)
        peak, jax_loaded = _report(peak, signal_group)
        dist.destroy_process_group()
        if jax_loaded:
            raise RuntimeError("a rank of the mesh loaded JAX or the JAX package")
        done.set()
        for p in children:
            if p.wait(timeout=120) != 0:
                raise RuntimeError(f"a rank of the mesh exited with code {p.returncode}")
    finally:
        done.set()
        for p in children:
            if p.poll() is None:
                p.kill()
    window_s = rec.t_close - rec.t_open
    iters = rec.window_steps
    harness.note(ctx, f"window closed: {iters} steps in {window_s:.3f} s, set-up "
                      f"{rec.setup_s:.2f} s, largest peak {peak / 2**30:.3f} GiB; median step "
                      f"ms by quarter {quarter_medians(rec.stamps)}")
    summary = rec.stretch.summarize(ctx.trace_file) if rec.stretch is not None else None

    # ---- the reference (rank 0) -------------------------------------------------
    tcfg = inp.tcfg
    ref = reference_run(inp, c, int(tr["reference_steps"]), dev)
    harness.note(ctx, f"reference: max_t {ref['max_t']}, budgets {ref['budgets']}, "
                      f"intersections {ref['isects']}, losses {ref['losses']}")
    got = {"losses": rec.losses, "grad_norms": rec.grad_norms,
           "change_norms": {k: float(np.linalg.norm((rec.params_after[k].astype(np.float64)
                                                     - inp.init[k].astype(np.float64)).ravel()))
                            for k in LEAVES}}
    checks = T.step_gaps(got, ref)
    checks["densify_slots_differ"], counts = T.densify_differences(rec, ref["rcfg"],
                                                                   tcfg.val_seed, dev)
    harness.note(ctx, f"reference densify: {counts}; program losses {rec.losses}, gradient "
                      f"norms {rec.grad_norms}; reference {ref['grad_norms']}")
    view = {"pairs": float(np.mean(ref["pairs"])), "n_isect": float(np.mean(ref["isects"])),
            "pixels": float(inp.W * inp.H), "tiles": float(R.cdiv(inp.W, tcfg.tile_size)
                                                           * R.cdiv(inp.H, tcfg.tile_size))}
    layer = {"kind": "train", "trace": summary, "view": view,
             "views_per_unit": tcfg.batch_size, "n_gaussians": float(inp.init["alive"].sum()),
             "sh_degree": inp.deg, "event_s": rec.event_s, "window_s": window_s, "units": iters,
             "mesh": [tcfg.mesh_data, tcfg.mesh_tile]}
    return harness.Outcome(
        attempted=iters, failed=rec.failed,
        end_to_end={"train_iter_ms": 1e3 * window_s / iters, "setup_s": rec.setup_s,
                    "peak_mem_gib": peak / 2**30},
        checks={k: [float(v), float(lim[k])] for k, v in checks.items()},
        peak_bytes=peak, layer=layer)


def main(argv=None) -> int:
    """A rank r > 0 of the mesh: its card ``cuda:r`` (or the CPU), the
    trainer on the inputs rank 0 broadcasts, the window's steps as rank 0
    decides, then its peak and its modules reported."""
    ap = argparse.ArgumentParser(description="one rank > 0 of the mesh trainer traffic")
    for k in ("--rank", "--world", "--port", "--seed", "--trace"):
        ap.add_argument(k, type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--t-start", type=float, required=True)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    harness.prepare_env()
    torch.set_num_threads(4 if args.device == "cuda" else 1)
    dev = torch.device("cuda", args.rank) if args.device == "cuda" else torch.device("cpu")
    spec = json.loads(Path(args.spec).read_text())
    import tempfile

    with tempfile.TemporaryDirectory(prefix=f"portbench-rank{args.rank}-") as out_dir:
        ctx = harness.Ctx(cell=spec["cell"], workload=spec["workload"], config=spec["config"],
                          seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                          device=dev, out_dir=out_dir, t_start=args.t_start)
        signal_group = _init(args.rank, args.world, args.port, dev)
        _, _, peak = _train(ctx, args.rank, signal_group)
        _report(peak, signal_group)
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
