"""PyTorch port, ``utils/profiling.py`` on the CPU: the trace and its named
spans, the span recorder (off by default, nesting, the backward's spans,
the bounded buffer), the counters, and the timing harnesses
(``time_fn_device`` with CUDA events stood in by a host clock, to hold its
formula)."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gaussian_splatting_tpu_torch.models.gaussians import (
    train_state_from_numpy,
    train_state_to_numpy,
)
from gaussian_splatting_tpu_torch.ops.facade import GaussianRasterizer
from gaussian_splatting_tpu_torch.ops.render import render
from gaussian_splatting_tpu_torch.training import step as t_step
from gaussian_splatting_tpu_torch.training import trainer as t_trainer
from gaussian_splatting_tpu_torch.training.config import TrainingConfig
from gaussian_splatting_tpu_torch.utils import profiling
from test_training import _synthetic_scene
from torch_parity import scene_3d, to_torch, train_state_arrays

W, H = 64, 48
K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)


def _look_at(eye):
    """A world-to-camera matrix looking from ``eye`` at the origin, +y up."""
    eye = np.asarray(eye, np.float64)
    f = -eye / np.linalg.norm(eye)
    r = np.cross(f, (0.0, 1.0, 0.0))
    r /= np.linalg.norm(r)
    u = np.cross(f, r)
    m = np.eye(4)
    m[:3, :3] = np.stack([r, u, f])
    m[:3, 3] = -m[:3, :3] @ eye
    return m.astype(np.float32)


VIEWS = np.stack([_look_at(e) for e in ((0.4, -0.3, -3.5), (-0.8, 0.2, -3.2))])


@pytest.fixture
def spans_on():
    """Spans on, from an empty buffer; off and cleared again afterwards."""
    profiling.reset()
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()
        profiling.reset()


def _tree(recs):
    """(name, parent name) of each record."""
    return [(r.name, recs[r.parent].name if r.parent >= 0 else None) for r in recs]


def _step_once(on: bool):
    """One ``make_train_step`` step, 64x48, batch 2, SH 3, the cuda
    backend's plain kernels: the state after it and its metrics, as numpy."""
    rng = np.random.default_rng(0)
    arrays = train_state_arrays(rng, 150)
    images = np.clip(rng.uniform(-0.1, 1.1, size=(2, H, W, 3)), 0, 1).astype(np.float32)
    fn = t_step.make_train_step(TrainingConfig(), W, H, 3, "cuda", 2.0, device="cpu")
    batch = t_step.ViewBatch(*to_torch(images, VIEWS, np.stack([K, K])))
    if on:
        profiling.enable()
    try:
        state, metrics = fn(train_state_from_numpy(arrays, device="cpu"), batch)
    finally:
        profiling.disable()
    return train_state_to_numpy(state), {k: v.numpy() for k, v in metrics.items()}


def _graph_nodes(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        n = todo.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        todo.extend(f for f, _ in n.next_functions)
    return len(seen)


def test_trace_exports_a_chrome_trace_with_the_annotated_span(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("gs_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert "gs_span" in names
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "gs_span" for e in events)
    assert not profiling.enabled()


def test_spans_off_record_nothing_and_add_no_autograd_node():
    profiling.reset()
    assert not profiling.enabled()
    assert profiling.annotate("a") is profiling.annotate("b")
    with profiling.annotate("a"):
        pass
    x = torch.ones(5, requires_grad=True)
    mark = profiling.grad_span("r.bwd")
    y = mark.input(x)
    z = mark.outputs(y * 2.0)
    assert y is x and _graph_nodes(z.sum()) == _graph_nodes((x * 2.0).sum())
    z.sum().backward()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_spans_on_add_no_profiler_event_outside_trace(spans_on):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("gs_quiet"):
            torch.ones(8) + 1
    assert "gs_quiet" not in {e.name for e in prof.events()}
    assert [r.name for r in profiling.spans()] == ["gs_quiet"]


def test_a_step_is_bit_identical_with_spans_on_and_off():
    off, off_m = _step_once(False)
    profiling.reset()
    on, on_m = _step_once(True)
    assert profiling.spans()
    profiling.reset()
    for k in off:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)
    for k in off_m:
        np.testing.assert_array_equal(on_m[k], off_m[k], err_msg=k)


def test_a_render_and_its_gradients_are_bit_identical_with_spans_on_and_off():
    leaves = to_torch(*scene_3d(np.random.default_rng(1), 200))

    def once(on):
        if on:
            profiling.enable()
        try:
            ps = [t.clone().requires_grad_(True) for t in leaves]
            out = render(*ps, VIEWS[0], K, W, H, backend="cuda", device="cpu")
            (out.render * torch.linspace(0, 1, 3)).sum().backward()
            frame = GaussianRasterizer(W, H, device="cpu").render_single(
                dict(zip(("means3D", "rotations", "scales", "opacities", "shs"), leaves)),
                {"world_view_transform": VIEWS[1], "K": K})
        finally:
            profiling.disable()
        return [out.render.detach(), frame.render] + [p.grad for p in ps]

    off = once(False)
    profiling.reset()
    on = once(True)
    names = [r.name for r in profiling.spans()]
    profiling.reset()
    assert names == ["render.project_sh", "render.binning", "render.raster_fwd",
                     "render.raster_bwd", "render.reduce", "render.project_sh.bwd",
                     "render.frame", "render.project_sh", "render.binning",
                     "render.raster_fwd"]
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_step_spans_nest_with_their_parents():
    """Each view's forward spans under the step's caller; the backward's
    spans, the raster backward and the reduce and the two regions' ``.bwd``
    spans, inside ``step.backward`` in the engine's order (the last view
    first); ``step.adam`` last."""
    profiling.reset()
    _step_once(True)
    recs = profiling.spans()
    profiling.reset()
    fwd = [("render.project_sh", None), ("render.binning", None),
           ("render.raster_fwd", None), ("step.loss", None)]
    bwd = [("step.loss.bwd", "step.backward"), ("render.raster_bwd", "step.backward"),
           ("render.reduce", "step.backward"), ("render.project_sh.bwd", "step.backward")]
    assert _tree(recs) == fwd * 2 + [("step.backward", None)] + bwd * 2 + [("step.adam", None)]
    back = next(r for r in recs if r.name == "step.backward")
    for r in recs:
        assert r.end_ns >= r.start_ns > 0
        if r.name.endswith(("_bwd", ".bwd", ".reduce")):
            assert back.start_ns <= r.start_ns and r.end_ns <= back.end_ns, r.name
    # The two backward regions of a view follow each other without overlap.
    b = [r for r in recs if r.parent >= 0]
    assert all(x.end_ns <= y.start_ns for x, y in zip(b, b[1:]))


def test_trainer_spans_mark_the_step_and_each_event(rng, tmp_path, spans_on):
    ds, gt = _synthetic_scene(rng, n_views=8)
    cfg = TrainingConfig(iterations=8, batch_size=2, backend="cuda", initial_gaussians=60,
                         max_gaussians=4096, densify_from_iteration=2, densify_interval=4,
                         densify_topk_fraction=0.2, opacity_reset_interval=100,
                         val_interval=8, checkpoint_interval=8, log_scalar_interval=4,
                         log_hist_interval=8, log_image_interval=0, sh_degree_max=0)
    t_trainer.GaussianTrainer(cfg, device="cpu").train(
        t_trainer.ViewDataset(ds.images, ds.viewmats, ds.Ks), str(tmp_path / "run"),
        points=gt)
    tree = _tree(profiling.spans())
    top = {n for n, p in tree if p is None}
    assert top == {"train.batch", "train.step", "train.log", "train.watch_budgets",
                   "train.watch_tile_cap", "train.densify", "train.histograms",
                   "train.validate", "train.checkpoint"}
    assert sum(n == "train.step" for n, _ in tree) == 8
    assert {p for n, p in tree if n in ("step.loss", "step.backward", "step.adam")} == {
        "train.step"}
    assert {p for n, p in tree if n == "render.raster_bwd"} == {"step.backward"}
    # Validation renders through the same layers, under its own span.
    assert ("render.project_sh", "train.validate") in tree


def test_a_span_on_another_thread_takes_the_waiting_threads_span_as_parent(spans_on):
    """As the autograd engine's device thread does during ``backward()``:
    with no span of its own open, it nests under the innermost span open on
    the thread that waits for it; its own children nest under it."""

    def worker():
        with profiling.annotate("render.raster_bwd"):
            with profiling.annotate("inner"):
                pass

    with profiling.annotate("train.step"):
        with profiling.annotate("step.backward"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    recs = profiling.spans()
    assert _tree(recs) == [("train.step", None), ("step.backward", "train.step"),
                           ("render.raster_bwd", "step.backward"),
                           ("inner", "render.raster_bwd")]
    assert recs[2].tid != recs[0].tid == threading.get_native_id()


def test_a_full_buffer_counts_the_spans_it_drops():
    profiling.reset()
    profiling.enable(capacity=4)
    try:
        with profiling.annotate("outer"):
            for i in range(5):
                with profiling.annotate(f"s{i}"):
                    pass
        with profiling.annotate("after"):
            pass
    finally:
        profiling.disable()
    recs = profiling.spans()
    assert [r.name for r in recs] == ["outer", "s0", "s1", "s2"]
    assert profiling.dropped() == 3
    assert all(r.end_ns >= r.start_ns for r in recs)
    profiling.enable()  # back to the default capacity: a new, empty buffer
    profiling.disable()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_threads_lose_no_count_and_no_span():
    """More threads than cores, switching every few microseconds: every
    count and every span arrives, each span under its own thread's outer
    span."""
    import os
    import sys

    n_threads, reps = 2 * (os.cpu_count() or 4), 200
    profiling.reset_counters()
    profiling.reset()
    profiling.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        with profiling.annotate("outer"):
            for _ in range(reps):
                with profiling.annotate("inner"):
                    profiling.count("stress")

    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
        profiling.disable()
    assert not any(t.is_alive() for t in threads)
    recs = profiling.spans()
    profiling.reset()
    assert profiling.counters()["stress"] == n_threads * reps
    assert len(recs) == n_threads * (reps + 1)
    for r in recs:
        if r.name == "inner":
            p = recs[r.parent]
            assert p.name == "outer" and p.tid == r.tid
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns


@pytest.mark.parametrize("names", [("a",), ("a", "b"), ()])
def test_counters_add_up_and_reset(names):
    profiling.reset_counters()
    for _ in range(3):
        profiling.count("a")
    profiling.count("b", 5)
    profiling.count("a", 2)
    assert {k: v for k, v in profiling.counters().items() if k in ("a", "b")} == {"a": 5, "b": 5}
    profiling.reset_counters(*names)
    got = profiling.counters()
    for k, v in (("a", 5), ("b", 5)):
        assert got[k] == (0 if not names or k in names else v)


def test_the_plain_kernels_count_no_launch():
    """The wrappers count a launch of their CUDA kernel only: the plain
    versions that CPU tensors run count none."""
    profiling.reset_counters()
    _step_once(False)
    assert not any(v for k, v in profiling.counters().items() if k.startswith("launch."))


def test_time_fn_and_time_fn_chained_time_calls():
    seeds, calls = [0.1, 0.2, 0.3], []

    def fn(s):
        calls.append(float(s))
        time.sleep(0.002)
        return torch.tensor([float(s)])

    t = profiling.time_fn(fn, seeds, reps=4)
    assert t >= 0.002 and calls == [0.3, 0.1, 0.2, 0.1, 0.2]
    calls.clear()
    t = profiling.time_fn_chained(fn, reps=3, seed0=1.0)
    assert t >= 0.002 and len(calls) == 4
    # Each seed depends on the previous output and differs from the last.
    assert len(set(calls)) == 4 and all(abs(c - 1.0) < 1e-6 for c in calls)


class _HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the host clock."""

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_time_fn_device_takes_the_difference_of_two_runs(monkeypatch):
    """(t(reps) - t(1)) / (reps - 1): a fixed cost of a run cancels."""
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    calls = []

    def fn(seed, x):
        calls.append(seed)
        time.sleep(0.003)

    t = profiling.time_fn_device(fn, (1,), reps=5, warm=True)
    assert len(calls) == 1 + 1 + 5
    assert 0.002 < t < 0.03
    with pytest.raises(AssertionError):
        profiling.time_fn_device(fn, reps=1)
