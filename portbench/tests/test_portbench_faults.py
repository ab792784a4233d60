"""A whole run of each cell at a tiny size on the CPU, past the harness's
look for a card: sound, it comes out correct; with the timed path broken
underneath, it does not. And the control, the reference in bfloat16 put in
the program's place, fails one of each cell's numbers."""

import pytest
import torch

from portbench import control, harness
from portbench.reference.train import PARAM_KEYS
from portbench.run import run_cell

BENCH = harness.load_benchmark()
CASES = [("train-video1080p-1m", None, True),
         ("train-video1080p-1m", "state_unchanged", False),
         ("train-video1080p-1m", "half_batch", False),
         ("train-mipnerf360-3m-b1", None, True),
         ("train-mipnerf360-3m-b1", "state_unchanged", False),
         ("render-video1080p-1m", None, True),
         ("render-video1080p-1m", "frame_altered", False)]


def _state_tensors(state):
    g, opt = state.gauss, state.opt
    return ([getattr(g.params, k) for k in PARAM_KEYS] + [getattr(opt.mu, k) for k in PARAM_KEYS]
            + [getattr(opt.nu, k) for k in PARAM_KEYS] + [opt.step])


def _broken_step(step, fault):
    """``step`` with a fault underneath: it hands back the state it was given
    unchanged, or it drops the second half of each batch, so the loss is the
    mean over the rest."""

    def broken(state, batch):
        if fault == "half_batch":
            h = max(1, batch.images.shape[0] // 2)
            batch = type(batch)(images=batch.images[:h], viewmats=batch.viewmats[:h],
                                Ks=batch.Ks[:h], view_idx=batch.view_idx[:h])
            return step(state, batch)
        keep = [t.clone() for t in _state_tensors(state)]
        state, metrics = step(state, batch)
        for t, k in zip(_state_tensors(state), keep):
            t.copy_(k)
        return state, metrics

    return broken


def plant(monkeypatch, fault):
    """Break the program underneath the timed path: the trainer's step, or
    the frames ``render_single`` hands back (a corner brightened)."""
    from gaussian_splatting_tpu_torch.ops.facade import GaussianRasterizer
    from gaussian_splatting_tpu_torch.training.trainer import GaussianTrainer

    if fault in ("state_unchanged", "half_batch"):
        make = GaussianTrainer._make_step
        monkeypatch.setattr(GaussianTrainer, "_make_step",
                            lambda self, *a: _broken_step(make(self, *a), fault))
    elif fault == "frame_altered":
        render = GaussianRasterizer.render_single

        def altered(self, *a, **k):
            out = render(self, *a, **k)
            img = out.render.clone()
            img[: img.shape[0] // 8, : img.shape[1] // 8] += 0.05
            return out._replace(render=img)

        monkeypatch.setattr(GaussianRasterizer, "render_single", altered)


@pytest.mark.parametrize("cell,fault,correct", CASES)
def test_a_run_is_correct_only_when_sound(tiny_spec, monkeypatch, cell, fault, correct):
    plant(monkeypatch, fault)
    out, metrics, dev, _ = run_cell(BENCH, cell, 2**33 + 5, 1.0, False, torch.device("cpu"),
                                    spec_dir=tiny_spec)
    assert out.correct is correct, out.checks
    assert out.attempted > 0 and set(metrics) == {
        m["name"] for m in harness.metrics_of(BENCH, "end_to_end", cell)}


def test_a_traced_run_reports_its_layers(tiny_spec):
    out, metrics, dev, breakdown = run_cell(BENCH, "render-video1080p-1m", 3, 1.0, True,
                                            torch.device("cpu"), spec_dir=tiny_spec)
    assert out.correct and "window_s" in dev and set(breakdown) == {"device_ops", "idle_gaps"}
    assert "render_mfu" in metrics


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_control_fails_a_number(tiny_spec, cell):
    limits = harness.load_workload(cell, tiny_spec)["limits"]
    readings = control.readings(cell, 11, torch.device("cpu"), tiny_spec)
    for name, numbers in readings.items():
        assert any(v > limits[k] for k, v in numbers.items()), (name, numbers)


@pytest.mark.chip
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_on_the_card(cuda_device, cell):
    out, metrics, dev, _ = run_cell(BENCH, cell, 2**35 + 1, 5.0, False, cuda_device)
    assert out.correct, out.checks
