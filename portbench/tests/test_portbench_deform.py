"""Whole runs of the deformable cell and of the 2x2 mesh cell at a tiny size
on the CPU, past the harness's look for a card: sound, they come out
correct; with the timed path broken underneath (the MLP's offsets zeroed or
rounded as TF32 rounds, the state left unchanged on rank 0), they do not.
The mesh cell runs its four ranks as four processes over gloo; it is not an
entry of ``BENCHMARK.json`` (its runs spread wider than its bound admits,
PERF.md §7), so the test adds its entry to the benchmark it runs."""

import copy
import json

import pytest
import torch

from portbench import harness
from portbench.run import run_cell
from portbench.tests.test_portbench_faults import plant

BENCH = harness.load_benchmark()
DEFORM = "train-deform3dgs-1080p-1m-b1"
MESH = "train-video1080p-1m-mesh2x2"
MESH_ENTRY = {"name": MESH, "config": "video1080p-1m", "traffic": "trainer_mesh", "chips": 4,
              "why": "the 2x2 mesh cell"}


def _tf32_rounded(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its float32 mantissa cut to TF32's 10 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def plant_offsets(monkeypatch, fault):
    """Break the deformation's offsets under the timed path."""
    from gaussian_splatting_tpu_torch.models import deform

    fn = deform.offsets

    def broken(*a, **k):
        out = fn(*a, **k)
        if fault == "offsets_zeroed":
            return tuple(torch.zeros_like(o) for o in out)
        return tuple(o + (_tf32_rounded(o.detach()) - o.detach()) for o in out)

    monkeypatch.setattr(deform, "offsets", broken)


@pytest.mark.parametrize("fault,correct", [(None, True), ("offsets_zeroed", False),
                                           ("offsets_tf32", False)])
def test_a_deform_run_is_correct_only_when_sound(tiny_spec, monkeypatch, fault, correct):
    if fault:
        plant_offsets(monkeypatch, fault)
    out, metrics, dev, _ = run_cell(BENCH, DEFORM, 2**33 + 7, 1.0, False, torch.device("cpu"),
                                    spec_dir=tiny_spec)
    assert out.correct is correct, out.checks
    assert set(out.checks) == {"loss_rel_gap", "grad_norm_gap", "change_norm_gap",
                               "densify_slots_differ", "deform_rel_err"}
    if fault:
        assert out.checks["deform_rel_err"][0] > out.checks["deform_rel_err"][1]
    assert out.attempted > 0 and set(metrics) == {
        m["name"] for m in harness.metrics_of(BENCH, "end_to_end", DEFORM)}


def test_a_traced_deform_run_reports_its_layers(tiny_spec):
    out, metrics, dev, breakdown = run_cell(BENCH, DEFORM, 5, 1.0, True, torch.device("cpu"),
                                            spec_dir=tiny_spec)
    assert out.correct, out.checks
    assert "deform_train_mfu" in metrics and metrics["deform_train_mfu"]["value"] > 0
    assert out.layer["deform"]["rows_per_view"] > 0


@pytest.mark.parametrize("fault,correct", [(None, True), ("state_unchanged", False)])
def test_a_mesh_run_on_four_processes(tiny_spec, monkeypatch, fault, correct):
    wl = harness.load_workload(MESH)
    wl["traffic"].update(trace_steps=3)
    (tiny_spec / "workloads" / f"{MESH}.json").write_text(json.dumps(wl))
    bench = copy.deepcopy(BENCH)
    bench["workloads"].append(MESH_ENTRY)
    harness.find(bench["end_to_end"], "train_iter_ms", "metric")["workloads"].append(MESH)
    plant(monkeypatch, fault)
    out, metrics, dev, _ = run_cell(bench, MESH, 2**33 + 9, 1.0, False, torch.device("cpu"),
                                    spec_dir=tiny_spec)
    assert out.correct is correct, out.checks
    assert out.attempted > 0 and "train_iter_ms" in metrics and "peak_mem_gib" in metrics
