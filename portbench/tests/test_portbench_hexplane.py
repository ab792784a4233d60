"""The 4D Gaussian Splatting cell: its configuration, cell and five readers
found by name, the work counts, and whole runs at a tiny size on the CPU
past the harness's look for a card. Sound, a run comes out correct, and a
traced one reads every new metric; with the means detached from the
field's coordinates, the offsets added after the activations or the
regularizers dropped under the timed path it does not, and neither does
the bfloat16 control (``control_hexplane.py``, the reference in bfloat16
in the program's place) nor the same three faults read through the
reference. The parent's program, which has no field switch, fails at
once."""

import pytest
import torch

from portbench import harness, work_hexplane
from portbench.run import run_cell

BENCH = harness.load_benchmark()
CELL = "train-4dgs-1080p-1m-b4"
NEW_METRICS = ("hexplane_ms.train", "hexplane_fwd_roofline.train",
               "hexplane_bwd_roofline.train", "hexplane_mlp_ms.train", "hexplane_train_mfu")
SEED = 2**33 + 13


def test_cell_and_configuration_load():
    entry = harness.find(BENCH["workloads"], CELL, "cell")
    wl = harness.load_workload(CELL)
    assert entry["chips"] == 1 and entry["config"] == wl["config"] == "4dgs-video1080p-1m"
    assert wl["driver"] == entry["traffic"] == "trainer_hexplane"
    assert wl["why"] == entry["why"] and len(entry["why"]) <= 200
    tr = wl["traffic"]
    assert tr["resume_iteration"] == 6080 and tr["warmup_steps"] == 20
    assert set(wl["limits"]) == {"loss_rel_gap", "grad_norm_gap", "change_norm_gap",
                                 "densify_slots_differ", "deform_rel_err", "means_grad_gap"}
    for sec, m in (("end_to_end", "train_iter_ms"), ("per_layer", "trainer_event_share.train"),
                   ("per_layer", "step_device_ops.train"),
                   ("per_layer", "device_idle_share.train")):
        assert CELL in harness.find(BENCH[sec], m, "metric")["workloads"]
    for m in ("train_mfu", "raster_fwd_roofline.train", "raster_bwd_roofline.train",
              "deform_mlp_ms.train", "deform_mlp_roofline.train", "deform_train_mfu"):
        assert CELL not in harness.find(BENCH["per_layer"], m, "metric")["workloads"]
    cfg = harness.load_config(entry["config"])
    base = harness.load_config("video1080p-1m")
    for k in ("width", "height", "gaussians", "sh_degree", "views", "cameras", "noise"):
        assert cfg[k] == base[k], k
    assert cfg["reduced"] == ["views"]
    h = cfg["hexplane"]
    assert (h["channels"], h["resolution"], h["multires"], h["net_width"],
            h["defor_depth"]) == (16, [64, 64, 64, 150], [1, 2], 64, 0)
    t = cfg["training"]
    assert t["deform"] and t["deform_field"] == "hexplane" and t["batch_size"] == 4
    assert t["deform_warmup"] == 3000 and t["lambda_dssim"] == 0.0
    for k in ("widths", "regularizers", "learning_rates", "init", "box", "time", "motion",
              "hexplane_state", "iterations", "densify_statistic"):
        assert k in cfg["assumed"], k
    names = [n for n, _ in __import__("portbench.reference.hexplane",
                                      fromlist=["shapes"]).shapes(h)]
    assert sorted(cfg["hexplane_state"]["nu_rms"]) == sorted(names) and len(names) == 26


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_readers_load(name):
    m = harness.find(BENCH["per_layer"], name, "metric")
    assert m["workloads"] == [CELL] and m["moves"] == "train_iter_ms"
    reader = harness.metric_reader(name)
    assert reader.read({"kind": "none"}) is None
    assert reader.read({"kind": "train"}) is None


def test_work_counts():
    spec = harness.load_config("4dgs-video1080p-1m")["hexplane"]
    assert work_hexplane.plane_floats(spec) == 2_365_440
    assert work_hexplane.decoder_macs(spec) == 14_976
    ops, nbytes = work_hexplane.field_fwd(spec, 1e6, 1)
    assert ops == 12 * (16 + 16 * 8) * 1e6 and nbytes == 140e6 + 4 * 2_365_440
    ops, nbytes = work_hexplane.field_bwd(spec, 1e6, 1)
    assert ops == 12 * (16 + 16 * 22) * 1e6 and nbytes == 152e6 + 8 * 2_365_440


def _fault(monkeypatch, fault):
    from gaussian_splatting_tpu_torch.models import hexplane
    from gaussian_splatting_tpu_torch.training import step

    if fault == "means_detached":
        offsets = hexplane.offsets

        def detached(params, box, means, rows, t):
            out = offsets(params, box, means.detach(), rows, t)
            return out
        monkeypatch.setattr(hexplane, "offsets", detached)
    elif fault == "after_activations":
        def after(means, quats, log_scales, offs):
            dx, dr, ds = offs
            q = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
            return means + dx, q + dr, torch.log(torch.abs(torch.exp(log_scales) + ds))
        monkeypatch.setattr(step.hexplane_model, "deformed", after)
    elif fault == "no_regularizers":
        monkeypatch.setattr(step.hexplane_model, "regularizer",
                            lambda params: torch.zeros((), device=params["grids.0.0"].device))


@pytest.mark.parametrize("fault,correct", [(None, True), ("means_detached", False),
                                           ("after_activations", False),
                                           ("no_regularizers", False)])
def test_a_run_is_correct_only_when_sound(tiny_spec, monkeypatch, fault, correct):
    _fault(monkeypatch, fault)
    out, metrics, dev, _ = run_cell(BENCH, CELL, SEED, 1.0, False, torch.device("cpu"),
                                    spec_dir=tiny_spec)
    assert out.correct is correct, out.checks
    assert out.attempted > 0 and set(metrics) == {
        m["name"] for m in harness.metrics_of(BENCH, "end_to_end", CELL)}


def test_a_traced_run_reports_its_layers(tiny_spec):
    out, metrics, dev, breakdown = run_cell(BENCH, CELL, 5, 1.0, True, torch.device("cpu"),
                                            spec_dir=tiny_spec)
    assert out.correct, out.checks
    assert out.layer["hexplane"]["rows_per_view"] > 0
    # The span and kernel readers need a card's trace; the host-clock share
    # reads here.
    assert "hexplane_train_mfu" in metrics and metrics["hexplane_train_mfu"]["value"] > 0


def test_the_control_and_the_faults_read_incorrect(tiny_spec):
    from portbench import control_hexplane

    r = control_hexplane.readings(CELL, SEED, torch.device("cpu"), spec_dir=tiny_spec)
    assert set(r) == set(control_hexplane.VARIANTS)
    for name, gaps in r.items():
        assert gaps["correct"] is False, (name, gaps)


def test_a_program_without_the_field_fails_at_once(tiny_spec, monkeypatch):
    """The parent's configuration class has no ``deform_field``: the run
    raises before any work."""
    import dataclasses

    from gaussian_splatting_tpu_torch.training import config

    fields = {f.name: (f.type, f) for f in dataclasses.fields(config.TrainingConfig)
              if f.name != "deform_field"}
    old = dataclasses.make_dataclass("TrainingConfig", [(n, t, f) for n, (t, f) in
                                                        fields.items()])
    monkeypatch.setattr(config, "TrainingConfig", old)
    with pytest.raises(TypeError, match="deform_field"):
        run_cell(BENCH, CELL, SEED, 1.0, False, torch.device("cpu"), spec_dir=tiny_spec)
