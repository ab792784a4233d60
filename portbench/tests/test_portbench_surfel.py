"""The surfel cell (2D Gaussian Splatting): its configuration, cell and five
readers found by name, the work counts, and whole runs at a tiny size on
the CPU past the harness's look for a card. Sound, a run comes out correct;
with the distortion term, the normal term or the screen filter left out
under the timed path it does not, and neither does the bfloat16 control
(``control_surfel.py``, the reference in bfloat16 in the program's place)
nor the same three faults read through the reference. A NaN in the
program's maps reads as the worst gap."""

import math

import pytest
import torch

from portbench import harness, work_surfel
from portbench.run import run_cell

BENCH = harness.load_benchmark()
CELL = "train-2dgs-1080p-1m"
NEW_METRICS = ("surfel_project_roofline.train", "surfel_raster_fwd_roofline.train",
               "surfel_raster_bwd_roofline.train", "surfel_reg_ms.train", "surfel_train_mfu")


def test_cell_and_configuration_load():
    entry = harness.find(BENCH["workloads"], CELL, "cell")
    wl = harness.load_workload(CELL)
    assert entry["chips"] == 1 and entry["config"] == wl["config"] == "2dgs-video1080p-1m"
    assert wl["driver"] == entry["traffic"] == "trainer_surfel"
    assert wl["why"] == entry["why"] and len(entry["why"]) <= 200
    assert callable(harness.traffic_driver(wl["driver"]).run)
    tr = wl["traffic"]
    assert tr["resume_iteration"] == 7080 and tr["warmup_steps"] == 20
    assert tr["reference_steps"] == 3 and tr["trace_steps"] == 10
    assert set(wl["limits"]) == {"loss_rel_gap", "grad_norm_gap", "change_norm_gap",
                                 "densify_slots_differ", "surfel_map_gap"}
    for m in ("train_iter_ms",):
        assert CELL in harness.find(BENCH["end_to_end"], m, "metric")["workloads"]
    for m in ("trainer_event_share.train", "step_device_ops.train", "device_idle_share.train"):
        assert CELL in harness.find(BENCH["per_layer"], m, "metric")["workloads"]
    for m in ("train_mfu", "raster_fwd_roofline.train", "raster_bwd_roofline.train"):
        assert CELL not in harness.find(BENCH["per_layer"], m, "metric")["workloads"]
    cfg_entry = harness.find(BENCH["configs"], "2dgs-video1080p-1m", "configuration")
    cfg = harness.load_config(cfg_entry["name"])
    base = harness.load_config("video1080p-1m")
    for k in ("width", "height", "gaussians", "sh_degree", "views", "scene", "cameras", "noise"):
        assert cfg[k] == base[k], k
    assert cfg["reduced"] == cfg_entry["reduced"] == ["views"]
    t = cfg["training"]
    assert t["surfels"] and t["batch_size"] == 4 and t["binning"] == "auto"
    assert (t["surfel_lambda_dist"], t["surfel_lambda_normal"], t["surfel_depth_ratio"]) == (
        100.0, 0.05, 0.0)
    for k in ("alpha_clamp", "screen_filter", "start_iterations", "densify_statistic",
              "surfel_orientations"):
        assert k in cfg["assumed"], k


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_readers_load(name):
    m = harness.find(BENCH["per_layer"], name, "metric")
    assert m["workloads"] == [CELL] and m["moves"] == "train_iter_ms"
    reader = harness.metric_reader(name)
    assert reader.read({"kind": "none"}) is None
    assert reader.read({"kind": "train"}) is None


def test_work_counts():
    ops, nbytes = work_surfel.raster_fwd(1e6, 1e7, 2e6, 8e3)
    assert ops == 78e7 and nbytes == 76e6 + 64e3 + 96e6
    ops, nbytes = work_surfel.raster_bwd(1e6, 1e7, 2e6, 8e3)
    assert ops == 182e7 and nbytes == 152e6 + 64e3 + 96e6
    ops, nbytes = work_surfel.projection(1.0, 3)
    assert ops == 3 * (206 + 142) and nbytes == 4 * (58 + 21 + 58 + 16 + 58)
    view = {"pairs": 0.0, "pixels": 0.0}
    assert work_surfel.train_step_flops(view, 1.0, 4, 3) == 4 * 3 * (206 + 142) + 14 * 58


def _fault(monkeypatch, fault):
    from gaussian_splatting_tpu_torch.ops import surfel
    from gaussian_splatting_tpu_torch.training import step

    if fault == "no_distortion":
        monkeypatch.setattr(step, "SURFEL_DIST_FROM", 10 ** 9)
    elif fault == "no_normal":
        monkeypatch.setattr(step, "SURFEL_NORMAL_FROM", 10 ** 9)
    elif fault == "no_filter":
        monkeypatch.setattr(surfel, "FILTER_INV_SQ", float("inf"))


@pytest.mark.parametrize("fault,correct", [(None, True), ("no_distortion", False),
                                           ("no_normal", False), ("no_filter", False)])
def test_a_surfel_run_is_correct_only_when_sound(tiny_spec, monkeypatch, fault, correct):
    _fault(monkeypatch, fault)
    out, metrics, dev, _ = run_cell(BENCH, CELL, 2**33 + 11, 1.0, False, torch.device("cpu"),
                                    spec_dir=tiny_spec)
    assert out.correct is correct, out.checks
    assert out.attempted > 0 and set(metrics) == {
        m["name"] for m in harness.metrics_of(BENCH, "end_to_end", CELL)}


def test_the_control_and_the_faults_read_incorrect(tiny_spec):
    from portbench import control_surfel

    r = control_surfel.readings(CELL, 2**33 + 11, torch.device("cpu"), spec_dir=tiny_spec)
    assert set(r) == set(control_surfel.VARIANTS)
    for name, gaps in r.items():
        assert gaps["correct"] is False, (name, gaps)


@pytest.mark.parametrize("channel,part", [(0, "expected_depth"), (2, "normal"),
                                          (5, "distortion"), (6, "median_share")])
def test_a_nan_in_a_map_is_the_worst_gap(channel, part):
    D = harness.traffic_driver("trainer_surfel")
    g = torch.Generator().manual_seed(7)
    want = torch.rand((6, 8, 7), generator=g) + 0.5
    want[..., 1] = 1.0
    got = want.clone()
    got[2, 3, channel] = float("nan")
    gaps = D.map_gaps([want.clone()], [want])
    assert max(gaps.values()) == 0.0
    gaps = D.map_gaps([got], [want])
    assert gaps[part] == (1 / 48 if part == "median_share" else math.inf), gaps
    if part != "median_share":
        assert D.map_gap([got], [want]) == math.inf


def test_a_nan_in_the_programs_normal_map_is_incorrect(tiny_spec, monkeypatch):
    """The first step's normal map made NaN as the run keeps it: the run
    reads ``surfel_map_gap`` infinite and ``correct`` false."""
    load = harness.traffic_driver

    def traffic_driver(kind, spec_dir=harness.SPEC_DIR):
        mod = load(kind, spec_dir)
        if kind == "trainer_surfel":
            capture = mod.SurfelRecorder.capture

            def nan_capture(self, render_fn):
                inner = capture(self, render_fn)

                def capturing(*a, **k):
                    n = len(self.maps0)
                    out = inner(*a, **k)
                    if len(self.maps0) > n:
                        self.maps0[-1][..., 2] = float("nan")
                    return out

                return capturing

            mod.SurfelRecorder.capture = nan_capture
        return mod

    monkeypatch.setattr(harness, "traffic_driver", traffic_driver)
    out, _, _, _ = run_cell(BENCH, CELL, 2**33 + 11, 1.0, False, torch.device("cpu"),
                            spec_dir=tiny_spec)
    assert out.checks["surfel_map_gap"][0] == math.inf and out.correct is False, out.checks
