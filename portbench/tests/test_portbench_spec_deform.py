"""The deformable cell, its configuration and the three readers of the
deformation MLP, found by name; the 2x2 mesh cell's files, which no entry
of ``BENCHMARK.json`` names yet; the MLP's operation counts."""

import pytest

from portbench import harness, work_deform

BENCH = harness.load_benchmark()
NEW_CELLS = {"train-deform3dgs-1080p-1m-b1": 1}
NEW_METRICS = ("deform_mlp_ms.train", "deform_mlp_roofline.train", "deform_train_mfu")


@pytest.mark.parametrize("cell,chips", sorted(NEW_CELLS.items()))
def test_new_cells_load(cell, chips):
    entry = harness.find(BENCH["workloads"], cell, "cell")
    wl = harness.load_workload(cell)
    assert entry["chips"] == chips
    assert wl["config"] == entry["config"] and wl["driver"] == entry["traffic"]
    assert wl["why"] == entry["why"] and len(entry["why"]) <= 200
    assert callable(harness.traffic_driver(wl["driver"]).run)
    assert wl["traffic"]["resume_iteration"] == 6080
    for m in ("train_iter_ms",):
        assert cell in harness.find(BENCH["end_to_end"], m, "metric")["workloads"]
    for m in ("device_idle_share.train", "step_device_ops.train"):
        assert cell in harness.find(BENCH["per_layer"], m, "metric")["workloads"]
    assert cell not in harness.find(BENCH["per_layer"], "train_mfu", "metric")["workloads"]
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


def test_mesh_cell_files_load():
    wl = harness.load_workload("train-video1080p-1m-mesh2x2")
    assert wl["config"] == "video1080p-1m" and wl["driver"] == "trainer_mesh"
    assert (wl["traffic"]["mesh_data"], wl["traffic"]["mesh_tile"]) == (2, 2)
    assert callable(harness.traffic_driver(wl["driver"]).run)
    assert wl["limits"] == harness.load_workload("train-video1080p-1m")["limits"]
    assert not any(w["name"] == "train-video1080p-1m-mesh2x2" for w in BENCH["workloads"])


def test_deform_config_keeps_the_published_widths():
    entry = harness.find(BENCH["configs"], "deform3dgs-video1080p-1m", "configuration")
    cfg = harness.load_config(entry["name"])
    assert cfg["deform"] == {"depth": 8, "width": 256, "skip": 4, "multires_x": 10,
                             "multires_t": 10}
    base = harness.load_config("video1080p-1m")
    for k in ("width", "height", "gaussians", "sh_degree", "scene", "cameras"):
        assert cfg[k] == base[k], k
    assert cfg["reduced"] == entry["reduced"] == ["views"]
    t = cfg["training"]
    assert t["batch_size"] == 1 and t["deform"] and t["deform_warmup"] == 3000 < 6080
    assert cfg["deform_schedule"] == {"lr_scale": 5.0, "lr_max_steps": 40000,
                                      "time_noise": 0.1, "time_noise_steps": 20000}


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_readers_load(name):
    m = harness.find(BENCH["per_layer"], name, "metric")
    assert m["workloads"] == ["train-deform3dgs-1080p-1m-b1"] and m["moves"] == "train_iter_ms"
    reader = harness.metric_reader(name)
    assert reader.read({"kind": "none"}) is None
    assert reader.read({"kind": "train"}) is None


def test_mlp_counts():
    spec = {"depth": 8, "width": 256, "skip": 4, "multires_x": 10, "multires_t": 10}
    assert work_deform.in_channels(spec) == 84
    assert work_deform.macs_per_row(spec) == 504_320
    assert work_deform.mlp_train_flops(spec, 1) == 2 * 504_320 * 2 + 2 * 482_816
    assert abs(work_deform.mlp_train_flops(spec, 1e6) / 1e12 - 2.98) < 0.01
