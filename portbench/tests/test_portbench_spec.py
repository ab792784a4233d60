"""The benchmark's files, found by name, and the contract's rules on
names, units, bounds and the result line."""

import json
import re

import pytest

from portbench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
LAYER_METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits: 2 + 14 x cells runs of run_seconds + 60 s,
    # 2 x 90 s a cell to compile, 1200 s spare, within 43200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    entry = harness.find(BENCH["workloads"], cell, "cell")
    wl = harness.load_workload(cell)
    assert wl["config"] == entry["config"] and wl["driver"] == entry["traffic"]
    assert wl["why"] == entry["why"] and len(entry["why"]) <= 200
    assert callable(harness.traffic_driver(wl["driver"]).run)
    cfg = harness.load_config(entry["config"])
    assert entry["chips"] == 1
    assert set(wl["limits"]) and all(isinstance(v, (int, float)) for v in wl["limits"].values())
    assert cfg["width"] > 0 and cfg["gaussians"] > 0


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_found_by_name(entry):
    cfg = harness.load_config(entry["name"])
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    assert cfg["source"] == entry["source"] and len(entry["source"]) <= 200
    assert cfg["reduced"] == entry["reduced"]
    assert all(k in cfg for k in entry["reduced"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", LAYER_METRICS)
def test_metric_reader_found_by_name(name):
    reader = harness.metric_reader(name)
    assert callable(reader.read)
    assert reader.read({"kind": "none"}) is None


def test_names_units_and_bounds():
    names = [x["name"] for s in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[s]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for cell in CELLS:
        reported = [m for m in harness.metrics_of(BENCH, "end_to_end", cell)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert harness.metrics_of(BENCH, "per_layer", cell)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_result_line_keys_order_and_checks_last():
    out = harness.Outcome(attempted=3, failed=0, end_to_end={}, peak_bytes=7,
                          checks={"loss_rel_gap": [1e-6, 1e-4], "cache_hits": [0.0, 0.0]})
    line = harness.result_line(out, {"setup_s": {"value": 1.5, "unit": "s"}},
                               {"platform": "gpu", "kind": "x", "count": 1,
                                "memory_peak_bytes": 7}, None)
    rec = json.loads(line)
    assert list(rec) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert rec["correct"] is True
    assert rec["checks"]["loss_rel_gap"] == {"value": 1e-6, "limit": 1e-4}
    bad = harness.Outcome(attempted=3, failed=0, end_to_end={}, peak_bytes=7,
                          checks={"x": [float("nan"), 1.0]})
    assert bad.correct is False
    assert harness.check_lines(out)[0].startswith("check loss_rel_gap: ")
