"""Tiny copies of the cells for the benchmark's CPU tests: the real drivers,
readers and reference on a scene and image small enough for the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench import harness

TINY_SIZE = {"width": 64, "height": 48, "gaussians": 1500, "views": 6}


def tiny_config(name: str) -> dict:
    c = harness.load_config(name)
    c.update(TINY_SIZE)
    c["cameras"]["focal_px"] = 1.2 * TINY_SIZE["width"]
    c["training"]["batch_size"] = min(c["training"].get("batch_size", 4), 2)
    # Each group's gradient RMS at this size (the reference's first step).
    c["state"]["nu_rms"] = {"means": 9e-4, "quats": 3e-4, "log_scales": 1e-3,
                            "logit_opacities": 4e-4, "features_dc": 7e-4,
                            "features_rest": 7e-4}
    return c


def spec_dir(tmp: Path) -> Path:
    """A spec folder under ``tmp`` with the real drivers and readers and tiny
    configurations; the cells keep their names."""
    d = tmp / "spec"
    (d / "configs").mkdir(parents=True)
    (d / "workloads").mkdir()
    for sub in ("traffic", "metrics"):
        shutil.copytree(harness.SPEC_DIR / sub, d / sub)
    bench = harness.load_benchmark()
    for c in bench["configs"]:
        json.dump(tiny_config(c["name"]), open(d / "configs" / f"{c['name']}.json", "w"))
    for w in bench["workloads"]:
        wl = harness.load_workload(w["name"])
        if wl["driver"] == "viewer":
            wl["traffic"].update(warmup_frames=2, max_frames=4000, sample_every=3,
                                 max_checked=3, trace_frames=5)
        else:
            wl["traffic"].update(trace_steps=3)
        json.dump(wl, open(d / "workloads" / f"{w['name']}.json", "w"))
    return d
