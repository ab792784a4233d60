#!/usr/bin/env python3
"""Run one cell of the benchmark of ``gaussian_splatting_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell asks
for: build the inputs from the seed, warm up, measure for ``--seconds``,
check what the timed path produced against the plain reference, and print
one JSON line last (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics, from a profiled stretch of the
window). Exits non-zero, with no result, without the cards, when JAX or the
JAX package is loaded after the window, or when the program is missing.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device,
             spec_dir: Path = harness.SPEC_DIR, t_start=None):
    """Run ``cell`` once on ``device``; returns (outcome, metrics, device
    description, breakdown) or raises."""
    entry = harness.find(bench["workloads"], cell, "cell")
    wl = harness.load_workload(cell, spec_dir)
    cfg = harness.load_config(entry["config"], spec_dir)
    driver = harness.traffic_driver(wl["driver"], spec_dir)
    with tempfile.TemporaryDirectory(prefix="portbench-") as out_dir:
        ctx = harness.Ctx(cell=cell, workload=wl, config=cfg, seed=seed, seconds=seconds,
                          trace=trace, device=device, out_dir=out_dir,
                          t_start=harness.process_start() if t_start is None else t_start)
        outcome = driver.run(ctx)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in harness.metrics_of(bench, section, cell):
        if trace:
            value = harness.metric_reader(m["name"], spec_dir).read(outcome.layer)
            if value is None:
                continue
        else:
            value = outcome.end_to_end[m["name"]]
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _device_kind(device), "count": int(entry["chips"]),
           "memory_peak_bytes": outcome.peak_bytes}
    breakdown = None
    if trace:
        t = outcome.layer["trace"]
        dev.update(busy_s=t.busy_s, window_s=t.window_s)
        breakdown = {"device_ops": t.top_ops(), "idle_gaps": t.top_gaps()}
    if device.type == "cuda":
        dev["power_limit_w"] = harness.power_limit_w()
    return outcome, metrics, dev, breakdown


def _device_kind(device) -> str:
    if device.type == "cuda":
        import torch

        return torch.cuda.get_device_name(device)
    return device.type


def main(argv=None) -> int:
    args = parse(argv)
    harness.prepare_env()
    bench = harness.load_benchmark()
    entry = harness.find(bench["workloads"], args.workload, "cell")
    import torch

    torch.set_num_threads(4)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"portbench: the cell needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    outcome, metrics, dev, breakdown = run_cell(
        bench, args.workload, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0))
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 4
    for line in harness.check_lines(outcome):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(outcome, metrics, dev, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
