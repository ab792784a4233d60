#!/usr/bin/env python3
"""The control of the surfel cell's comparisons, and its planted faults,
read through the surfel reference put in the program's place.

    python3 portbench/control_surfel.py --seeds 1 2 3

For each seed: the reference's first steps computed in bfloat16 (the
control: the nearest precision below the configuration's float32), and in
float32 with the distortion term left out, with the normal term left out
and with the screen filter left out (the faults), each held against the
float32 reference by the cell's own numbers (``traffic/trainer_surfel.py``)
and its limits, and judged by the harness's own verdict
(``harness.Outcome.correct``). ``densify_slots_differ`` reads the slots in
which the reference's densify of the checkpoint's state differs from the
same computed from parameters rounded to the variant's precision: none for
the faults, which change no densify. One JSON line a seed, with ``correct``
for each; each should read false. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.reference import surfel as RS  # noqa: E402
from portbench.reference import train as RT  # noqa: E402

CELL = "train-2dgs-1080p-1m"
VARIANTS = {
    "control_bf16": {"dtype": torch.bfloat16},
    "fault_no_distortion": {"faults": {"drop_dist": True}},
    "fault_no_normal": {"faults": {"drop_normal": True}},
    "fault_no_filter": {"faults": {"no_filter": True}},
}


def densify_slots_differ(inp, rcfg: dict, dev, dtype) -> int:
    """``control.densify_control`` with the surfel reference's densify, the
    parameters rounded to ``dtype``: the slots that differ from float32."""
    accum = torch.zeros((inp.capacity, 3), device=dev)
    n = int(inp.init["alive"].sum())
    g = torch.Generator(device=dev).manual_seed(inp.it0)
    accum[:n] = 100 * inp.tcfg.densify_grads_threshold * torch.rand((n, 3), generator=g,
                                                                    device=dev)
    count = torch.full((inp.capacity, 1), 100.0, device=dev)
    alive = torch.as_tensor(inp.init["alive"], device=dev)
    outs = []
    for dt in (torch.float32, dtype):
        p = {k: torch.as_tensor(inp.init[k], device=dev).to(dt).float() for k in RT.PARAM_KEYS}
        z = {k: torch.zeros_like(v) for k, v in p.items()}
        outs.append(RS.densify(p, z, dict(z), alive, accum, count, rcfg, inp.extent,
                               RT.split_normals(inp.capacity, inp.tcfg.val_seed, dev)))
    a, b = outs
    differ = a["alive"] != b["alive"]
    for k in RT.PARAM_KEYS:
        differ |= (a["params"][k] != b["params"][k]).reshape(inp.capacity, -1).any(1)
    return int(differ.sum())


def readings(cell: str, seed: int, dev, spec_dir: Path = harness.SPEC_DIR) -> dict:
    wl = harness.load_workload(cell, spec_dir)
    c = harness.load_config(wl["config"], spec_dir)
    tr, lim = wl["traffic"], wl["limits"]
    D = harness.traffic_driver(wl["driver"], spec_dir)
    inp = D.make_inputs(c, tr, seed, dev)
    n = int(tr["reference_steps"])
    want = D.reference_run(inp, c, n, dev)
    out = {}
    for name, kw in VARIANTS.items():
        got = D.reference_run(inp, c, n, dev, **kw)
        gaps = D.T.step_gaps(got, want)
        gaps["densify_slots_differ"] = densify_slots_differ(
            inp, want["rcfg"], dev, kw.get("dtype", torch.float32))
        gaps["surfel_map_gap"] = D.map_gap(got["maps"], want["maps"])
        verdict = harness.Outcome(attempted=n, failed=0, end_to_end={}, peak_bytes=0,
                                  checks={k: [float(v), float(lim[k])] for k, v in gaps.items()})
        assert set(verdict.checks) == set(lim), sorted(verdict.checks)
        out[name] = {**gaps, "correct": verdict.correct}
        del got
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default=CELL)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    harness.prepare_env()
    if not torch.cuda.is_available():
        print("portbench: the control runs on a CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(args.workload, seed, dev)}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
