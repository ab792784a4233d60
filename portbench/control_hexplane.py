#!/usr/bin/env python3
"""The control of the 4D Gaussian Splatting cell's comparisons, and its
planted faults, read through the reference put in the program's place.

    python3 portbench/control_hexplane.py --seeds 1 2 3

For each seed: the reference's first steps computed in bfloat16 (the
control: the nearest precision below the configuration's float32; the
planes, coordinates and features rounded to bfloat16, the decoder and the
renderer run in it), and in float32 with the means detached from the
field's coordinates, with the offsets added after the activations and with
the regularizers dropped (the faults), each held against the float32
reference by the cell's own numbers (``traffic/trainer_hexplane.py``) and
its limits, and judged by the harness's own verdict
(``harness.Outcome.correct``). ``densify_slots_differ`` reads as in
``control.py``: the slots in which the reference's densify of the
checkpoint's state differs from the same computed from parameters rounded
to the variant's precision (none for the faults). One JSON line a seed,
with ``correct`` for each; each should read false. The benchmark's runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import control  # noqa: E402
from portbench import harness  # noqa: E402

CELL = "train-4dgs-1080p-1m-b4"
VARIANTS = {
    "control_bf16": {"dtype": torch.bfloat16},
    "fault_means_detached": {"faults": {"detach": True}},
    "fault_offsets_after_activations": {"faults": {"after": True}},
    "fault_no_regularizers": {"faults": {"no_reg": True}},
}


def readings(cell: str, seed: int, dev, spec_dir: Path = harness.SPEC_DIR) -> dict:
    wl = harness.load_workload(cell, spec_dir)
    c = harness.load_config(wl["config"], spec_dir)
    tr, lim = wl["traffic"], wl["limits"]
    D = harness.traffic_driver(wl["driver"], spec_dir)
    inp = D.make_inputs(c, tr, seed, dev)
    n = int(tr["reference_steps"])
    want = D.reference_run(inp, c, n, dev)
    keys = list(D.LEAVES) + list(inp.net0)
    alive = inp.init["alive"]
    out = {}
    for name, kw in VARIANTS.items():
        got = D.reference_run(inp, c, n, dev, **kw)
        gaps = D.D.step_gaps(got, want, keys)
        gaps["densify_slots_differ"] = (control.densify_control(inp, want["rcfg"], dev)
                                        if "dtype" in kw else 0)
        gaps["means_grad_gap"] = D.means_grad_gap(got, want)
        gaps["deform_rel_err"] = D.deform_rel_err(
            [[o.cpu().numpy() for o in v] for v in got["offsets"]], want["offsets"], alive)
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
