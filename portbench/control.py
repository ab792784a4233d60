#!/usr/bin/env python3
"""The controls of the cells' comparisons, and the faults read through the
reference put in the program's place.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3

Trainer cells: the reference's first steps computed in bfloat16 (the
control: the nearest precision below the configuration's float32) and,
where a batch holds more than one view, with half of each batch left out
and the mean taken over the rest (a fault), each held against the float32
reference by the cell's own numbers. Viewer cells: the frames a run checks,
rendered by the reference in bfloat16, against its float32 frames. One JSON
line a seed; the benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench import scene as S  # noqa: E402
from portbench.reference import render as R  # noqa: E402


def trainer_readings(c: dict, tr: dict, seed: int, dev, drivers) -> dict:
    T = drivers
    inp = T.make_inputs(c, tr, seed, dev)
    n = int(tr["reference_steps"])
    want = T.reference_run(inp, c, n, dev)
    out = {"control_bf16": T.step_gaps(T.reference_run(inp, c, n, dev, torch.bfloat16), want)}
    if inp.tcfg.batch_size > 1:
        out["fault_half_batch"] = T.step_gaps(
            T.reference_run(inp, c, n, dev, drop_half=True), want)
    out["control_bf16"]["densify_slots_differ"] = densify_control(inp, want["rcfg"], dev)
    return out


def densify_control(inp, rcfg: dict, dev) -> int:
    """Slots that differ between the reference's densify of the checkpoint's
    state in float32 and the same computed from parameters rounded to
    bfloat16."""
    from portbench.reference import train as RT

    accum = torch.zeros((inp.capacity, 3), device=dev)
    n = int(inp.init["alive"].sum())
    g = torch.Generator(device=dev).manual_seed(inp.it0)
    accum[:n] = 100 * inp.tcfg.densify_grads_threshold * torch.rand((n, 3), generator=g,
                                                                    device=dev)
    count = torch.full((inp.capacity, 1), 100.0, device=dev)
    alive = torch.as_tensor(inp.init["alive"], device=dev)
    outs = []
    for dtype in (torch.float32, torch.bfloat16):
        p = {k: torch.as_tensor(inp.init[k], device=dev).to(dtype).float()
             for k in RT.PARAM_KEYS}
        z = {k: torch.zeros_like(v) for k, v in p.items()}
        outs.append(RT.densify(p, z, dict(z), alive, accum, count, rcfg, inp.extent,
                               RT.split_normals(inp.capacity, inp.tcfg.val_seed, dev)))
    a, b = outs
    differ = a["alive"] != b["alive"]
    for k in RT.PARAM_KEYS:
        differ |= (a["params"][k] != b["params"][k]).reshape(inp.capacity, -1).any(1)
    return int(differ.sum())



def checked_frames(tr: dict, seed: int):
    """The path indices of the frames a viewer run checks (if it gets that
    far)."""
    every = int(tr["sample_every"])
    offset = int(S.numpy_rng(seed, 6).integers(0, every))
    return [int(tr["warmup_frames"]) + offset + k * every for k in range(int(tr["max_checked"]))]


def viewer_readings(c: dict, tr: dict, seed: int, dev) -> dict:
    W, H, deg = c["width"], c["height"], c["sh_degree"]
    scene = S.true_scene(c["gaussians"], c["scene"], seed, dev)
    sh = torch.cat([scene["features_dc"], scene["features_rest"]], dim=1)
    frames = checked_frames(tr, seed)
    path = S.path_views(frames[-1] + 1, c["cameras"])
    K = R.intrinsics(W, H, c["cameras"]["focal_px"])
    errs = []
    for i in frames:
        args = (scene["means"], scene["quats"], scene["log_scales"], scene["logit_opacities"],
                sh, torch.as_tensor(path[i]), K, W, H, deg)
        want = R.render(*args)[0]
        got = R.render(*args, dtype=torch.bfloat16)[0]
        errs.append(float((got - want).abs().max()))
    return {"control_bf16": {"frame_max_abs_err": max(errs)}}


def readings(cell: str, seed: int, dev, spec_dir: Path = harness.SPEC_DIR) -> dict:
    wl = harness.load_workload(cell, spec_dir)
    c = harness.load_config(wl["config"], spec_dir)
    if wl["driver"] == "trainer":
        return trainer_readings(c, wl["traffic"], seed, dev,
                                harness.traffic_driver("trainer", spec_dir))
    return viewer_readings(c, wl["traffic"], seed, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
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
