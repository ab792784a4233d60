#!/usr/bin/env python3
"""The control of the deformable cell's ``deform_rel_err``: whole runs of
the cell with TF32 on for the program's matrix products (the deformation
MLP's GEMMs), the reference kept in float32 (``reference/deform.py`` turns
TF32 off around its own). The cell states float32; TF32 is the nearest
precision below it that the MLP's GEMMs take. Each run should read
``correct`` false by ``deform_rel_err``.

    python3 portbench/control_deform.py --workload train-deform3dgs-1080p-1m-b1 --seeds 1 2 3

One result line a seed, as ``run.py`` prints it, with ``control`` set.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402
from portbench.run import run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="train-deform3dgs-1080p-1m-b1")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    harness.prepare_env()
    import torch

    if not torch.cuda.is_available():
        print("portbench: the control runs on a CUDA device", file=sys.stderr)
        return 3
    bench = harness.load_benchmark()
    for seed in args.seeds:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            out, metrics, dev, _ = run_cell(bench, args.workload, seed, args.seconds, False,
                                            torch.device("cuda", 0))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        line = json.loads(harness.result_line(out, metrics, dev, None))
        print(json.dumps({"control": "tf32", "seed": seed, **line}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
