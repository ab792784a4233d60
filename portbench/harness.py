"""What every cell shares: the specification files found by name, the
environment a run sets up, the device's description, the import check and
the result line.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``) and its traffic kind, whose driver is
``traffic/<kind>.py``; each per-layer metric is read by
``metrics/<metric>.py``. Adding a cell, a configuration or a metric adds a
file and an entry of ``BENCHMARK.json``, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

SPEC_DIR = Path(__file__).resolve().parent
ROOT = SPEC_DIR.parent
# Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussian_splatting_tpu")


def process_start() -> float:
    """The epoch time at which this process started (Linux ``/proc``), or
    the time the harness was imported where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def prepare_env(root: Path = ROOT) -> None:
    """Kernel and compiler caches at fixed paths inside the checkout; keep
    libraries from loading JAX on their own."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_compute_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def note(ctx_or_start, msg: str) -> None:
    """A progress line on standard error, seconds since the process start."""
    t0 = getattr(ctx_or_start, "t_start", ctx_or_start)
    print(f"portbench: [{time.time() - t0:8.2f} s] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}")


def load_workload(name: str, spec_dir: Path = SPEC_DIR) -> dict:
    return load_json(spec_dir / "workloads" / f"{name}.json")


def load_config(name: str, spec_dir: Path = SPEC_DIR) -> dict:
    return load_json(spec_dir / "configs" / f"{name}.json")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_driver(kind: str, spec_dir: Path = SPEC_DIR):
    return load_module(spec_dir / "traffic" / f"{kind}.py", f"portbench_traffic_{kind}")


def metric_reader(name: str, spec_dir: Path = SPEC_DIR):
    return load_module(spec_dir / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))


def metrics_of(bench: dict, section: str, cell: str) -> List[dict]:
    """The metrics of ``section`` a cell reports: those without a
    ``workloads`` key and those that list the cell."""
    return [m for m in bench[section] if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> List[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


@dataclasses.dataclass
class Ctx:
    """One run of one cell, as a traffic driver receives it."""

    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    out_dir: str
    t_start: float                   # process start, epoch seconds

    @property
    def trace_file(self) -> str:
        """Where a traced run keeps its profiler trace: under the temporary
        directory the run is given, one file a cell and seed."""
        import tempfile

        return os.path.join(tempfile.gettempdir(), "portbench-traces",
                            f"{self.cell}-{self.seed}.json.gz")


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the counts, the end-to-end values by name,
    the numbers compared with their limits, and for a traced run what the
    per-layer readers read (``layer``: the trace summary, the work counts,
    the event times)."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: Dict[str, List[float]]   # name -> [value, limit]
    peak_bytes: int
    layer: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(v == v and v <= lim for v, lim in self.checks.values())


def sync(device) -> None:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def reset_peak(device) -> None:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def result_line(outcome: Outcome, metrics: Dict[str, dict], device: dict,
                breakdown: Optional[dict]) -> str:
    """The last line of standard output; the numbers compared come last."""
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    return json.dumps(line)


def check_lines(outcome: Outcome) -> List[str]:
    return [f"check {k}: {v!r} (limit {lim!r}) {'ok' if v <= lim else 'FAILED'}"
            for k, (v, lim) in outcome.checks.items()]
