"""Profiling helpers (counterpart of ``gaussian_splatting_tpu/utils/
profiling.py``): ``torch.profiler`` trace capture, named spans that show in
both the profiler's trace and NVTX, and timing harnesses.

The JAX package's timing harnesses guard against a remote execution layer
that overlaps and memoizes identical calls. A local CUDA device does
neither, so here they simply time synchronized calls; their signatures stay
the JAX package's.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Sequence


def _sync():
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the CPU and (when present)
    CUDA activity inside the block, exported as a Chrome trace
    (``<log_dir>/trace.json``, for Perfetto or chrome://tracing). Yields
    the profiler."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named span: ``torch.profiler.record_function`` inside an NVTX range
    on CUDA (the reference's NVTX ranges)."""
    import torch

    with contextlib.ExitStack() as stack:
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        stack.enter_context(torch.profiler.record_function(name))
        yield


def time_fn(fn: Callable, seeds: Sequence, reps: int = 5) -> float:
    """Seconds a call of ``fn(seed)``, the seeds taken in turn, over ``reps``
    synchronized calls after one warm-up call."""
    fn(seeds[-1])
    _sync()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(seeds[i % max(len(seeds) - 1, 1)])
    _sync()
    return (time.perf_counter() - t0) / reps


def time_fn_device(fn: Callable, args: Sequence = (), reps: int = 10,
                   warm: bool = True) -> float:
    """Seconds a call of ``fn(seed, *args)`` (``seed`` a float), timed with
    CUDA events: ``(t(reps) - t(1)) / (reps - 1)``, the JAX harness's
    formula, which cancels the one-off cost of a run. ``warm`` makes one
    call first. Needs CUDA."""
    import torch

    assert reps >= 2

    def once(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            fn(1.0 + 1e-9 * i, *args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    if warm:
        once(1)
    t1 = once(1)
    tr = once(reps)
    return max(tr - t1, 1e-9) / (reps - 1)


def time_fn_chained(fn: Callable, reps: int = 5, seed0: float = None) -> float:
    """Seconds a call of ``fn(seed)``, each call's seed derived from the
    previous call's first output value (read back to the host, which
    synchronizes), after one warm-up call."""
    import torch

    if seed0 is None:
        seed0 = 1.0

    def readback(out):
        leaf = out
        while isinstance(leaf, (tuple, list)):
            leaf = leaf[0]
        if isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        v = float(torch.as_tensor(leaf).reshape(-1)[0]) if torch.is_tensor(leaf) else float(leaf)
        return v if v == v and abs(v) != float("inf") else 0.0

    v = readback(fn(seed0))
    s = seed0 + 1e-9 + 1e-30 * v
    t0 = time.perf_counter()
    for i in range(reps):
        v = readback(fn(s))
        s = seed0 + 1e-9 * (i + 2) + 1e-30 * v
    return (time.perf_counter() - t0) / reps


def flops_accounting(n_isect: int, n_pixels: int, tile_pixels: int = 256) -> dict:
    """Roofline accounting for one fwd+bwd rasterization (see bench.py):
    VPU pair-ops dominate; returns the op counts used for the
    fraction-of-roofline metric."""
    pairs = n_isect * tile_pixels
    return {
        "pair_ops_fwd": 30 * pairs,
        "pair_ops_bwd": 60 * pairs,
        "hbm_bytes_soa": n_isect * 64,
        "pairs": pairs,
    }
