"""PyTorch port, ``utils/profiling.py`` on the CPU: the trace and its named
spans, the timing harnesses (``time_fn_device`` with CUDA events stood in
by a host clock, to hold its formula), and the FLOP accounting against the
JAX package's."""

import json
import time

import pytest
import torch

from gaussian_splatting_tpu.utils import profiling as j_prof
from gaussian_splatting_tpu_torch.utils import profiling


def test_trace_exports_a_chrome_trace_with_the_annotated_span(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("gs_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert "gs_span" in names
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "gs_span" for e in events)


def test_time_fn_and_time_fn_chained_time_calls():
    seeds, calls = [0.1, 0.2, 0.3], []

    def fn(s):
        calls.append(float(s))
        time.sleep(0.002)
        return torch.tensor([float(s)])

    t = profiling.time_fn(fn, seeds, reps=4)
    assert t >= 0.002 and calls == [0.3, 0.1, 0.2, 0.1, 0.2]
    calls.clear()
    t = profiling.time_fn_chained(fn, reps=3, seed0=1.0)
    assert t >= 0.002 and len(calls) == 4
    # Each seed depends on the previous output and differs from the last.
    assert len(set(calls)) == 4 and all(abs(c - 1.0) < 1e-6 for c in calls)


class _HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the host clock."""

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_time_fn_device_takes_the_difference_of_two_runs(monkeypatch):
    """(t(reps) - t(1)) / (reps - 1): a fixed cost of a run cancels."""
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    calls = []

    def fn(seed, x):
        calls.append(seed)
        time.sleep(0.003)

    t = profiling.time_fn_device(fn, (1,), reps=5, warm=True)
    assert len(calls) == 1 + 1 + 5
    assert 0.002 < t < 0.03
    with pytest.raises(AssertionError):
        profiling.time_fn_device(fn, reps=1)


@pytest.mark.parametrize("args", [(1000, 2_073_600), (3_779_267, 2_073_600, 64)])
def test_flops_accounting_matches_jax(args):
    assert profiling.flops_accounting(*args) == j_prof.flops_accounting(*args)
