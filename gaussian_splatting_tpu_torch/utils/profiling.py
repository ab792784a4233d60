"""Profiling helpers (counterpart of ``gaussian_splatting_tpu/utils/
profiling.py``): named spans and counters inside the program, ``torch.profiler``
trace capture, and timing harnesses.

Spans. ``annotate(name)`` marks a layer boundary. It is off by default: a
span then costs one flag test and hands back a shared no-op context manager
(no clock read, no allocation, no NVTX range, no profiler event, never a
device synchronize). ``enable()`` turns spans on: each span stamps
``time.perf_counter_ns()`` at entry and exit into a preallocated, bounded
buffer with its name, its thread's native id and its parent's index (a full
buffer counts the spans it drops and does not grow), and pushes an NVTX
range of the same name on a CUDA machine, so an Nsight timeline shows the
same names. Only inside ``trace`` does a span also open a
``torch.profiler.record_function``; outside it a span adds no event to a
profiler's trace. ``spans()`` reads the records, ``reset()`` clears them.

A span opened on a thread with no span open, such as the autograd engine's
device thread during ``backward()``, takes as parent the innermost span open
on the thread that waits for it (the most recently opened span still open on
another thread). ``grad_span(name)`` times a region's backward: identity
autograd nodes on the region's outputs and on its first input open the span
when the engine reaches the outputs' marker and close it at the input's.

Counters (``count``) are plain integers and always on; the kernel wrappers
count their launches there (``launch.<kernel>``).

The JAX package's timing harnesses guard against a remote execution layer
that overlaps and memoizes identical calls. A local CUDA device does
neither, so here they simply time synchronized calls; their signatures stay
the JAX package's.
"""

from __future__ import annotations

import contextlib
import threading
import time
from array import array
from typing import Callable, Dict, List, NamedTuple, Sequence

import torch

_ON = False        # spans are recorded
_IN_TRACE = False  # inside ``trace``: spans also open a record_function
_NULL = contextlib.nullcontext()
_COUNTS: Dict[str, int] = {}
_COUNTS_LOCK = threading.Lock()


class SpanRecord(NamedTuple):
    name: str
    start_ns: int   # time.perf_counter_ns() at entry
    end_ns: int     # at exit; -1 while the span is open
    tid: int        # threading.get_native_id() of the thread that opened it
    parent: int     # index of the parent record; -1 for none


class _Recorder:
    """The bounded span buffer and each thread's stack of open spans."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.names: List[str] = [""] * capacity
        self.start = array("q", bytes(8 * capacity))
        self.end = array("q", bytes(8 * capacity))
        self.tid = array("q", bytes(8 * capacity))
        self.parent = array("q", bytes(8 * capacity))
        self.n = 0
        self.dropped = 0
        self.stacks: Dict[int, List[int]] = {}
        self.lock = threading.Lock()

    def open(self, name: str, tid: int) -> int:
        with self.lock:
            stack = self.stacks.setdefault(tid, [])
            if stack:
                parent = stack[-1]
            else:
                # Innermost span of the waiting thread: the most recent
                # span still open on another thread.
                parent = max((s[-1] for t, s in self.stacks.items() if t != tid and s),
                             default=-1)
            i = self.n
            if i < self.capacity:
                self.names[i], self.tid[i], self.parent[i], self.end[i] = name, tid, parent, -1
                self.n = i + 1
            else:
                self.dropped += 1
                i = -1
            stack.append(i)
        if i >= 0:
            self.start[i] = time.perf_counter_ns()
        return i

    def close(self, i: int, tid: int) -> None:
        t = time.perf_counter_ns()
        with self.lock:
            stack = self.stacks.get(tid)
            if stack:
                # The innermost span, except where a backward region closes
                # on another order than it opened.
                if stack[-1] == i:
                    stack.pop()
                elif i in stack:
                    stack.remove(i)
            if i >= 0:
                self.end[i] = t

    def records(self) -> List[SpanRecord]:
        return [SpanRecord(self.names[i], self.start[i], self.end[i], self.tid[i],
                           self.parent[i]) for i in range(self.n)]


_REC = _Recorder(1 << 16)
_NVTX = None
_LOCAL = threading.local()


def _native_id() -> int:
    """This thread's native id, read once a thread (the call is a system
    call)."""
    try:
        return _LOCAL.tid
    except AttributeError:
        _LOCAL.tid = threading.get_native_id()
        return _LOCAL.tid


def enable(capacity: int = 1 << 16) -> None:
    """Record spans from now on, into a buffer of ``capacity`` records
    (made anew, and the records cleared, when the capacity changes)."""
    global _ON, _REC, _NVTX
    if capacity != _REC.capacity:
        _REC = _Recorder(capacity)
    _NVTX = torch.cuda.nvtx if torch.cuda.is_available() else None
    _ON = True


def disable() -> None:
    """Stop recording spans; the records stay until ``reset``."""
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def reset() -> None:
    """Clear the records, the drop count and the open spans' stacks."""
    global _REC
    _REC = _Recorder(_REC.capacity)


def spans() -> List[SpanRecord]:
    """The recorded spans, in the order they opened."""
    return _REC.records()


def dropped() -> int:
    """Spans not recorded because the buffer was full."""
    return _REC.dropped


class _Span:
    __slots__ = ("name", "idx", "tid", "rec", "nvtx", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rec, self.nvtx = _REC, _NVTX
        self.tid = _native_id()
        self.idx = self.rec.open(self.name, self.tid)
        if self.nvtx is not None:
            self._nvtx_open()
        self.rf = None
        if _IN_TRACE:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.nvtx is not None:
            self._nvtx_close()
        self.rec.close(self.idx, self.tid)
        return False

    def _nvtx_open(self):
        self.nvtx.range_push(self.name)

    def _nvtx_close(self):
        self.nvtx.range_pop()


def annotate(name: str):
    """A named span around a block (``with profiling.annotate("render.binning"):``):
    a no-op unless spans are enabled."""
    if not _ON:
        return _NULL
    return _Span(name)


class _NoMark:
    """``grad_span``'s marker when spans are off: tensors pass untouched."""

    @staticmethod
    def input(tensor):
        return tensor

    @staticmethod
    def outputs(*tensors):
        return tensors[0] if len(tensors) == 1 else tensors


_NO_MARK = _NoMark()


class _GradSpan:
    """The span of one region's backward, opened at the outputs' marker and
    closed at the input's marker (see ``grad_span``)."""

    def __init__(self, name: str):
        self.name = name
        self.armed = False
        self.span = None

    def input(self, tensor):
        if torch.is_grad_enabled() and tensor.requires_grad:
            self.armed = True
            return _CloseAtInput.apply(self, tensor)[0]
        return tensor

    def outputs(self, *tensors):
        out = list(tensors)
        idx = [i for i, t in enumerate(tensors) if torch.is_tensor(t) and t.requires_grad]
        if self.armed and idx and torch.is_grad_enabled():
            for i, t in zip(idx, _OpenAtOutputs.apply(self, *(tensors[i] for i in idx))):
                out[i] = t
        return out[0] if len(out) == 1 else tuple(out)

    def open(self):
        if _ON and self.span is None:
            self.span = _GradRange(self.name).__enter__()

    def close(self):
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None


class _GradRange(_Span):
    """A span opened and closed by autograd nodes: an NVTX start/end range,
    which may end on another thread than it started on."""

    __slots__ = ("handle",)

    def _nvtx_open(self):
        self.handle = self.nvtx.range_start(self.name)

    def _nvtx_close(self):
        self.nvtx.range_end(self.handle)


class _OpenAtOutputs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, span, *tensors):
        ctx.span = span
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        ctx.span.open()
        return (None, *grads)


class _CloseAtInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, span, tensor):
        ctx.span = span
        ctx.set_materialize_grads(False)
        return (tensor.view_as(tensor),)

    @staticmethod
    def backward(ctx, grad):
        ctx.span.close()
        return None, grad


def grad_span(name: str):
    """A span over a region's backward (``mark = grad_span("step.loss.bwd")``).
    Pass through ``mark.input(x)`` the input the region's first operation
    reads, and that the region reads once; pass the region's outputs through
    ``mark.outputs(...)``, which returns them (one tensor for one). With
    spans on and grad enabled, identity autograd nodes go on that input and
    on the outputs that require grad: the engine reaches the outputs' node
    first and opens the span there, and reaches the input's node, which has
    the lowest sequence number of the region, last and closes it. Gradients
    pass through unchanged and are summed in the order they were: an input
    read more than once would have its uses summed at the marker instead.
    With spans off the tensors come back untouched and the graph gains no
    node."""
    if not _ON:
        return _NO_MARK
    return _GradSpan(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on; the autograd engine's
    thread launches kernels too)."""
    with _COUNTS_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    return dict(_COUNTS)


def reset_counters(*names: str) -> None:
    """Set the named counters (every counter when none is named) to 0."""
    with _COUNTS_LOCK:
        for k in names or list(_COUNTS):
            _COUNTS[k] = 0


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the CPU and (when present)
    CUDA activity inside the block, exported as a Chrome trace
    (``<log_dir>/trace.json``, for Perfetto or chrome://tracing). Spans are
    on inside the block, each also a ``record_function`` of its name.
    Yields the profiler."""
    import os

    from torch.profiler import ProfilerActivity, profile

    global _IN_TRACE
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = _ON
    enable(_REC.capacity)
    _IN_TRACE = True
    try:
        with profile(activities=activities) as prof:
            try:
                yield prof
            finally:
                _sync()
    finally:
        _IN_TRACE = False
        if not was_on:
            disable()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
