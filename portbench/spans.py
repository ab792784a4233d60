"""The program's own spans (``gaussian_splatting_tpu_torch.utils.profiling``)
joined to a traced stretch's device activities on the profiler's clock.

The spans are stamped with ``time.perf_counter_ns()``, the profiler's events
with its own clock, and neither is assumed to agree with the other, in
offset or in rate. Two anchors map one onto the other: a span
``bench.anchor`` around a ``torch.cuda.synchronize()`` right after the
profiler starts and another right before it stops. Each anchor's
``cudaDeviceSynchronize`` runtime event must lie inside its span, which
bounds the offset at that moment to an interval. Where the two intervals
overlap, one offset fits both and the map is the overlap's midpoint, its
residual half the overlap's width, the most a mapped time may stand from
the truth; where they do not, the clocks drifted and the map is the line
that fits both with the least drift (``clock_map``).

Each device activity is then put down to the innermost span that contains
the host start of the runtime call that launched it (matched by CUPTI's
correlation id) on the launching thread, or, where no span of that thread
contains it, the innermost span open on the main thread (the one that
calls ``backward()``) at that moment. Where the trace's thread id of a
runtime call names no thread that opened a span, the call goes to the
deepest span open on any thread: while the autograd engine's thread runs
the backward, the main thread waits inside ``step.backward``, so the
deepest span is the engine's where it has one and ``step.backward``
otherwise. Each idle stretch of the device,
between the union of the activities and including the stretch's two ends,
is put down to the innermost span open on the main thread at its midpoint.

A span's place is its path of names from the root, ``train.step/
step.backward/render.raster_bwd``; the per-layer readers sum device and
idle seconds over the paths that hold their span's name.

Nothing here is imported by a run unless a driver asks for it; against a
program without spans it finds nothing and the readers report nothing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from portbench import harness
from portbench.trace import Stretch, symbol

ANCHOR = "bench.anchor"
SYNC = "cudaDeviceSynchronize"
# Host time kept free of other synchronizes around each anchor.
ANCHOR_GAP_S = 0.002
NONE = ""                # no span
UNMATCHED = "<no launch>"  # a device activity whose launch the trace lacks


@dataclasses.dataclass
class Attribution:
    """Device and idle seconds of a stretch by the path of the span they
    were put down to."""

    window_s: float
    device_s: Dict[str, float]
    idle_s: Dict[str, float]
    residual_us: float
    activities: int
    symbols: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)

    def device_under(self, *names: str) -> float:
        """Device seconds whose innermost span or one of its ancestors is
        named one of ``names``."""
        return sum(v for p, v in self.device_s.items() if _holds(p, names))

    def idle_under(self, *names: str) -> float:
        return sum(v for p, v in self.idle_s.items() if _holds(p, names))

    def coverage(self, selfless: Sequence[str]) -> Optional[float]:
        """Percent of the device time whose innermost span is a stage span:
        not one of ``selfless`` itself, not outside every span and not
        without a launch."""
        total = sum(self.device_s.values())
        if total <= 0:
            return None
        left = sum(v for p, v in self.device_s.items()
                   if p in (NONE, UNMATCHED) or p.rsplit("/", 1)[-1] in selfless)
        return 100.0 * (total - left) / total


def _holds(path: str, names: Sequence[str]) -> bool:
    return any(n in names for n in path.split("/"))


def paths(spans) -> List[str]:
    """Each span record's path of names from its root."""
    out: List[str] = []
    for r in spans:
        out.append(r.name if r.parent < 0 else out[r.parent] + "/" + r.name)
    return out


@dataclasses.dataclass
class ClockMap:
    """Profiler time = t + offset + rate * (t - t0), for a span time t in
    ns; ``drift_us`` is the offset's change from the first anchor to the
    last (0 where one offset fits both), ``residual_us`` the most a mapped
    time may stand from the truth at the anchors."""

    t0: float
    offset: float
    rate: float
    drift_us: float = 0.0
    residual_us: float = 0.0

    def __call__(self, t: float) -> float:
        return t + self.offset + self.rate * (t - self.t0)


def clock_map(anchors: Sequence[Tuple[int, int]],
              syncs: Sequence[Tuple[int, int]]) -> Optional[ClockMap]:
    """The map from the anchor spans (start, end), in time order, and the
    stretch's synchronize events (start, end); None where no pair of events
    fits the first and the last anchor. The profiler synchronizes on its
    own too, so the events are not matched by order: the first and the last
    anchor take the pair of events, the first before the second, whose
    offset intervals overlap most (``SpanStretch`` keeps every other
    synchronize milliseconds away from its anchors, so only their own pair
    overlaps); the map is then the overlap's midpoint and the residual its
    half-width. Where no pair overlaps, the clocks drifted: the map is the
    line between the nearest pair's nearest ends, the least drift that fits
    both. A middle anchor the map leaves outside its interval adds that
    distance to the residual."""
    if len(anchors) < 2 or len(syncs) < 2:
        return None

    def fit(a, e):
        lo, hi = e[1] - a[1], e[0] - a[0]  # offsets that put the event inside the span
        return (lo, hi) if lo <= hi else None

    first = [(j, fit(anchors[0], e)) for j, e in enumerate(syncs)]
    last = [(k, fit(anchors[-1], e)) for k, e in enumerate(syncs)]
    pairs = [(max(p[0], q[0]) - min(p[1], q[1]), p, q) for j, p in first if p
             for k, q in last if q and k > j]
    if not pairs:
        return None
    gap, p, q = min(pairs, key=lambda x: x[0])
    c1, c2 = (0.5 * (a[0] + a[1]) for a in (anchors[0], anchors[-1]))
    if gap <= 0:                           # one offset fits both
        lo, hi = max(p[0], q[0]), min(p[1], q[1])
        clock = ClockMap(t0=c1, offset=0.5 * (lo + hi), rate=0.0,
                         residual_us=0.5 * (hi - lo) / 1e3)
    else:
        o1, o2 = (p[1], q[0]) if p[1] < q[0] else (p[0], q[1])
        clock = ClockMap(t0=c1, offset=o1, rate=(o2 - o1) / (c2 - c1) if c2 > c1 else 0.0,
                         drift_us=(o2 - o1) / 1e3)
    worst = 0.0
    for a in anchors[1:-1]:
        o = clock(0.5 * (a[0] + a[1])) - 0.5 * (a[0] + a[1])
        fits = [iv for iv in (fit(a, e) for e in syncs) if iv]
        if fits:
            worst = max(worst, min(max(iv[0] - o, o - iv[1], 0.0) for iv in fits))
    clock.residual_us += worst / 1e3
    return clock


def _innermost(intervals, depth, queries):
    """For each query time, the index of the deepest interval (start, end)
    that contains it, or -1; ``depth`` breaks ties by nesting."""
    out = np.full(len(queries), -1, dtype=np.int64)
    if not len(intervals) or not len(queries):
        return out
    ev = [(s, 0, i) for i, (s, _) in enumerate(intervals)]
    ev += [(e, 2, i) for i, (_, e) in enumerate(intervals)]
    ev += [(t, 1, -1 - q) for q, t in enumerate(queries)]
    ev.sort()
    open_: Dict[int, None] = {}
    for _, kind, i in ev:
        if kind == 0:
            open_[i] = None
        elif kind == 2:
            open_.pop(i, None)
        elif open_:
            out[-1 - i] = max(open_, key=lambda j: (depth[j], intervals[j][0]))
    return out


def attribute(spans, activities, launches, clock, main_tid: int,
              start_ns: float, end_ns: float, residual_us: float = 0.0) -> Attribution:
    """Device and idle seconds of a stretch by span path.

    ``spans``: the program's span records (perf_counter ns; an open span's
    end is -1); ``activities``: (start, end, correlation, name) of each
    device activity and ``launches``: (start, thread id, correlation) of
    each runtime call, on the profiler's clock in ns; ``clock`` maps a span
    time onto that clock (``ClockMap``); ``start_ns``/``end_ns``: the
    stretch's ends on the spans' clock. ``symbols`` keeps each path's device
    seconds by kernel symbol."""
    path = paths(spans)
    depth = [p.count("/") for p in path]
    spans_t: Dict[int, List[int]] = {}
    for i, r in enumerate(spans):
        spans_t.setdefault(r.tid, []).append(i)
    t_lo, t_hi = clock(start_ns), clock(end_ns)

    def iv(i):
        r = spans[i]
        return (clock(r.start_ns), clock(r.end_ns if r.end_ns >= 0 else end_ns))

    def lookup(tid, times):
        ids = spans_t.get(tid, []) if tid is not None else range(len(spans))
        hit = _innermost([iv(i) for i in ids], [depth[i] for i in ids], times)
        return [ids[h] if h >= 0 else -1 for h in hit]

    launch = {}
    for t, tid, c in launches:
        if c not in launch or t < launch[c][0]:
            launch[c] = (t, tid)
    acts = sorted((max(s, t_lo), min(e, t_hi), c, n) for s, e, c, n in activities
                  if e > t_lo and s < t_hi)
    device_s: Dict[str, float] = {}
    symbols: Dict[str, Dict[str, float]] = {}

    def add(p, k):
        d = (acts[k][1] - acts[k][0]) / 1e9
        device_s[p] = device_s.get(p, 0.0) + d
        per = symbols.setdefault(p, {})
        sym = symbol(acts[k][3])
        per[sym] = per.get(sym, 0.0) + d

    by_tid: Dict[Optional[int], List[int]] = {}
    for k, (_, _, c, _) in enumerate(acts):
        if c in launch:
            tid = launch[c][1]
            by_tid.setdefault(tid if tid in spans_t else None, []).append(k)
        else:
            add(UNMATCHED, k)
    owner = {}
    for tid, ks in by_tid.items():
        times = [launch[acts[k][2]][0] for k in ks]
        for k, t, i in zip(ks, times, lookup(tid, times)):
            owner[k] = (i, t)
    orphans = [k for k, (i, _) in owner.items() if i < 0]
    for k, i in zip(orphans, lookup(main_tid, [owner[k][1] for k in orphans])):
        owner[k] = (i, owner[k][1])
    for k, (i, _) in owner.items():
        add(path[i] if i >= 0 else NONE, k)

    gaps, cur = [], t_lo
    for s, e, _, _ in acts:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t_hi > cur:
        gaps.append((cur, t_hi))
    idle_s: Dict[str, float] = {}
    for (a, b), i in zip(gaps, lookup(main_tid, [0.5 * (a + b) for a, b in gaps])):
        p = path[i] if i >= 0 else NONE
        idle_s[p] = idle_s.get(p, 0.0) + (b - a) / 1e9
    return Attribution(window_s=(end_ns - start_ns) / 1e9, device_s=device_s, idle_s=idle_s,
                       residual_us=residual_us, activities=len(acts), symbols=symbols)


def collect(prof) -> Tuple[List[tuple], List[tuple], List[tuple]]:
    """(device activities (start, end, correlation, name), runtime calls
    (start, thread id, correlation), synchronize events (start, end)) of a
    ``torch.profiler`` run, in ns on its clock. A runtime call's thread is
    CUPTI's (the event's resource id), which may not be the system's."""
    from torch.autograd import DeviceType

    acts, calls, syncs = [], [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            acts.append((s, s + e.duration_ns(), e.correlation_id(), e.name()))
        elif e.name().startswith("cu"):
            calls.append((s, e.device_resource_id(), e.correlation_id()))
            if e.name() == SYNC:
                syncs.append((s, s + e.duration_ns()))
    return acts, calls, sorted(syncs)


def window_span_s(spans, t_open_ns: int, t_close_ns: int) -> Dict[str, float]:
    """Host seconds of each root span name inside [t_open, t_close]."""
    out: Dict[str, float] = {}
    for r in spans:
        if r.parent < 0 and r.end_ns >= 0:
            d = min(r.end_ns, t_close_ns) - max(r.start_ns, t_open_ns)
            if d > 0:
                out[r.name] = out.get(r.name, 0.0) + d / 1e9
    return out


def _spin(seconds: float) -> None:
    """Wait on the host without sleeping: a thread woken from a sleep takes
    ~0.1 ms more to get through the anchor that follows, which widens it."""
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


def _profiling():
    """The program's span recorder, or None where the program has none."""
    try:
        from gaussian_splatting_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") and hasattr(profiling, "enable") else None


class SpanStretch(Stretch):
    """A ``Stretch`` that records the program's spans over it, between two
    anchors, and puts its device and idle time down to them
    (``attribution``). The stretch's window runs from after the first
    anchor to before the last, so the anchors and the quiet host time
    around them are not in it. Spans already on stay on, with what they
    recorded (a span open when the stretch starts keeps its children);
    spans it turned on it turns off. Against a program without spans it is
    the plain ``Stretch`` and ``attribution`` gives None."""

    def __init__(self, device):
        super().__init__(device)
        self.device = device
        self.prog = _profiling()
        self.main_tid = None
        self.spans = []
        self.clock = None

    def _anchor(self):
        _spin(ANCHOR_GAP_S)
        with self.prog.annotate(ANCHOR):
            harness.sync(self.device)
        _spin(ANCHOR_GAP_S)

    def start(self):
        if self.prog is not None:
            import threading

            self.main_tid = threading.get_native_id()
            self.was_on = self.prog.enabled()
            if not self.was_on:
                self.prog.enable()
        super().start()
        if self.prog is not None:
            # The first CUDA call after the profiler starts is slow; an
            # anchor around it would bound the offset loosely.
            harness.sync(self.device)
            self._anchor()
            self._t = time.perf_counter()

    def stop(self, units: int):
        if self.prog is not None:
            t_end = time.perf_counter()
            self._anchor()
        super().stop(units)
        if self.prog is not None:
            self.wall_s = t_end - self._t
            self.spans = self.prog.spans()
            if not self.was_on:
                self.prog.disable()

    def attribution(self) -> Optional[Attribution]:
        if self.prog is None or self.wall_s is None:
            return None
        anchors = [(r.start_ns, r.end_ns) for r in self.spans if r.name == ANCHOR]
        acts, calls, syncs = collect(self.prof)
        t0 = int(self._t * 1e9)
        syncs = [e for e in syncs if e[0] >= 0]
        self.clock = clock_map(anchors, syncs)
        if self.clock is None:
            return None
        return attribute(self.spans, acts, calls, self.clock, self.main_tid, t0,
                         t0 + int(self.wall_s * 1e9), residual_us=self.clock.residual_us)


def per_unit_ms(layer: dict, names: Iterable[str], per_view: bool) -> Optional[float]:
    """Device ms under the spans ``names`` per view (``per_view``) or per
    step or frame of the traced stretch; None without an attribution."""
    a = layer.get("span_stretch")
    t = layer.get("trace")
    if a is None or t is None or not t.units:
        return None
    n = t.units * (layer["views_per_unit"] if per_view else 1)
    return 1e3 * a.device_under(*names) / n


def idle_share(layer: dict, name: str) -> Optional[float]:
    """Percent of the stretch the device is idle while the main thread is
    inside the span ``name``."""
    a = layer.get("span_stretch")
    if a is None or a.window_s <= 0:
        return None
    return 100.0 * a.idle_under(name) / a.window_s
