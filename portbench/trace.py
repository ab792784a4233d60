"""The traced stretch of a window: ``torch.profiler`` over a bounded run of
steps or frames, reduced to device activities, busy and idle time, kernel
time by symbol, and the breakdown the result line carries."""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

@dataclasses.dataclass
class TraceSummary:
    window_s: float                 # the stretch, by the host clock
    units: int                      # steps or frames inside it
    starts: np.ndarray              # device activities, seconds from the stretch start
    ends: np.ndarray
    names: List[str]
    busy_s: float                   # union of the device activities
    gaps: List[tuple]               # (seconds, what the host was doing)

    def seconds_of(self, symbols: Sequence[str]) -> float:
        """Device seconds of the kernels whose symbol is one of ``symbols``."""
        want = set(symbols)
        return float(sum(e - s for s, e, n in zip(self.starts, self.ends, self.names)
                         if symbol(n) in want))

    def top_ops(self, k: int = 10) -> List[list]:
        per: Dict[str, float] = {}
        for s, e, n in zip(self.starts, self.ends, self.names):
            per[display(n)] = per.get(display(n), 0.0) + float(e - s)
        return [[n, v] for n, v in sorted(per.items(), key=lambda kv: -kv[1])[:k]]

    def top_gaps(self, k: int = 10) -> List[list]:
        per: Dict[str, float] = {}
        for dur, what in self.gaps:
            per[what] = per.get(what, 0.0) + dur
        return [[n, v] for n, v in sorted(per.items(), key=lambda kv: -kv[1])[:k]]


def symbol(name: str) -> str:
    """A kernel's symbol: its demangled name without the return type, the
    namespaces, the template arguments and the argument list."""
    s = name[5:] if name.startswith("void ") else name
    s = s.replace("(anonymous namespace)::", "")
    cut = min((i for i in (s.find("<"), s.find("(")) if i >= 0), default=len(s))
    return s[:cut].strip().split("::")[-1]


def display(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[:width]


class Stretch:
    """Start and stop a profiler around a run of steps or frames. It traces
    the CUDA activities and the CUDA runtime calls the host makes (the
    host's Python operators are left out: recording them slows the host
    several times over and would inflate the idle share it measures). The
    caller synchronizes the device at both ends."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        on_card = getattr(device, "type", str(device)) == "cuda"
        self.prof = profile(activities=[ProfilerActivity.CUDA if on_card
                                        else ProfilerActivity.CPU])
        self.units = 0
        self._mark = None
        self.wall_s = None

    def start(self):
        self.prof.start()
        self._t = time.perf_counter()

    def stop(self, units: int):
        self.wall_s = time.perf_counter() - self._t
        self.prof.stop()
        self.units = units

    def summarize(self, out_path: Optional[str] = None) -> TraceSummary:
        """The stretch's length is the host's clock between the two
        synchronized ends; busy time is the union of the device activities;
        the idle gaps between them are named by the CUDA runtime call the
        host was in, and the idle time before the first and after the last
        activity is pooled as "stretch ends"."""
        from torch.autograd import DeviceType

        events = self.prof.events()
        dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                     if e.device_type == DeviceType.CUDA)
        host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                      if e.device_type != DeviceType.CUDA)
        t0 = dev[0][0] if dev else 0.0
        starts = np.array([a for a, _, _ in dev], float)
        ends = np.array([b for _, b, _ in dev], float)
        names = [n for _, _, n in dev]
        busy, gaps, cur = 0.0, [], t0
        for a, b in zip(starts, ends):
            if a > cur:
                gaps.append((cur, a))
            busy += max(0.0, b - max(a, cur))
            cur = max(cur, b)
        named = _name_gaps(gaps, host)
        wall_us = self.wall_s * 1e6
        named.append((max(0.0, wall_us - (cur - t0)), "stretch ends"))
        if out_path:
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            with gzip.open(out_path, "wt") as f:
                json.dump({"wall_us": wall_us, "device": dev, "host": host[:200000],
                           "gaps": named[:2000]}, f)
        return TraceSummary(window_s=self.wall_s, units=self.units,
                            starts=(starts - t0) / 1e6, ends=(ends - t0) / 1e6, names=names,
                            busy_s=min(busy / 1e6, self.wall_s),
                            gaps=[(d / 1e6, w) for d, w in named])


def _name_gaps(gaps, cpu, limit: int = 5000):
    """(length in us, name) of each idle gap, named by the CUDA runtime call
    the host was in at its middle ("host, no CUDA call" where none is); the
    ``limit`` longest gaps are named, the rest pooled as "short gaps"."""
    if not gaps:
        return []
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] - gaps[i][1])
    starts = np.array([c[0] for c in cpu], float)
    out = []
    for rank, i in enumerate(order):
        a, b = gaps[i]
        if rank >= limit:
            out.append((b - a, "short gaps"))
            continue
        mid = 0.5 * (a + b)
        j = int(np.searchsorted(starts, mid, side="right")) - 1
        name, steps = "host, no CUDA call", 0
        while j >= 0 and steps < 200:
            if cpu[j][1] >= mid:
                name = cpu[j][2]
                break
            j -= 1
            steps += 1
        out.append((b - a, name))
    return out
