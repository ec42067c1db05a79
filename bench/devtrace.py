"""The traced run's reduction of a ``torch.profiler`` window to numbers.

Kept in memory only: nothing is written.  The device's activity (kernels,
copies, sets) is merged into busy intervals; busy time is their union,
so two streams that overlap count once.  The gaps between them are the
device's idle time, each labelled by the innermost span of the
program's tracer that the host was in at the gap's midpoint (``no
span``: the host was outside the server, in a client, the scheduler's
queue or the harness).  The profiler's clock is tied to the host's
``perf_counter`` by a marker recorded at the start.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

#: the label of host time in no span of the program's tracer
NO_SPAN = "no span"


@dataclass
class DeviceWindow:
    """What the profiler saw between ``t0`` and ``t1`` (perf_counter s)."""
    t0: float
    t1: float
    #: merged busy intervals, perf_counter seconds
    busy: List[Tuple[float, float]]
    #: device time by operation name: (launches, seconds)
    ops: Dict[str, Tuple[int, float]]
    #: idle seconds by what the host was in
    idle_by_span: Dict[str, float] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def top_ops(self, k: int = 10) -> List[List]:
        rows = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:k]
        return [[name[:160], s] for name, (_, s) in rows]

    def top_idle(self, k: int = 10) -> List[List]:
        rows = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:k]
        return [[name, s] for name, s in rows]


class Profiler:
    """``start()`` / ``stop()`` around a window of a live run."""

    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._marker_pc = 0.0
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        from torch.profiler import record_function
        self._prof.start()
        with record_function("bench.clock"):
            self._marker_pc = time.perf_counter()
        self.t0 = time.perf_counter()

    def stop(self, spans: Sequence[Dict], t1: float) -> DeviceWindow:
        """End the trace; the window ends at ``t1`` (perf_counter s)."""
        import torch
        torch.cuda.synchronize()
        self.t1 = t1
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        marker = next(e for e in events if e.name() == "bench.clock")
        offset = marker.start_ns() * 1e-9 - self._marker_pc
        raw = []
        ops: Dict[str, List] = defaultdict(lambda: [0, 0.0])
        for e in events:
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            a = e.start_ns() * 1e-9 - offset
            b = a + e.duration_ns() * 1e-9
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            raw.append((a, b))
            op = ops[e.name()]
            op[0] += 1
            op[1] += b - a
        win = DeviceWindow(self.t0, self.t1, merge(raw),
                           {k: (v[0], v[1]) for k, v in ops.items()})
        win.idle_by_span = idle_by_span(win, spans)
        return win


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals, sorted and disjoint."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(win: DeviceWindow) -> List[Tuple[float, float]]:
    """The idle intervals of the window."""
    out, t = [], win.t0
    for a, b in win.busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if win.t1 > t:
        out.append((t, win.t1))
    return out


def idle_by_span(win: DeviceWindow, spans: Sequence[Dict]
                 ) -> Dict[str, float]:
    """Idle seconds by the innermost span open at each gap's midpoint."""
    ivs = sorted((s["t0"], s["t0"] + s["dur_s"], s["name"]) for s in spans)
    starts = [iv[0] for iv in ivs]
    longest = max((b - a for a, b, _ in ivs), default=0.0)
    out: Dict[str, float] = defaultdict(float)
    for a, b in gaps(win):
        mid = 0.5 * (a + b)
        best: Optional[Tuple[float, str]] = None
        # spans that start before the midpoint and may still be open
        lo = bisect.bisect_left(starts, mid - longest)
        hi = bisect.bisect_right(starts, mid)
        for s0, s1, name in ivs[lo:hi]:
            if s1 >= mid and (best is None or s1 - s0 < best[0]):
                best = (s1 - s0, name)
        out[best[1] if best else NO_SPAN] += b - a
    return dict(out)
