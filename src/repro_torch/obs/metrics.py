"""Counter/gauge/histogram registry with Prometheus-style exposition.

The metric surface of the serving stack: :class:`~repro.serving.metrics.
ServingCounters` is a view over one of these registries, the
``compile_plan`` call counter lives in the process-default registry,
and :meth:`PlanServer.stats` reports latency percentiles straight from
the phase histograms registered here.

Everything is thread-safe in the strongest sense the tests assert on:
N threads doing M increments each land exactly N*M — one lock per
metric, taken for the handful of arithmetic ops an update is.
Histograms are bucketed (geometric bounds, microseconds to minutes by
default), so memory is constant per metric regardless of sample count;
percentiles are estimated by linear interpolation inside the bucket the
rank falls into (exact min/max are tracked, so p0/p100 are exact).

Stdlib-only by design — :mod:`repro.core` imports this module.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "DEFAULT_BUCKETS"]

#: geometric latency bounds (seconds): 1 us .. ~67 s, factor 2 — 27
#: buckets cover every phase the serve path times, at <=2x resolution
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    1e-6 * 2 ** i for i in range(27))

Labels = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> Labels:
    return tuple(sorted((k, str(v)) for k, v in (labels or {}).items()))


def _label_str(labels: Labels) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


class Counter:
    """Monotonic sum (ints stay ints; floats accumulate seconds)."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def add(self, v=1) -> None:
        with self._lock:
            self._value += v

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with count/sum/min/max and percentiles."""

    __slots__ = ("_lock", "bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, bounds: Iterable[float] = DEFAULT_BUCKETS) -> None:
        self._lock = threading.Lock()
        self.bounds = tuple(sorted(bounds))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        # counts[i] counts samples <= bounds[i]; counts[-1] the overflow
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, v: float) -> None:
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    # -----------------------------------------------------------------
    def percentile(self, q: float) -> float:
        """Estimated q-th percentile (q in [0, 100]).

        Linear interpolation inside the bucket containing the rank;
        clamped to the observed min/max so a one-sample histogram
        reports that sample, not a bucket bound.  NaN when empty.
        """
        with self._lock:
            if self.count == 0:
                return math.nan
            rank = q / 100.0 * self.count
            cum = 0
            for i, c in enumerate(self.counts):
                if c == 0:
                    continue
                lo_b = self.bounds[i - 1] if i > 0 else 0.0
                hi_b = self.bounds[i] if i < len(self.bounds) else self.max
                if cum + c >= rank:
                    frac = (rank - cum) / c
                    v = lo_b + frac * (hi_b - lo_b)
                    return min(max(v, self.min), self.max)
                cum += c
            return self.max

    def quantiles(self) -> Dict[str, float]:
        return {"p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            count, total = self.count, self.sum
            mn = self.min if count else math.nan
            mx = self.max if count else math.nan
        d = {"count": count, "sum": total, "min": mn, "max": mx}
        d.update(self.quantiles())
        return d


class MetricsRegistry:
    """Get-or-create metric store, keyed by (name, sorted labels).

    One registry per :class:`~repro.serving.server.PlanServer` (so
    per-server counters stay independent, as the acceptance tests
    assert) plus the process-wide :func:`default_registry` for global
    facts like the compile count.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str, Labels], object] = {}

    def _get(self, kind: str, name: str,
             labels: Optional[Dict[str, str]], factory):
        key = (kind, name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = factory()
                self._metrics[key] = m
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str,
                  buckets: Iterable[float] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(buckets))

    def find_histogram(self, name: str, **labels) -> Optional[Histogram]:
        """Histogram lookup WITHOUT creation (None if never recorded).

        Readers that merely *consult* a histogram — e.g. the scheduler
        estimating batch latency from observed samples — must not leave
        empty metrics behind in the exposition, so they look up through
        here instead of the get-or-create :meth:`histogram`.
        """
        key = ("histogram", name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
        return m  # type: ignore[return-value]

    # -----------------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Flat name(+labels) -> value/summary dict."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, object] = {}
        for (kind, name, labels), m in items:
            key = name + _label_str(labels)
            if kind == "histogram":
                out[key] = m.snapshot()
            else:
                out[key] = m.value
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition (histograms as summaries)."""
        with self._lock:
            items = sorted(self._metrics.items(), key=lambda kv: kv[0])
        lines: List[str] = []
        seen_type = set()
        for (kind, name, labels), m in items:
            ptype = {"counter": "counter", "gauge": "gauge",
                     "histogram": "summary"}[kind]
            if name not in seen_type:
                lines.append(f"# TYPE {name} {ptype}")
                seen_type.add(name)
            ls = _label_str(labels)
            if kind == "histogram":
                for q in (50, 95, 99):
                    ql = dict(labels)
                    ql["quantile"] = f"0.{q}"
                    lines.append(f"{name}{_label_str(_label_key(ql))} "
                                 f"{m.percentile(q)}")
                lines.append(f"{name}_sum{ls} {m.sum}")
                lines.append(f"{name}_count{ls} {m.count}")
            else:
                lines.append(f"{name}{ls} {m.value}")
        return "\n".join(lines) + "\n"


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry (process-scoped facts only)."""
    return _DEFAULT
