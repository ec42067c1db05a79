"""Observability for the port: tracing, metrics, and cost-drift detection.

* :mod:`repro_torch.obs.trace` and :mod:`repro_torch.obs.metrics` —
  verbatim copies of the reference's stdlib-only modules;
  ``repro_torch.core`` imports them (the PBQP solver's span,
  ``compile_plan``'s counter);
* :mod:`repro_torch.obs.spans` — the serving path's host-step spans on
  that tracer, each also a profiler range of its name while
  ``torch.profiler`` records (docs/observability.md, "The port's
  spans");
* :mod:`repro_torch.obs.drift` — instrumented per-node execution of
  compiled plans, predicted-vs-observed EWMA drift scores, and targeted
  recalibration of the flagged calibration entries.

``drift`` imports back into core and serving, so it is loaded lazily
here (module ``__getattr__``), as in the reference — importing
:mod:`repro_torch.obs` from inside core never recurses.
"""
from __future__ import annotations

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry)
from .spans import span, tracing
from .trace import Span, Tracer, configure, get_tracer

__all__ = [
    "Span", "Tracer", "get_tracer", "configure",
    "span", "tracing",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry",
    "drift", "InstrumentedNet", "DriftDetector", "plan_predictions",
]

#: names resolved from the lazily-imported drift module
_DRIFT_NAMES = ("InstrumentedNet", "DriftDetector", "DriftEntry",
                "plan_predictions")


def __getattr__(name):
    if name == "drift" or name in _DRIFT_NAMES:
        import importlib
        drift = importlib.import_module(".drift", __name__)
        if name == "drift":
            return drift
        return getattr(drift, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
