"""Observability for the port: tracing spans and the metrics registry.

``trace`` and ``metrics`` are verbatim copies of the reference's
stdlib-only modules; ``repro_torch.core`` imports them (the PBQP solver's
span, ``compile_plan``'s counter).
"""
from __future__ import annotations

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry)
from .trace import Span, Tracer, configure, get_tracer

__all__ = [
    "Span", "Tracer", "get_tracer", "configure",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry",
]
