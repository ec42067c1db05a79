"""Host-step spans of the port's serving path, on the shared tracer.

:func:`span` opens ``get_tracer().span(name, **attrs)``: the same sink,
the same JSONL schema, the same trace, span and parent ids.  While a
``torch.profiler`` records on this thread (the profiler records the
thread that started it), it also opens a profiler range of the span's
name around it, so each span sits in the profiler's trace too, on the
profiler's own clock.

With tracing off it returns one shared no-op context after a single
read of ``enabled``: no clock is read and no attribute computed (a
caller that formats an attribute does so only for a span that is not
``NULL_SPAN``).

The profiler range is a ``RecordFunction`` of the function scope
(``torch._C._profiler._RecordFunctionFast``), not the user scope of
``torch.profiler.record_function``: for a user-scope range that
encloses launches, the profiler may also write a device-side annotation
event spanning them (seen on an H100 under PyTorch 2.11), and a reader
that merges the device's activity would count the idle gaps inside it
as busy.  Both it and the profiler's ``enabled`` flag are private names
of ``torch``: where a release lacks either, spans open no range
(``tests/test_torch_trace.py`` holds the names to the installed torch).

Stdlib-only at import: :mod:`repro_torch.core.plan` imports this
module, so it imports nothing of ``core`` or ``serving``, and reaches
``torch`` only where the profiler is checked.
"""
from __future__ import annotations

import sys
from typing import Any, Dict

from .trace import NULL_SPAN, Tracer, get_tracer

__all__ = ["span", "tracing"]


class _Off:
    """The context every span site gets while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return NULL_SPAN

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def tracing() -> bool:
    """Whether spans are being recorded."""
    return get_tracer().enabled


def span(name: str, **attrs):
    """A span of the tracer and a profiler range of its name (module
    docstring); a shared no-op context while tracing is off."""
    tracer = get_tracer()
    if not tracer.enabled:
        return _OFF
    return _Step(tracer, name, attrs)


def _profiler_range(name: str):
    """An open profiler range of ``name``, or None when no profiler
    records (or ``torch`` was never imported, or lacks the names)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    enabled = getattr(torch._C._autograd, "_profiler_enabled", None)
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if enabled is None or fast is None or not enabled():
        return None
    rng = fast(name)
    rng.__enter__()
    return rng


class _Step:
    """One span while tracing is on."""

    __slots__ = ("_cm", "_name", "_range")

    def __init__(self, tracer: Tracer, name: str, attrs: Dict[str, Any]):
        self._cm = tracer.span(name, **attrs)
        self._name = name

    def __enter__(self):
        sp = self._cm.__enter__()
        self._range = _profiler_range(self._name)
        return sp

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
        return self._cm.__exit__(*exc)
