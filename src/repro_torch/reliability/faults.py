"""Deterministic, seedable fault injection for the serve path.

Generalizes the ``fault_hook(step)`` escape hatch of
:func:`repro.runtime.train_loop.train` into a *fault plan*: a list of
:class:`FaultSpec` entries, each naming an instrumented **site** on the
solve -> compile -> serve path, a fault **kind**, and a deterministic
window of invocations in which it fires.  The injector is plugged into
:class:`~repro.serving.server.PlanServer` /
:class:`~repro.serving.scheduler.ContinuousScheduler` (and threaded to
the disk cache and fallback ladder); with no injector armed every hook
is a single ``is None`` check.

Sites (see docs/reliability.md for the taxonomy):

========== ==============================================================
site       instrumented where / meaningful kinds
========== ==============================================================
plan_cache ``PlanDiskCache.get``: ``corrupt`` truncates the cache file
           on disk mid-read (exercising the corrupt-entry recovery path)
solve      fallback-ladder solves: ``raise`` fails the PBQP rung,
           ``budget`` overrides the B&B node budget to ``value``
compile    ``PlanServer.compiled_for``: ``raise`` fails the XLA
           compile attempt (retry / ladder territory)
kernel     guarded execution: ``raise`` crashes the executable call,
           ``nan`` poisons its outputs (circuit-breaker territory);
           ``match`` names the primitive to blame
worker     ``ContinuousScheduler._run_batch``: ``raise`` kills the
           worker slot mid-dispatch (the group is re-queued)
========== ==============================================================

Determinism: every site keeps a monotonically increasing invocation
counter and a spec fires on counter values in ``[start, start+count)``
(``count=0``: no upper edge), optionally thinned by probability ``p``
drawn from one seeded :class:`random.Random`.  Replaying the same
workload against the same plan and seed fires the same faults — the
chaos benchmark's output-equivalence gate depends on that.
"""
from __future__ import annotations

import json
import pathlib
import random
import threading
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple

from .errors import InjectedFault

__all__ = ["FaultSpec", "FaultInjector", "parse_fault_plan", "SITES"]

#: instrumented fault sites, in serve-path order
SITES = ("plan_cache", "solve", "compile", "kernel", "worker")


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: where, what, and when."""

    site: str            # one of SITES
    kind: str = "raise"  # raise | nan | corrupt | budget | delay
    start: int = 0       # first site-invocation index that fires
    count: int = 1       # window length in invocations (0 = unbounded)
    p: float = 1.0       # fire probability inside the window
    match: str = ""      # substring filter on the site key (e.g. a
    #                      primitive name or bucket key); "" matches all
    value: float = 0.0   # kind parameter: budget override, delay seconds

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"expected one of {SITES}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault probability {self.p} outside [0, 1]")
        if self.start < 0 or self.count < 0:
            raise ValueError("fault window must be non-negative")


class FaultInjector:
    """Seeded, thread-safe fault scheduler over a plan of specs.

    ``check(site, key)`` advances the site's invocation clock and
    returns the first spec whose window covers this invocation (or
    None).  Callers interpret the spec at the site: raise, poison
    outputs, corrupt a file, shrink a budget.  ``raise_if`` is the
    convenience for pure raise/delay sites.

    ``fired`` logs every fault that actually fired as
    ``(site, kind, invocation, key)`` — the chaos benchmark uses it to
    time recovery windows.
    """

    def __init__(self, plan: Iterable[FaultSpec] = (), seed: int = 0) -> None:
        self.plan: Tuple[FaultSpec, ...] = tuple(plan)
        self._rng = random.Random(seed)
        self._tick = {}
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, str, int, str]] = []

    def check(self, site: str, key: str = "") -> Optional[FaultSpec]:
        with self._lock:
            t = self._tick.get(site, 0)
            self._tick[site] = t + 1
            for spec in self.plan:
                if spec.site != site:
                    continue
                if spec.match and spec.match not in key:
                    continue
                if t < spec.start:
                    continue
                if spec.count and t >= spec.start + spec.count:
                    continue
                if spec.p < 1.0 and self._rng.random() >= spec.p:
                    continue
                self.fired.append((site, spec.kind, t, key))
                return spec
        return None

    def raise_if(self, site: str, key: str = "") -> None:
        """Fire the site's scheduled fault as an exception (if any)."""
        spec = self.check(site, key)
        if spec is not None:
            if spec.kind == "delay":
                import time
                time.sleep(spec.value)
                return
            raise InjectedFault(site, spec.kind, key)

    def ticks(self, site: str) -> int:
        """How many times the site's clock has advanced (diagnostics)."""
        with self._lock:
            return self._tick.get(site, 0)

    def __repr__(self) -> str:  # pragma: no cover
        return f"FaultInjector({len(self.plan)} specs, " \
               f"{len(self.fired)} fired)"


def parse_fault_plan(text: str) -> List[FaultSpec]:
    """Parse a fault plan from a JSON file path or an inline spec string.

    If ``text`` names an existing file it must hold a JSON list of
    :class:`FaultSpec` field dicts.  Otherwise it is the inline DSL the
    serve CLI's ``--fault-plan`` accepts: comma-separated entries of
    the form ``site:kind[@start[+count]][~match][=value]`` — e.g.
    ``kernel:nan@5+3~winograd_2,compile:raise@0+2`` schedules NaN
    poisoning of winograd_2 kernels on guarded executions 5-7 and
    compile failures on the first two compile attempts.
    """
    path = pathlib.Path(text)
    if path.exists() and path.is_file():
        specs = json.loads(path.read_text())
        if not isinstance(specs, list):
            raise ValueError(f"fault plan {text}: expected a JSON list")
        return [FaultSpec(**d) for d in specs]
    out: List[FaultSpec] = []
    for entry in filter(None, (s.strip() for s in text.split(","))):
        head, value = entry.split("=", 1) if "=" in entry else (entry, "0")
        head, match = head.split("~", 1) if "~" in head else (head, "")
        head, window = head.split("@", 1) if "@" in head else (head, "0+1")
        if ":" not in head:
            raise ValueError(f"fault entry {entry!r}: expected site:kind")
        site, kind = head.split(":", 1)
        start_s, count_s = window.split("+", 1) if "+" in window \
            else (window, "1")
        out.append(FaultSpec(site=site.strip(), kind=kind.strip(),
                             start=int(start_s), count=int(count_s),
                             match=match.strip(), value=float(value)))
    if not out:
        raise ValueError(f"empty fault plan {text!r}")
    return out
