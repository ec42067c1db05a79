"""Reliability layer: chaos-tested serving for the PBQP serve path.

The paper guarantees a *valid* primitive/layout assignment when the
solver finishes; production serving (ROADMAP north star) also has to
survive the solver *not* finishing, the plan cache corrupting, kernels
crashing or emitting NaN, and workers dying.  This package holds the
four mechanisms, wired through :class:`~repro.serving.server.PlanServer`
and :class:`~repro.serving.scheduler.ContinuousScheduler`:

* :mod:`.faults`     — deterministic, seedable :class:`FaultInjector`
  over scheduled fault plans (sites: plan_cache, solve, compile,
  kernel, worker), generalizing ``train_loop``'s ``fault_hook``;
* :mod:`.fallback`   — the solve :class:`FallbackLadder` (exact ->
  anytime-under-deadline -> greedy -> reference jnp) plus the bounded
  jittered :func:`retry_call` used for compile retries;
* :mod:`.quarantine` — the per-(primitive, bucket)
  :class:`PrimitiveQuarantine` circuit breaker and the NaN-attribution
  walk :func:`diagnose_nonfinite`;
* :mod:`.errors`     — the typed failures (:class:`InjectedFault`,
  :class:`KernelFailure`, :class:`ShedError`).

docs/reliability.md is the narrative: fault taxonomy, ladder table,
quarantine lifecycle, shed semantics; benchmarks/bench_chaos.py is the
proof under a scheduled fault storm.
"""
from .errors import InjectedFault, KernelFailure, ShedError
from .fallback import (RUNGS, FallbackLadder, reference_selection,
                       retry_call)
from .faults import SITES, FaultInjector, FaultSpec, parse_fault_plan
from .quarantine import PrimitiveQuarantine, diagnose_nonfinite

__all__ = [
    "InjectedFault", "KernelFailure", "ShedError",
    "RUNGS", "FallbackLadder", "reference_selection", "retry_call",
    "SITES", "FaultInjector", "FaultSpec", "parse_fault_plan",
    "PrimitiveQuarantine", "diagnose_nonfinite",
]
