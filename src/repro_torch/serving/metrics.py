"""Serving counters: hit/miss/latency accounting for the plan cache.

One :class:`ServingCounters` per :class:`~repro.serving.server.
PlanServer`.  Everything the plan-cache benchmark and the acceptance
tests assert on lives here — e.g. "two requests in the same bucket
trigger exactly one PBQP solve and one compile" is
``counters.solves == 1 and counters.compiles == 1``.

Since the observability PR this is a *view* over a
:class:`repro.obs.metrics.MetricsRegistry` rather than a bag of ints
behind one lock: every count is a registry :class:`~repro.obs.metrics.
Counter` (still exactly-once under concurrency — the threaded hammer in
tests/test_observability.py pins that down) and every ``*_s`` wall-time
field additionally feeds per-phase latency *histograms*, so
:meth:`PlanServer.stats` can report p50/p95/p99 per phase (and per
batch bucket) instead of only accumulated totals.  The ``snapshot()``
keys and int-ness are unchanged — callers of the old dataclass see the
same dict.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..obs.metrics import MetricsRegistry

__all__ = ["ServingCounters", "COUNT_FIELDS", "TIME_FIELDS",
           "LATENCY_METRIC"]

#: monotonically-counted events (ints in ``snapshot()``)
COUNT_FIELDS = (
    "requests",
    # plan lookups that hit (memory or disk) vs required a PBQP solve
    "plan_mem_hits", "plan_disk_hits", "plan_misses",
    # compiled-executable LRU
    "exec_hits", "exec_misses", "exec_evictions",
    # batched execution: executable invocations serving > 0 requests
    # each, and how many requests shared an invocation with another
    "batch_calls", "coalesced",
    # solver / compiler work actually performed
    "solves", "warm_solves", "compiles", "mesh_compiles",
    # continuous-batching scheduler (repro.serving.scheduler): requests
    # submitted, batches launched, and why each batch launched — the
    # group filled its batch bucket, the oldest request's deadline
    # slack crossed the modeled batch latency, or the batching window
    # expired with no other trigger
    "sched_submits", "sched_batches",
    "sched_full_launches", "sched_deadline_launches",
    "sched_window_launches",
    # per-request SLO accounting (requests that carried a deadline)
    "deadline_met", "deadline_miss",
    # elastic worker-pool resizes applied by the scheduler
    "worker_resizes",
    # --- reliability layer (repro.reliability, docs/reliability.md) ---
    # corrupt/truncated/stale-schema plan-cache files detected (and
    # deleted) on read; each one re-solves
    "plan_cache_corrupt",
    # fallback-ladder rung served per plan selection: exact PBQP,
    # anytime (deadline/budget-degraded solve), greedy local-optimal,
    # or the solver-free reference plan
    "ladder_exact", "ladder_anytime", "ladder_greedy", "ladder_reference",
    # compile attempts retried after a transient failure, and plans
    # demoted down the ladder because every retry failed
    "compile_retries", "compile_fallbacks",
    # guarded-execution failures (crash or non-finite outputs), and
    # (primitive, bucket) circuit-breaker trips they caused
    "kernel_failures", "quarantines",
    # admission control: requests rejected because the modeled backlog
    # made their deadline unmeetable (scheduler shed=True)
    "shed_requests",
    # scheduler worker slots that died mid-dispatch, and the requests
    # re-queued (once each) to survive them
    "worker_deaths", "worker_requeues",
)
#: accumulated wall time (seconds); each also records one histogram
#: sample per ``add`` under phase = field name minus the ``_s`` suffix
#: (``request_s`` is the scheduler's submit -> result latency, i.e.
#: queueing + batching + execution as one end-to-end sample)
TIME_FIELDS = ("solve_s", "compile_s", "execute_s", "request_s")
#: histogram metric name the phase/bucket latency samples land in
LATENCY_METRIC = "serving_latency_seconds"


class ServingCounters:
    """Registry-backed serving counters (same ``add``/``snapshot`` API
    as the pre-observability dataclass, plus latency percentiles).

    ``add(..., _bucket="8x3x32x32")`` labels the wall-time histogram
    samples of that call with the batch bucket, so percentiles can be
    split per bucket; the scalar accumulation is unaffected.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        #: the backing registry — shared with the owning PlanServer so
        #: ``stats()`` and Prometheus exposition read the same store
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        for f in COUNT_FIELDS + TIME_FIELDS:
            self.registry.counter(f)

    def __getattr__(self, name: str):
        # attribute reads (`counters.solves`) keep working on the view
        if name in COUNT_FIELDS or name in TIME_FIELDS:
            return self.registry.counter(name).value
        raise AttributeError(name)

    def add(self, _bucket: Optional[str] = None, **kw) -> None:
        for k, v in kw.items():
            if k in COUNT_FIELDS:
                if v:
                    self.registry.counter(k).add(int(v))
            elif k in TIME_FIELDS:
                self.registry.counter(k).add(float(v))
                phase = k[:-2]
                self.registry.histogram(
                    LATENCY_METRIC, phase=phase).record(float(v))
                if _bucket is not None:
                    self.registry.histogram(
                        LATENCY_METRIC, phase=phase,
                        bucket=_bucket).record(float(v))
            else:
                raise AttributeError(f"unknown counter {k!r}")

    # -----------------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        d: Dict[str, float] = {}
        for f in COUNT_FIELDS:
            d[f] = int(self.registry.counter(f).value)
        for f in TIME_FIELDS:
            d[f] = float(self.registry.counter(f).value)
        d["plan_hits"] = d["plan_mem_hits"] + d["plan_disk_hits"]
        total = d["plan_hits"] + d["plan_misses"]
        d["plan_hit_rate"] = d["plan_hits"] / total if total else 0.0
        total = d["exec_hits"] + d["exec_misses"]
        d["exec_hit_rate"] = d["exec_hits"] / total if total else 0.0
        # goodput: deadline-met fraction over deadline-carrying requests
        total = d["deadline_met"] + d["deadline_miss"]
        d["goodput"] = d["deadline_met"] / total if total else 1.0
        # degradations: selections served from any rung below exact
        d["ladder_demotions"] = (d["ladder_anytime"] + d["ladder_greedy"]
                                 + d["ladder_reference"])
        return d

    def phase_quantiles(self) -> Dict[str, Dict[str, float]]:
        """Per-phase (and per phase+bucket) latency percentiles.

        Returns ``{"solve": {"count", "p50", "p95", "p99", ...},
        "execute[bucket=8x3x32x32]": {...}, ...}`` — one entry per
        phase histogram that has recorded at least one sample.
        """
        out: Dict[str, Dict[str, float]] = {}
        for key, snap in self.registry.snapshot().items():
            if not key.startswith(LATENCY_METRIC) or \
                    not isinstance(snap, dict) or not snap.get("count"):
                continue
            labels = dict(
                kv.split("=", 1) for kv in
                key[len(LATENCY_METRIC):].strip("{}").replace('"', "")
                .split(",") if "=" in kv)
            name = labels.pop("phase", "?")
            if labels:
                name += "[" + ",".join(f"{k}={v}" for k, v in
                                       sorted(labels.items())) + "]"
            out[name] = snap
        return out
