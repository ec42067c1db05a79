"""Continuous batching with SLO-aware scheduling over a PlanServer.

The micro-batching admission queue of PR 3 (``PlanServer.enqueue`` /
``flush``) is a *barrier*: everything enqueued waits for the next
``flush()`` call, all of it launches at once, and nothing else can
launch until the caller flushes again.  The batch-size-vs-latency
policy that implies — "batch = whatever arrived in one tick" — was an
accident of the serve loop's tick length, not a solved tradeoff.

:class:`ContinuousScheduler` replaces the barrier with *continuous*
batching: producers ``submit()`` single requests (optionally carrying a
deadline) and a dispatcher thread admits queued work into in-flight
bucket groups the moment a worker slot frees.  A bucket group launches
when the first of three triggers fires:

* **full** — the group reached the bucket policy's ``max_n``: the
  batched executable is maximally utilized, waiting longer buys
  nothing.
* **deadline** — the oldest queued request's slack (deadline minus now)
  dropped to ``safety ×`` the *modeled* latency of launching the group
  at its current size.  The model is the calibrated/analytic cost
  model's prediction for the bucket's plan (``SelectionResult.
  predicted_cost``) until the bucket has real samples, then the
  observed per-bucket p95 from the ``execute`` phase histograms in
  :mod:`repro.obs.metrics` — predicted-until-measured, the same
  fallback direction the cost tables use.
* **window** — ``batch_window_s`` elapsed since the oldest request
  queued.  This bounds the latency of deadline-less traffic and is the
  explicit batch-size-vs-p99 knob: a wider window coalesces more
  requests per invocation (throughput), a narrower one launches
  smaller batches sooner (tail latency).  docs/serving.md quantifies
  the tradeoff.

Launched groups execute through :meth:`~repro.serving.server.
PlanServer.infer_batch` on a worker pool whose size an
:class:`~repro.runtime.elastic.ElasticController` retargets every
dispatch round from observed backlog — scale up when queueing builds,
scale down after sustained calm — and the scheduler mirrors the target
into :meth:`~repro.serving.server.PlanServer.resize_workers` so the
server's prefetch pool tracks load too.

Everything the SLO story needs to be falsifiable is counted in the
server's :class:`~repro.serving.metrics.ServingCounters`: per-request
end-to-end latency histograms (``request`` phase, per batch bucket),
launch-reason counters, and ``deadline_met``/``deadline_miss`` whose
ratio is the *goodput* the load benchmark (benchmarks/bench_load.py)
gates in CI.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from threading import Condition, Thread
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..reliability.errors import ShedError
from .bucketing import bucket_key, bucket_shape
from .metrics import LATENCY_METRIC

__all__ = ["ContinuousScheduler"]

Shape = Tuple[int, int, int]

#: launch trigger -> ServingCounters field
_REASON_COUNTER = {
    "full": "sched_full_launches",
    "deadline": "sched_deadline_launches",
    "window": "sched_window_launches",
}


@dataclass
class _Pending:
    """One queued request: payload, resolution future, timing."""
    x: np.ndarray
    fut: Future
    t_submit: float
    deadline: Optional[float]  # absolute perf_counter seconds, or None
    #: times this request was re-queued after its worker slot died
    #: (bounded at 1: a request that kills two workers is the poison)
    requeues: int = 0


class ContinuousScheduler:
    """SLO-aware continuous batcher over a :class:`PlanServer`.

    Parameters
    ----------
    server:
        The plan server whose ``infer_batch`` executes launched groups
        (and whose counters/registry record the scheduler's metrics).
    batch_window_s:
        Maximum time a deadline-less request waits for co-batchable
        arrivals before a partial batch launches anyway.
    slo_s:
        Default SLO applied to every ``submit`` that does not pass its
        own (None: no deadline unless the submit carries one).
    safety:
        Slack multiplier on the modeled batch latency: a deadline
        launch fires when ``slack <= safety * modeled``.  > 1 hedges
        model error toward meeting the deadline.
    elastic:
        Worker-pool policy (:class:`~repro.runtime.elastic.
        ElasticController`); a fresh single-worker..4-worker controller
        when None.
    min_model_samples:
        Observed ``execute`` samples a bucket needs before its
        histogram p95 replaces the cost model's prediction.
    shed:
        Deadline-aware load shedding (docs/reliability.md): a submit
        whose deadline the *modeled* backlog already makes unmeetable
        is rejected at admission with :class:`~repro.reliability.
        ShedError` instead of queued to certainly miss — an early typed
        "no" the client can retry elsewhere beats a late wrong "yes".
        Off by default (every request is admitted, deadline misses are
        counted, the PR 7 behavior).
    shed_safety:
        Multiplier on the modeled completion estimate the shed check
        compares against the deadline; > 1 sheds earlier (hedging model
        optimism), < 1 admits more marginal requests.
    """

    def __init__(self, server, *, batch_window_s: float = 0.02,
                 slo_s: Optional[float] = None, safety: float = 1.5,
                 elastic=None, min_model_samples: int = 3,
                 shed: bool = False, shed_safety: float = 1.0) -> None:
        if batch_window_s <= 0:
            raise ValueError(f"batch_window_s must be > 0, "
                             f"got {batch_window_s}")
        if elastic is None:
            # lazy import: repro.runtime pulls in the model stack, which
            # serving must not require at import time
            from ..runtime.elastic import ElasticController
            elastic = ElasticController()
        self.server = server
        self.policy = server.policy
        self.batch_window_s = float(batch_window_s)
        self.default_slo_s = slo_s
        self.safety = float(safety)
        self.min_model_samples = int(min_model_samples)
        self.shed = bool(shed)
        self.shed_safety = float(shed_safety)
        #: the server's chaos hook drives the scheduler's worker site
        #: too — one fault plan covers the whole serve stack
        self.fault_injector = getattr(server, "fault_injector", None)
        self.elastic = elastic
        self._queues: "OrderedDict[Shape, Deque[_Pending]]" = OrderedDict()
        self._cond = Condition()
        self._inflight = 0
        self._closed = False
        self._workers_applied = elastic.workers
        server.resize_workers(elastic.workers)
        self._exec = ThreadPoolExecutor(max_workers=elastic.max_workers,
                                        thread_name_prefix="sched-batch")
        self._dispatcher = Thread(target=self._dispatch_loop,
                                  name="sched-dispatch", daemon=True)
        self._dispatcher.start()

    # -----------------------------------------------------------------
    # producer side
    # -----------------------------------------------------------------
    def submit(self, x_chw: np.ndarray, *, slo_s: Optional[float] = None,
               deadline: Optional[float] = None) -> Future:
        """Queue one request; returns a Future resolving to its output
        dict (same payload as :meth:`PlanServer.infer`).

        ``slo_s`` turns into an absolute deadline ``now + slo_s``;
        ``deadline`` passes one directly (``time.perf_counter``
        seconds).  With neither (and no scheduler-level default), the
        request has no deadline and launches on the full/window
        triggers only.
        """
        x = np.asarray(x_chw, np.float32)
        if x.ndim != 3:
            raise ValueError(f"expected (C, H, W) input, got {x.shape}")
        now = time.perf_counter()
        if deadline is None:
            slo = slo_s if slo_s is not None else self.default_slo_s
            deadline = now + slo if slo is not None else None
        fut: Future = Future()
        bshape = bucket_shape(x.shape, self.policy)
        with self._cond:
            if self._closed:
                raise RuntimeError("ContinuousScheduler is closed")
            if self.shed and deadline is not None:
                eta = self._shed_eta_locked(bshape)
                if now + eta > deadline:
                    self.server.counters.add(shed_requests=1)
                    raise ShedError(eta, deadline - now)
            self._queues.setdefault(bshape, deque()).append(
                _Pending(x, fut, now, deadline))
            self.server.counters.add(sched_submits=1)
            self._cond.notify_all()
        return fut

    def _shed_eta_locked(self, bshape: Shape) -> float:
        """Modeled completion time for a request admitted *now*.

        Serial waves the backlog implies — this request's group, every
        group already queued (any bucket), and everything in flight,
        over the applied worker count — times the modeled latency of
        the request's own bucket.  Deliberately coarse: admission
        control needs a monotone load signal, not a simulation (the
        same modeled-latency source the deadline launch trigger uses,
        so the two SLO mechanisms agree on what "too slow" means).
        """
        qlen = len(self._queues.get(bshape, ()))
        est = self._modeled_latency(bshape,
                                    self.policy.bucket_n(qlen + 1))
        groups = 1 + self._inflight + sum(
            (len(q) + self.policy.max_n - 1) // self.policy.max_n
            for q in self._queues.values())
        waves = -(-groups // max(1, self._workers_applied))
        return self.shed_safety * est * waves

    def submit_many(self, xs: Sequence[np.ndarray], *,
                    slo_s: Optional[float] = None) -> List[Future]:
        """Submit a burst; same-bucket members co-batch naturally."""
        return [self.submit(x, slo_s=slo_s) for x in xs]

    def prewarm(self, shapes: Sequence[Shape],
                batches: Sequence[int] = (1,)) -> None:
        """Solve + compile the (bucket, batch-bucket) executables ahead
        of traffic (blocking).  Cold XLA compiles take longer than any
        sane SLO, so a server that cares about goodput warms the
        buckets its traffic mix will hit before opening the doors."""
        futs = [self.server.prefetch(s, n=n) for s in shapes
                for n in batches]
        for f in futs:
            f.result()

    # -----------------------------------------------------------------
    # dispatcher
    # -----------------------------------------------------------------
    def _dispatch_loop(self) -> None:
        while True:
            launches: List[Tuple[Shape, List[_Pending], str]] = []
            with self._cond:
                now = time.perf_counter()
                self._apply_elastic_locked()
                while self._inflight < self._workers_applied:
                    picked = self._pick_batch_locked(now)
                    if picked is None:
                        break
                    launches.append(picked)
                    self._inflight += 1
                if not launches:
                    if self._closed and not self._queued_locked() \
                            and self._inflight == 0:
                        return
                    self._cond.wait(timeout=self._next_wake_locked(now))
                    continue
            for bshape, group, reason in launches:
                self._exec.submit(self._run_batch, bshape, group, reason)

    def _queued_locked(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _apply_elastic_locked(self) -> None:
        queued = self._queued_locked()
        target = self.elastic.desired_workers(queued, self._inflight)
        reg = self.server.counters.registry
        reg.gauge("sched_queue_depth").set(queued)
        reg.gauge("sched_workers").set(target)
        if target != self._workers_applied:
            self._workers_applied = target
            self.server.counters.add(worker_resizes=1)
            self.server.resize_workers(target)

    def _launch_at(self, bshape: Shape, q: "Deque[_Pending]",
                   now: float) -> Tuple[float, str]:
        """Earliest time this bucket's group should launch, and why.

        ``-inf`` (full group, or draining on close) means "now".  The
        deadline trigger backs off the oldest deadline by ``safety ×``
        the modeled latency of the group at its *current* size — as
        arrivals grow the group, both the trigger time and the batch
        it would launch are re-evaluated every round.
        """
        if len(q) >= self.policy.max_n or self._closed:
            return -np.inf, "full" if len(q) >= self.policy.max_n \
                else "window"
        head = q[0]
        at = head.t_submit + self.batch_window_s
        reason = "window"
        deadlines = [p.deadline for p in q if p.deadline is not None]
        if deadlines:
            est = self._modeled_latency(bshape,
                                        self.policy.bucket_n(len(q)))
            dl_at = min(deadlines) - self.safety * est
            if dl_at < at:
                at, reason = dl_at, "deadline"
        return at, reason

    def _pick_batch_locked(self, now: float
                           ) -> Optional[Tuple[Shape, List[_Pending], str]]:
        """Pop the most overdue launchable bucket group, if any."""
        best: Optional[Tuple[float, Shape, str]] = None
        for bshape, q in self._queues.items():
            if not q:
                continue
            at, reason = self._launch_at(bshape, q, now)
            if at <= now and (best is None or at < best[0]):
                best = (at, bshape, reason)
        if best is None:
            return None
        _, bshape, reason = best
        q = self._queues[bshape]
        group = [q.popleft() for _ in range(min(len(q),
                                                self.policy.max_n))]
        if not q:
            del self._queues[bshape]
        return bshape, group, reason

    def _next_wake_locked(self, now: float) -> Optional[float]:
        """Sleep until the earliest pending trigger (None: until
        notified — nothing is queued, so only a submit or a completion
        can create work)."""
        soonest: Optional[float] = None
        for bshape, q in self._queues.items():
            if not q:
                continue
            at, _ = self._launch_at(bshape, q, now)
            if soonest is None or at < soonest:
                soonest = at
        if soonest is None:
            return None
        return min(max(soonest - now, 1e-3), 1.0)

    # -----------------------------------------------------------------
    # latency model
    # -----------------------------------------------------------------
    def _modeled_latency(self, bshape: Shape, nb: int) -> float:
        """Expected wall time of one batched invocation of this bucket.

        Observed per-bucket ``execute`` p95 once the bucket has
        ``min_model_samples`` real samples; before that, the cost
        model's prediction for the bucket's solved plan (which is a
        memory-cached dict hit after the bucket's first solve).
        """
        h = self.server.counters.registry.find_histogram(
            LATENCY_METRIC, phase="execute",
            bucket=bucket_key(bshape, nb))
        if h is not None and h.count >= self.min_model_samples:
            return max(float(h.percentile(95)), 1e-6)
        try:
            sel = self.server.plan_for(bshape, n=nb)
            return max(float(sel.predicted_cost), 1e-6)
        except Exception:
            # an unpriceable bucket must not kill the dispatcher; treat
            # its latency as one batching window (conservative: the
            # deadline trigger then fires a window early)
            return self.batch_window_s

    # -----------------------------------------------------------------
    # worker side
    # -----------------------------------------------------------------
    def _run_batch(self, bshape: Shape, group: List[_Pending],
                   reason: str) -> None:
        if self.fault_injector is not None:
            spec = self.fault_injector.check(
                "worker", key=bucket_key(bshape,
                                         self.policy.bucket_n(len(group))))
            if spec is not None:
                self._worker_died(bshape, group, spec)
                return
        try:
            outs = self.server.infer_batch([p.x for p in group])
        except BaseException as exc:  # noqa: BLE001 — must resolve futs
            for p in group:
                p.fut.set_exception(exc)
        else:
            done = time.perf_counter()
            bkey = bucket_key(bshape,
                              self.policy.bucket_n(len(group)))
            met = miss = 0
            for p in group:
                self.server.counters.add(_bucket=bkey,
                                         request_s=done - p.t_submit)
                if p.deadline is not None:
                    if done <= p.deadline:
                        met += 1
                    else:
                        miss += 1
            self.server.counters.add(
                sched_batches=1, deadline_met=met, deadline_miss=miss,
                **{_REASON_COUNTER[reason]: 1})
            for p, out in zip(group, outs):
                p.fut.set_result(out)
        finally:
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()

    def _worker_died(self, bshape: Shape, group: List[_Pending],
                     spec) -> None:
        """An injected worker-slot death mid-dispatch.

        The group's requests go back to the *front* of their bucket
        queue (they are the oldest work — deadline ordering must hold),
        each at most once: a request that has already killed a worker
        is treated as the poison and fails with
        :class:`~repro.reliability.InjectedFault` rather than cycling
        through the pool forever.
        """
        from ..reliability.errors import InjectedFault
        self.server.counters.add(worker_deaths=1)
        requeued = 0
        with self._cond:
            q = self._queues.setdefault(bshape, deque())
            for p in reversed(group):
                if p.requeues < 1:
                    p.requeues += 1
                    q.appendleft(p)
                    requeued += 1
                else:
                    p.fut.set_exception(InjectedFault(
                        "worker", spec.kind, spec.match))
            if not q:
                del self._queues[bshape]
            self._inflight -= 1
            self._cond.notify_all()
        if requeued:
            self.server.counters.add(worker_requeues=requeued)

    # -----------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Server stats plus the scheduler's live queue/worker view."""
        d = self.server.stats()
        with self._cond:
            d["sched_queued"] = self._queued_locked()
            d["sched_inflight"] = self._inflight
            d["sched_workers"] = self._workers_applied
        return d

    def close(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the dispatcher.  ``drain=True`` (default) launches
        everything still queued first, so no submitted future is left
        unresolved; ``drain=False`` cancels queued work instead."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            if not drain:
                for q in self._queues.values():
                    for p in q:
                        p.fut.cancel()
                self._queues.clear()
            self._cond.notify_all()
        self._dispatcher.join(timeout=timeout)
        self._exec.shutdown(wait=True)
