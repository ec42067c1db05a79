"""PlanServer: the per-request dispatcher of the serving subsystem.

Request path (the bridge between ``core/selection.py`` and
``runtime/serve_loop.py``)::

    request shape --bucket--> (bucket shape, batch bucket)
        --> compiled-executable LRU hit?     -> execute
        --> persistent plan cache hit?       -> compile, execute
        --> PBQP solve (warm-started from the nearest solved bucket),
            persist plan, compile, execute

Every tier is keyed on the *pair* (bucket shape, batch bucket): the
optimal primitive assignment flips with minibatch (``Scenario.n``), so
an N=8 plan is a different plan — and a different executable — than the
N=1 plan for the same spatial bucket.

Three execution entry points:

* :meth:`PlanServer.infer` — one image, the latency path.  Outputs are
  cropped back to the *request's* extent (the request was zero-padded
  into its bucket; bucket-shaped outputs would leak padding).
* :meth:`PlanServer.infer_batch` — a list of images, the throughput
  path: requests group by bucket and each group runs as ONE batched
  executable invocation (batched tower, zero rows padding the batch to
  its pow2 bucket).
* :meth:`PlanServer.enqueue` / :meth:`PlanServer.flush` — the
  micro-batching admission queue: producers enqueue single images and
  get a Future; ``flush()`` coalesces everything pending through
  :meth:`infer_batch`.  This is the *barrier-flush* primitive; the
  production path layers :class:`~repro.serving.scheduler.
  ContinuousScheduler` on :meth:`infer_batch` instead — continuous
  batching with per-request deadlines and SLO-aware partial launches
  (docs/serving.md) — which is what the LM serve loop now admits
  through.

Port of the reference's ``serving/server.py``.  What differs:

* **Executables are CUDA graphs.**  With ``jit=True`` (the default) on
  the card, the warm-up call of each new executable captures its
  forward (``compile_plan(jit=True)``, :class:`~repro_torch.core.plan.
  CapturedForward`), so "compile" keeps its meaning: weight packing
  plus capture; every request after replays the graph.  ``jit=False``
  serves the eager walk.  On the CPU ``jit`` has no effect.
* **The device.**  ``device`` (default: the card, which must be
  present) is where every executable runs; ``device="cpu"`` serves the
  plain PyTorch versions.  Outputs come back to the host as numpy.
* **The mesh is SPMD.**  With a ``DeviceMesh`` (``mesh=``), batched
  buckets solve the unified choice space (primitive x layout x device
  placement, ``select_pbqp(..., mesh_axes=)``), plans with a sharded
  node compile mesh-sharded (``compile_plan(..., mesh=)``), and the
  mesh fingerprint joins every cache key, as in the reference.  Every
  rank of the mesh runs its own server on the same request stream, and
  a mesh executable's collectives must be issued in the same order on
  every rank, or the ranks deadlock.  So with a mesh the server solves,
  compiles, warms up and runs on the caller's thread, in request
  order: :meth:`PlanServer.prefetch` computes before it returns, and
  :meth:`PlanServer.infer_batch` takes its groups one after another.
  Drive a mesh server from one thread.  Only rank 0 writes the disk
  tier of the plan cache, between two barriers of all ranks (every rank
  reads the tier before the write, and none runs on before it).  A mesh compile or run that fails for any reason but an
  injected fault raises: no ladder rung carries on without the mesh.
* **No fallback hides the card.**  On the card an exception that no
  fault injector raised (a kernel that does not build, a capture that
  fails, a launcher's error) propagates to the caller: the retry,
  demotion and quarantine ladder takes only injected faults and
  non-finite outputs there.  On the CPU the ladder keeps the reference's
  semantics for every exception.
* **Its own cache namespace.**  ``+torch`` joins the cost version every
  cache tier keys on, so a ``cache_dir`` shared with the reference's
  server never serves one package's plan to the other.

Misses can be taken off the caller's thread with :meth:`PlanServer.
prefetch` (async solve+compile).  Cache bookkeeping (and the
millisecond-scale PBQP solve) runs under one lock, but the expensive
compile + warm-up happens outside it behind a per-bucket future:
hot-bucket requests never stall behind a cold bucket compiling, and
concurrent requests racing into the same cold bucket still trigger
exactly one solve and one compile (the acceptance property
tests/test_serving.py pins down via the counters).  Captures of
different buckets take one process-wide lock; replays do not.
"""
from __future__ import annotations

import random
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from threading import RLock
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.costs import CostModel
from ..core.graph import Net
from ..core.plan import CompiledNet, compile_plan, mesh_shape_dict
from ..core.selection import SelectionResult, select_local_optimal
from ..kernels.common import resolve_device
from ..launch.mesh import mesh_fingerprint
from ..obs.spans import span, tracing
from ..obs.trace import NULL_SPAN, get_tracer
from ..reliability import (FallbackLadder, FaultInjector, KernelFailure,
                           PrimitiveQuarantine, diagnose_nonfinite,
                           reference_selection, retry_call)
from ..reliability.errors import InjectedFault
from .bucketing import BucketPolicy, bucket_key, bucket_shape
from .metrics import ServingCounters
from .plan_cache import (
    LRU, PlanDiskCache, plan_key, selection_from_payload,
    selection_to_payload,
)

__all__ = ["PlanServer"]

Shape = Tuple[int, int, int]
#: internal cache key: spatial bucket + batch bucket
PlanKey = Tuple[int, int, int, int]


class PlanServer:
    """Serve per-request primitive-selection plans and executables.

    Parameters
    ----------
    net_builder:
        ``(C, H, W) -> Net`` — must yield identical node ids across
        shapes (see :mod:`repro.serving.towers`) so warm starts line up.
        The server applies the batch bucket via ``Net.with_batch``.
    cost_model:
        Prices primitives and layout transforms; its :meth:`~repro.core.
        costs.CostModel.version` participates in the persistent cache key.
    cache_dir:
        Directory for the persistent plan cache; ``None`` disables the
        disk tier (plans still cached in memory for the process lifetime).
    lru_capacity:
        Max live compiled executables (batched ones count like any other).
        An evicted executable's packed weights and CUDA graph (with its
        private memory pool) go with its last reference.
    device:
        Where the executables run: the card unless ``"cpu"`` is asked
        for (without a GPU the default raises).
    mesh:
        A ``DeviceMesh`` of the device's type for batched executables:
        batch-bucket solves gain the placement axis over the mesh's axes
        (dp on the batch axes, tp on "model", pp stages on "stage"),
        and sharded plans compile mesh-sharded.  Every rank of the mesh
        serves the same requests in the same order, from one thread.
    """

    def __init__(self, net_builder: Callable[[Shape], Net],
                 cost_model: CostModel, *,
                 policy: Optional[BucketPolicy] = None,
                 cache_dir=None, lru_capacity: int = 8,
                 exact: bool = True, params_seed: int = 0,
                 jit: bool = True, max_workers: int = 2,
                 fuse: bool = False, mesh=None,
                 fault_injector: Optional[FaultInjector] = None,
                 solve_deadline_s: Optional[float] = None,
                 quarantine: Optional[PrimitiveQuarantine] = None,
                 compile_retries: int = 2,
                 compile_backoff_s: float = 0.05,
                 kernel_retries: int = 1,
                 guard_outputs: bool = True, device=None) -> None:
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot serve "
                             f"{self.device.type} executables")
        self.net_builder = net_builder
        self.cost = cost_model
        self.fuse = fuse
        #: device mesh for batched executables: batch-bucket solves gain
        #: the placement axis over the mesh's axes, and sharded plans
        #: compile mesh-sharded (``infer_batch`` then runs each bucket
        #: group sharded across the mesh)
        self.mesh = mesh
        self._mesh_axes = mesh_shape_dict(mesh) if mesh is not None \
            else None
        # a fused and an unfused plan for the same bucket are different
        # plans (edges priced and realized differently), so is the same
        # bucket solved for a different mesh topology, and a plan of
        # this package is not the reference's to serve — fold all three
        # into the version string every cache tier keys on
        self.cost_version = cost_model.version() + "+torch" + \
            ("+fuse" if fuse else "") + \
            (f"+mesh={mesh_fingerprint(mesh)}" if mesh is not None else "")
        self.policy = policy or BucketPolicy()
        self.exact = exact
        self.params_seed = params_seed
        self.jit = jit
        self.counters = ServingCounters()
        #: bytes the executed forwards' joins and layout conversions
        #: moved (``CompiledNet.layout_copy_bytes`` per forward)
        self._layout_copies = self.counters.registry.counter(
            "layout_copy_bytes")
        # --- reliability layer (docs/reliability.md) ---
        self.fault_injector = fault_injector
        self.quarantine = quarantine if quarantine is not None \
            else PrimitiveQuarantine()
        self.compile_retries = int(compile_retries)
        self.compile_backoff_s = float(compile_backoff_s)
        self.kernel_retries = int(kernel_retries)
        self.guard_outputs = guard_outputs
        #: solve rungs: exact (or anytime under the deadline) -> greedy
        #: -> reference; every selection goes through the ladder
        self.ladder = FallbackLadder(
            cost_model, exact=exact, deadline_s=solve_deadline_s,
            counters=self.counters, fault_injector=fault_injector)
        #: seeded so chaos runs replay their retry backoff exactly
        self._retry_rng = random.Random(params_seed)
        #: prior plan of a bucket whose plan-tier entry was evicted by a
        #: quarantine trip — the warm-start incumbent for the re-solve
        self._quar_warm: Dict[PlanKey, SelectionResult] = {}
        self._plans: Dict[PlanKey, SelectionResult] = {}
        self._compiled = LRU(lru_capacity)
        self._building: Dict[PlanKey, Future] = {}
        self._disk = PlanDiskCache(
            cache_dir,
            on_corrupt=lambda _k: self.counters.add(plan_cache_corrupt=1),
            fault_injector=fault_injector) if cache_dir else None
        self._lock = RLock()
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="planserver")
        #: request-shape -> output-node expected shapes (crop targets)
        self._out_shapes = LRU(512)
        #: micro-batching admission queue: (image, future, enqueue time)
        self._queue: List[Tuple[np.ndarray, Future, float]] = []
        self._closed = False

    # -----------------------------------------------------------------
    # plan tier
    # -----------------------------------------------------------------
    def plan_for(self, shape_chw: Shape, n: int = 1) -> SelectionResult:
        """Bucket the shape (and batch) and return its selection."""
        bshape = bucket_shape(shape_chw, self.policy)
        nb = self.policy.bucket_n(n)
        with self._lock:
            return self._plan_locked(bshape, nb)

    def _plan_locked(self, bshape: Shape, nb: int) -> SelectionResult:
        bkey = bucket_key(bshape, nb)
        with get_tracer().span("plan", bucket=bkey) as sp:
            pkey: PlanKey = (*bshape, nb)
            sel = self._plans.get(pkey)
            if sel is not None:
                self.counters.add(plan_mem_hits=1)
                sp.set(source="mem")
                return sel
            net = self.net_builder(bshape).with_batch(nb)
            # active quarantines rotate the cache key per bucket (the
            # cost-version rotation, scoped): a plan solved around a
            # banned primitive never collides with the healthy plan, and
            # when the quarantine lifts the token empties — the original
            # on-disk plan becomes a hit again, which *is* recovery
            key = plan_key(net.fingerprint(), bkey, self.cost_version
                           + self.quarantine.version_token(bkey))
            if self._disk is not None:
                payload = self._disk.get(key)
                if payload is not None:
                    try:
                        sel = selection_from_payload(payload, net)
                    except (KeyError, ValueError) as exc:
                        # unknown primitive / malformed payload: same
                        # corrupt-entry path as unreadable JSON
                        self._disk.discard(key, f"payload invalid ({exc})")
                        sel = None
                if sel is not None:
                    self.counters.add(plan_disk_hits=1)
                    self._plans[pkey] = sel
                    sp.set(source="disk")
                    return sel
            self.counters.add(plan_misses=1)
            banned = self.quarantine.banned_for(bkey)
            # warm start: the bucket's own pre-quarantine plan beats the
            # nearest-bucket incumbent when re-solving after a trip
            warm = self._quar_warm.pop(pkey, None) or \
                self._nearest_plan(pkey)
            t0 = time.perf_counter()
            # the ladder runs select_pbqp (which opens the nested
            # pbqp.solve/solve_warm spans) and degrades on failure:
            # exact -> anytime -> greedy -> reference
            sel, rung = self.ladder.select(
                net, bucket=bkey, warm_start=warm, fuse=self.fuse,
                mesh_axes=self._mesh_axes, banned=banned or None)
            self.counters.add(
                _bucket=bkey, solves=1,
                solve_s=time.perf_counter() - t0,
                warm_solves=int(sel.solver_stats.get("WARM", 0)))
            sp.set(source="solve", rung=rung,
                   warm_dist=sel.solver_stats.get("WARM_DIST", -1))
            self._plans[pkey] = sel
            if self._disk is not None:
                if self.mesh is None:
                    self._disk.put(key, selection_to_payload(sel))
                else:
                    # one writer per mesh (which spans the world, as
                    # make_mesh builds it), after every rank has read the
                    # tier: a rank that read the new file would skip this
                    # solve and its barriers
                    dist.barrier()
                    if dist.get_rank() == 0:
                        self._disk.put(key, selection_to_payload(sel))
                    dist.barrier()
            return sel

    def _nearest_plan(self, pkey: PlanKey) -> Optional[SelectionResult]:
        """Closest already-solved bucket in log-shape space (warm start).

        The batch bucket is one more axis of that space: the N=1
        optimum of the same spatial bucket is usually an excellent
        incumbent for the N=8 solve.
        """
        if not self._plans:
            return None

        def dist(other: PlanKey) -> float:
            return sum(abs(np.log2(a / b)) for a, b in zip(pkey, other))

        return self._plans[min(self._plans, key=dist)]

    # -----------------------------------------------------------------
    # executable tier
    # -----------------------------------------------------------------
    def compiled_for(self, shape_chw: Shape, n: int = 1) -> CompiledNet:
        bshape = bucket_shape(shape_chw, self.policy)
        nb = self.policy.bucket_n(n)
        pkey: PlanKey = (*bshape, nb)
        with self._lock:
            cnet = self._compiled.get(pkey)
            if cnet is not None:
                self.counters.add(exec_hits=1)
                return cnet
            racing = self._building.get(pkey)
            if racing is None:
                fut = Future()
                self._building[pkey] = fut
                self.counters.add(exec_misses=1)
        if racing is not None:
            # another thread is building this bucket: wait, don't duplicate
            return racing.result()
        try:
            with self._lock:
                sel = self._plan_locked(bshape, nb)
            t0 = time.perf_counter()
            # weight packing + capture outside the lock: hot buckets must
            # not stall behind a cold bucket compiling.
            cnet = self._compile_with_retry(sel, bshape, nb)
            with self._lock:
                ev0 = self._compiled.evictions
                self._compiled.put(pkey, cnet)
                self._building.pop(pkey, None)
                self.counters.add(
                    _bucket=bucket_key(bshape, nb),
                    compiles=1, compile_s=time.perf_counter() - t0,
                    mesh_compiles=int(cnet.mesh is not None),
                    exec_evictions=self._compiled.evictions - ev0)
            fut.set_result(cnet)
            return cnet
        except BaseException as exc:
            with self._lock:
                self._building.pop(pkey, None)
            fut.set_exception(exc)
            raise

    def _compile_with_retry(self, sel: SelectionResult, bshape: Shape,
                            nb: int) -> CompiledNet:
        """Compile + warm up (capture) ``sel``, surviving transient
        failures.

        Each attempt (``1 + compile_retries`` total) backs off with
        seeded jitter (:func:`~repro.reliability.retry_call`).  If every
        retry fails the *plan itself* is demoted one-shot down the
        ladder (greedy, then reference) and compiled with the same
        retry budget — a plan that cannot compile must not take the
        bucket down with it.  The fault injector's ``compile`` site
        fires inside each attempt, so chaos runs exercise the real
        retry and demotion paths.  On the card a failure that no
        injector raised is neither retried nor demoted: it reaches the
        caller as it was raised (:meth:`_propagates`).
        """
        bkey = bucket_key(bshape, nb)

        def build(s: SelectionResult) -> CompiledNet:
            if self.fault_injector is not None:
                self.fault_injector.raise_if("compile", key=bkey)
            params = s.net.init_params(self.params_seed)
            # Mesh-sharded compilation only when the plan actually
            # carries sharded (dp/tp/pp) nodes — an all-rep plan on a
            # mesh is just the plain executable.
            mesh = self.mesh if nb > 1 and any(
                ch.placement != "rep" for ch in s.choices.values()) \
                else None
            cnet = compile_plan(s, params, jit=self.jit, batch=nb,
                                device=self.device, mesh=mesh)
            warm_in = np.zeros(bshape if nb == 1 else (nb, *bshape),
                               np.float32)
            # with jit on the card, this call is the capture
            cnet(warm_in)
            cnet.synchronize()
            return cnet

        def guarded(s: SelectionResult) -> CompiledNet:
            try:
                return build(s)
            except Exception as exc:
                if self._propagates(exc):
                    raise _Escape(exc) from None
                raise

        def on_retry(attempt: int, exc: BaseException) -> None:
            self.counters.add(compile_retries=1)

        try:
            try:
                return retry_call(lambda: guarded(sel),
                                  retries=self.compile_retries,
                                  base_delay_s=self.compile_backoff_s,
                                  rng=self._retry_rng, on_retry=on_retry)
            except Exception:
                if sel.strategy == "reference":
                    raise  # already the last rung: nothing to demote to
                self.counters.add(compile_fallbacks=1)
                fb, rung = self._compile_fallback_plan(sel, bkey)
                now = time.perf_counter()
                get_tracer().emit("ladder_demotion", now, now, rung=rung,
                                  bucket=bkey, stage="compile")
                return retry_call(lambda: guarded(fb),
                                  retries=self.compile_retries,
                                  base_delay_s=self.compile_backoff_s,
                                  rng=self._retry_rng, on_retry=on_retry)
        except _Escape as esc:
            raise esc.args[0]

    def _propagates(self, exc: BaseException) -> bool:
        """Whether ``exc`` escapes the ladder: on the card, anything that
        no fault injector raised is the port's own failure (a kernel that
        does not build or launch, a capture that fails), and retrying,
        demoting or quarantining it would hide the card behind library
        routines.  With a mesh the same holds on the CPU: a failed
        collective (ranks that disagree on a plan, a rank gone) must not
        be demoted to a plan that runs without the mesh.  Otherwise
        nothing escapes, as in the reference."""
        return (self.device.type == "cuda" or self.mesh is not None) \
            and not isinstance(exc, InjectedFault)

    def _compile_fallback_plan(self, sel: SelectionResult, bkey: str
                               ) -> Tuple[SelectionResult, str]:
        """Demote a plan that would not compile: greedy, else reference.

        Not persisted to any cache tier — the demotion is scoped to the
        executable being built, so once the transient trouble clears the
        bucket's next (evicted/re-keyed) build compiles the real plan.
        """
        banned = self.quarantine.banned_for(bkey)
        try:
            fb = select_local_optimal(sel.net, self.cost,
                                      banned=banned or None)
            rung = "greedy"
        except Exception:
            fb = reference_selection(sel.net, self.cost)
            rung = "reference"
        self.counters.add(**{f"ladder_{rung}": 1})
        return fb, rung

    def prefetch(self, shape_chw: Shape, n: int = 1) -> Future:
        """Async solve+compile for a bucket (returns a Future[CompiledNet]).

        Misses are resolved on the server's worker pool so the caller's
        latency-sensitive loop never blocks on a cold bucket.  With a
        mesh the work runs on the caller's thread before this returns
        (a done Future): the ranks' collectives must keep request
        order."""
        if self.mesh is None:
            return self._pool.submit(self.compiled_for, shape_chw, n)
        fut: Future = Future()
        try:
            fut.set_result(self.compiled_for(shape_chw, n))
        except Exception as exc:
            fut.set_exception(exc)
        return fut

    def resize_workers(self, n: int) -> None:
        """Retarget the worker pool's concurrency (elastic scaling).

        Called by the continuous-batching scheduler when its
        :class:`~repro.runtime.elastic.ElasticController` observes a
        load shift, so prefetch parallelism tracks the launch slots.
        Growth takes effect on the next submission (the executor spawns
        threads lazily up to its max); shrinking caps new spawns —
        threads already running finish their work and go idle, which is
        the semantics a serving pool wants (never abandon a compile
        mid-flight).
        """
        n = max(1, int(n))
        with self._lock:
            # ThreadPoolExecutor consults _max_workers on every submit;
            # retargeting it is the supported-in-practice resize lever
            # (there is no public API).
            self._pool._max_workers = n

    @property
    def worker_target(self) -> int:
        """Current concurrency target of the worker pool."""
        with self._lock:
            return self._pool._max_workers

    # -----------------------------------------------------------------
    # guarded execution + quarantine
    # -----------------------------------------------------------------
    def _execute_guarded(self, cnet: CompiledNet, xb, bshape: Shape,
                         nb: int
                         ) -> Tuple[Dict[str, np.ndarray], CompiledNet]:
        """Run the executable under the kernel circuit breaker.

        Crashes and non-finite outputs count as kernel failures: the
        culprit primitive is attributed (the injected spec's target, or
        :func:`~repro.reliability.diagnose_nonfinite` for real NaNs) and
        fed to the quarantine.  A *tripped* breaker evicts the bucket's
        plan + executable, re-solves with the culprit banned (warm-
        started from the poisoned plan), recompiles, and retries the
        request — up to ``kernel_retries`` times — so the caller gets a
        correct answer from the degraded plan instead of an error.  An
        unattributable failure re-raises: retrying the identical plan
        would loop.  On the card only injected faults and non-finite
        outputs take this path: an executable that raises there raises
        to the caller (:meth:`_propagates`).  Returns ``(outputs, executable)``; the executable
        may differ from the argument after a quarantine re-solve.
        """
        if not self.guard_outputs and self.fault_injector is None:
            return _to_host(cnet(xb)), cnet
        bkey = bucket_key(bshape, nb)
        attempts = 0
        while True:
            out: Optional[Dict[str, np.ndarray]] = None
            failure: Optional[BaseException] = None
            culprit: Optional[str] = None
            try:
                out = _to_host(cnet(xb))
            except Exception as exc:
                if self._propagates(exc):
                    raise
                failure = exc
            if self.fault_injector is not None:
                # keyed on bucket + the plan's conv primitives so a
                # spec's ``match`` can target one primitive by name
                prims = sorted({ch.primitive.name
                                for ch in cnet.sel.choices.values()
                                if ch.primitive is not None})
                spec = self.fault_injector.check(
                    "kernel", key=f"{bkey}|{','.join(prims)}")
                if spec is not None:
                    culprit = next(
                        (p for p in prims if spec.match in p), None) \
                        if spec.match else (prims[0] if prims else None)
                    if spec.kind == "delay":
                        time.sleep(spec.value)
                        culprit = None
                    elif spec.kind == "nan" and out is not None:
                        out = {nid: np.full_like(v, np.nan)
                               for nid, v in out.items()}
                    else:
                        failure = InjectedFault("kernel", spec.kind,
                                                culprit or bkey)
                        out = None
            if out is not None:
                if not self.guard_outputs:
                    return out, cnet
                with span("guard"):
                    finite = all(np.isfinite(v).all() for v in out.values())
                if finite:
                    return out, cnet
                failure = KernelFailure(bkey, culprit,
                                        "non-finite outputs")
            # ---- failure path ----
            self.counters.add(kernel_failures=1)
            if culprit is None:
                culprit = diagnose_nonfinite(cnet, xb)
            tripped = culprit is not None and \
                self._quarantine_bucket(bshape, nb, culprit)
            attempts += 1
            if not tripped or attempts > self.kernel_retries:
                if failure is not None:
                    raise failure
                raise KernelFailure(bkey, culprit)
            # the trip rotated the bucket's cache key and evicted its
            # plan + executable: this re-solves (culprit banned, warm-
            # started from the poisoned plan), recompiles, and retries
            cnet = self.compiled_for(bshape, n=nb)

    def _quarantine_bucket(self, bshape: Shape, nb: int,
                           primitive: str) -> bool:
        """Record a kernel failure; on a breaker trip evict the bucket.

        The plan tier and executable LRU are keyed on the raw
        (bucket, batch) pair — they never see the quarantine token — so
        the trip must evict them explicitly.  The evicted plan is
        stashed as the warm-start incumbent for the banned re-solve.
        """
        pkey: PlanKey = (*bshape, nb)
        bkey = bucket_key(bshape, nb)
        tripped = self.quarantine.record_failure(primitive, bkey)
        if tripped:
            with self._lock:
                old = self._plans.pop(pkey, None)
                if old is not None:
                    self._quar_warm[pkey] = old
                self._compiled.pop(pkey)
            self.counters.add(quarantines=1)
            now = time.perf_counter()
            get_tracer().emit("quarantine", now, now,
                              primitive=primitive, bucket=bkey)
        return tripped

    def release_quarantine(self, primitive: str, shape_chw: Shape,
                           n: int = 1) -> bool:
        """Lift a quarantine for the shape's bucket (half-open retry).

        Evicts the bucket's in-memory tiers so the next request
        re-keys — with the quarantine set empty again the rotation
        token vanishes and the bucket's *original* disk plan is a hit.
        Returns True if a quarantine was actually lifted.
        """
        bshape = bucket_shape(shape_chw, self.policy)
        nb = self.policy.bucket_n(n)
        if not self.quarantine.release(primitive,
                                       bucket_key(bshape, nb)):
            return False
        with self._lock:
            self._plans.pop((*bshape, nb), None)
            self._compiled.pop((*bshape, nb))
            self._quar_warm.pop((*bshape, nb), None)
        return True

    # -----------------------------------------------------------------
    # output cropping
    # -----------------------------------------------------------------
    def _expected_out_shapes(self, req_shape: Shape) -> Dict[str, tuple]:
        """Output-node shapes of the net built at the *request* shape.

        The request is zero-padded into its bucket, so bucket-run
        outputs that keep spatial extent must be cropped back to what a
        run at the request shape would produce.  Building the net is
        pure graph math (no tracing/compiling); a small LRU memoizes it
        per request shape.
        """
        with self._lock:
            got = self._out_shapes.get(req_shape)
        if got is not None:
            return got
        net = self.net_builder(req_shape)
        shapes = {nid: tuple(net.nodes[nid].out_shape)
                  for nid in net.outputs()}
        with self._lock:
            self._out_shapes.put(req_shape, shapes)
        return shapes

    @staticmethod
    def _crop(v: np.ndarray, expected: tuple) -> np.ndarray:
        """Crop a bucket-run output down to the request's extent.

        Only applies when the ranks line up and every expected dim fits
        inside the actual one — global ops (GAP, FC) already produce
        request-independent shapes and pass through untouched.
        """
        if v.ndim != len(expected):
            return v
        if all(a == e for a, e in zip(v.shape, expected)):
            return v
        if any(e > a for a, e in zip(v.shape, expected)):
            return v
        return v[tuple(slice(0, e) for e in expected)]

    # -----------------------------------------------------------------
    # request paths
    # -----------------------------------------------------------------
    def infer(self, x_chw: np.ndarray) -> Dict[str, np.ndarray]:
        """Execute one request: bucket, pad, run, crop, return outputs."""
        x = np.asarray(x_chw, np.float32)
        if x.ndim != 3:
            raise ValueError(f"expected (C, H, W) input, got {x.shape}")
        with span("infer") as sp:
            if sp is not NULL_SPAN:
                sp.set(shape="x".join(map(str, x.shape)))
            with span("lookup"):
                cnet = self.compiled_for(x.shape)
                bshape = bucket_shape(x.shape, self.policy)
                bkey = bucket_key(bshape, cnet.batch)
                expected = self._expected_out_shapes(x.shape)
            with span("pad"):
                pads = [(0, b - s) for b, s in zip(bshape, x.shape)]
                xb = np.pad(x, pads)
                if cnet.batch > 1:
                    # a policy whose batch bucket for n=1 is > 1 (linear
                    # batch mode, min_n > 1) hands the single request a
                    # batched executable: embed the image as row 0, zero
                    # rows pad
                    xb = np.concatenate(
                        [xb[None], np.zeros((cnet.batch - 1, *bshape),
                                            np.float32)])
            t0 = time.perf_counter()
            with span("execute", bucket=bkey):
                out, cnet = self._execute_guarded(cnet, xb, bshape,
                                                  cnet.batch)
            with span("crop"):
                out = {nid: self._crop(
                           v[0] if cnet.batch > 1 else v,
                           expected.get(nid, ()))
                       for nid, v in out.items()}
            self.counters.add(_bucket=bkey, requests=1,
                              execute_s=time.perf_counter() - t0)
            self._layout_copies.add(cnet.layout_copy_bytes)
            return out

    def infer_batch(self, xs: Sequence[np.ndarray]
                    ) -> List[Dict[str, np.ndarray]]:
        """Execute a batch of requests, one executable call per bucket.

        Requests group by spatial bucket; each group (chunked at
        ``policy.max_n``) is stacked into a zero-padded (N', C', H', W')
        tensor — N' the group's pow2 batch bucket — and runs through the
        batched executable in ONE invocation.  Per-request outputs are
        sliced off the batch axis and cropped exactly like
        :meth:`infer`, so ``infer_batch(xs)[i] == infer(xs[i])`` up to
        float reassociation.  Returns one output dict per request, in
        input order.
        """
        imgs = [np.asarray(x, np.float32) for x in xs]
        for x in imgs:
            if x.ndim != 3:
                raise ValueError(f"expected (C, H, W) inputs, got {x.shape}")
        if not imgs:
            return []
        with span("infer_batch", requests=len(imgs)) as sp:
            return self._infer_batch_traced(imgs, sp)

    def _infer_batch_traced(self, imgs: List[np.ndarray], sp
                            ) -> List[Dict[str, np.ndarray]]:
        groups: "OrderedDict[Shape, List[int]]" = OrderedDict()
        for i, x in enumerate(imgs):
            groups.setdefault(bucket_shape(x.shape, self.policy),
                              []).append(i)
        chunks: List[Tuple[Shape, int, List[int]]] = []
        for bshape, idxs in groups.items():
            for start in range(0, len(idxs), self.policy.max_n):
                chunk = idxs[start:start + self.policy.max_n]
                chunks.append((bshape, self.policy.bucket_n(len(chunk)),
                               chunk))
        # overlap cold solves+compiles of *distinct* (bucket, batch)
        # executables on the worker pool: a flush spanning G cold
        # groups then waits for the slowest compile, not the sum.  A
        # mesh server takes them in request order on this thread.
        specs = {(bshape, nb) for bshape, nb, _ in chunks}
        prefetched = {spec: self.prefetch(*spec) for spec in specs} \
            if len(specs) > 1 and self.mesh is None else {}
        results: List[Optional[Dict[str, np.ndarray]]] = [None] * len(imgs)
        seen_specs = set()
        for bshape, nb, chunk in chunks:
            with span("lookup"):
                if prefetched:
                    cnet = prefetched[(bshape, nb)].result()
                    if (bshape, nb) in seen_specs:
                        # the sequential path would have taken an LRU
                        # hit here; keep the counters path-independent
                        self.counters.add(exec_hits=1)
                    seen_specs.add((bshape, nb))
                else:
                    cnet = self.compiled_for(bshape, n=nb)
                bkey = bucket_key(bshape, nb)
            with span("stack"):
                xb = np.zeros((nb, *bshape), np.float32)
                for row, i in enumerate(chunk):
                    x = imgs[i]
                    xb[row, :x.shape[0], :x.shape[1], :x.shape[2]] = x
            t0 = time.perf_counter()
            with span("execute", bucket=bkey, coalesced=len(chunk)):
                out, cnet = self._execute_guarded(
                    cnet, xb if nb > 1 else xb[0], bshape, nb)
            # coalesced counts per *invocation*: requests that
            # shared this executable call with at least one other
            self.counters.add(_bucket=bkey, batch_calls=1,
                              coalesced=len(chunk) - 1,
                              execute_s=time.perf_counter() - t0)
            self._layout_copies.add(cnet.layout_copy_bytes)
            with span("crop"):
                for row, i in enumerate(chunk):
                    expected = self._expected_out_shapes(imgs[i].shape)
                    results[i] = {
                        nid: self._crop(v[row] if nb > 1 else v,
                                        expected.get(nid, ()))
                        for nid, v in out.items()}
        self.counters.add(requests=len(imgs))
        sp.set(invocations=len(chunks))
        return results  # type: ignore[return-value]

    # -----------------------------------------------------------------
    # micro-batching admission queue
    # -----------------------------------------------------------------
    def enqueue(self, x_chw: np.ndarray) -> Future:
        """Queue one image for the next :meth:`flush`; returns a Future
        resolving to its output dict (same payload as :meth:`infer`)."""
        x = np.asarray(x_chw, np.float32)
        if x.ndim != 3:
            raise ValueError(f"expected (C, H, W) input, got {x.shape}")
        fut: Future = Future()
        with self._lock:
            if self._closed:
                # after close() no flush will ever run: a silently
                # queued future would hang its waiter forever
                raise RuntimeError("PlanServer is closed")
            self._queue.append((x, fut, time.perf_counter()))
        return fut

    def flush(self) -> int:
        """Coalesce everything enqueued into batched executable calls.

        All pending same-bucket images share one tower invocation
        (:meth:`infer_batch`); each Future resolves with its request's
        cropped outputs.  Returns the number of requests served.
        """
        with self._lock:
            pending, self._queue = self._queue, []
        if not pending:
            return 0
        with get_tracer().span("flush", requests=len(pending)):
            # queue wait: enqueue() timestamp to the moment the flush
            # drained it — opened and closed on different call stacks,
            # so it is emitted from explicit timestamps, parented here
            t_drain = time.perf_counter()
            tracer = get_tracer()
            for _, _, t_enq in pending:
                tracer.emit("queue_wait", t_enq, t_drain)
            try:
                outs = self.infer_batch([x for x, _, _ in pending])
            except BaseException as exc:
                for _, fut, _ in pending:
                    fut.set_exception(exc)
                raise
            for (_, fut, _), out in zip(pending, outs):
                fut.set_result(out)
            return len(pending)

    # -----------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        d = self.counters.snapshot()
        d["buckets"] = len(self._plans)
        d["live_executables"] = len(self._compiled)
        #: active circuit-breaker entries, as "primitive@bucket" strings
        d["quarantined"] = [f"{p}@{b}"
                            for p, b in self.quarantine.active()]
        if self._disk is not None:
            d["disk_plans"] = len(self._disk)
        #: histogram-backed latency percentiles per phase — entries
        #: like "execute[bucket=8x3x32x32]" split them per batch bucket
        d["phases"] = self.counters.phase_quantiles()
        d["layout_copy_bytes"] = self._layout_copies.value
        #: each live executable's plan by its bucket: what one forward
        #: copies outside the convs, its kernel launches and the
        #: selection's predicted ms (``CompiledNet``'s fields)
        with self._lock:
            live = list(self._compiled._d.items())
        d["plans"] = {bucket_key(pkey[:3], pkey[3]): _plan_stats(cnet)
                      for pkey, cnet in live}
        return d

    def metrics_text(self) -> str:
        """Prometheus text exposition of this server's registry."""
        return self.counters.registry.prometheus_text()

    def close(self) -> None:
        # Drain the admission queue: enqueued-but-unflushed futures
        # would otherwise never resolve and their waiters would hang.
        # The closed flag makes a racing enqueue() raise instead of
        # landing a future in a queue nobody will ever flush.
        with self._lock:
            self._closed = True
            pending, self._queue = self._queue, []
        for _, fut, _ in pending:
            fut.cancel()
        self._pool.shutdown(wait=True)


class _Escape(BaseException):
    """Carries a failure that must reach the caller past
    :func:`~repro_torch.reliability.retry_call`, which retries every
    ``Exception``; ``args[0]`` is the failure."""


def _plan_stats(cnet: CompiledNet) -> Dict:
    return {"batch": cnet.batch, "joins": cnet.joins,
            "join_bytes": cnet.join_bytes,
            "conversion_steps": cnet.conversion_steps,
            "conversion_bytes": cnet.conversion_bytes,
            "launches": dict(cnet.launches or {}),
            "predicted_ms": cnet.predicted_ms}


def _to_host(outs) -> Dict[str, np.ndarray]:
    """An executable's outputs as numpy arrays (span ``copy_out``; each
    copy waits for the stream that produced it).  While tracing, the
    wait on a card is made first and on its own (span ``device_wait``)."""
    if tracing():
        dev = next((v.device for v in outs.values() if v.is_cuda), None)
        if dev is not None:
            with span("device_wait"):
                torch.cuda.current_stream(dev).synchronize()
    with span("copy_out"):
        return {nid: v.detach().cpu().numpy() for nid, v in outs.items()}
