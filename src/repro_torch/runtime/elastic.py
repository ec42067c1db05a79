"""Elastic scaling: re-mesh on fleet changes, resize workers on load.

Port of the reference's ``runtime/elastic.py``.

Two elasticity axes live here:

* **Device elasticity** — on a real cluster the coordinator advertises
  the healthy device set; when it changes (node failure, capacity
  grant) the controller rebuilds the mesh + sharding rules for the new
  shape: ``make_mesh(n)`` returns a ``DeviceMesh`` over the ``n`` ranks
  of the world (:func:`repro_torch.launch.mesh.make_mesh`), and the plan
  shards the LM over it (:class:`~repro_torch.models.sharding.
  ShardingPlan`).  The device count is the default process group's
  world size (1 without one), where the reference counts
  ``jax.devices()``.

* **Worker elasticity** — the serving side: the continuous-batching
  scheduler (:mod:`repro_torch.serving.scheduler`) asks
  :meth:`ElasticController.desired_workers` for a concurrency target
  each dispatch round.  Backlog per worker above ``scale_up_backlog``
  grows the pool one worker at a time (immediately — queueing delay is
  what SLOs die of); sustained calm (``cooldown`` consecutive
  observations below ``scale_down_backlog``) shrinks it, so a burst
  does not flap the pool.  The scheduler applies the target to its
  launch slots and mirrors it into :meth:`~repro.serving.server.
  PlanServer.resize_workers` so prefetch parallelism tracks load too.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from ..models.sharding import Rules, ShardingPlan

__all__ = ["ElasticController"]


@dataclass
class ElasticController:
    """Tracks the device pool and the serving worker pool.

    ``current()`` yields (mesh, plan, changed) per generation for the
    training path; ``desired_workers()`` is the serving-side policy.
    Both bump ``generation`` when they change the world, so callers can
    cheaply detect "something resized since I last looked".
    """

    make_mesh: Optional[Callable[[int], object]] = None  # n_devices -> Mesh
    make_rules: Optional[Callable[[Dict[str, int]], Rules]] = None
    generation: int = 0
    #: worker-pool bounds for :meth:`desired_workers`
    min_workers: int = 1
    max_workers: int = 4
    #: queued+inflight work per worker that triggers a scale-up
    scale_up_backlog: float = 2.0
    #: backlog per worker below which an observation counts as "calm"
    scale_down_backlog: float = 0.5
    #: consecutive calm observations required before scaling down
    cooldown: int = 3
    _last_n: Optional[int] = None
    _workers: int = 0
    _calm: int = 0

    def __post_init__(self) -> None:
        if self.min_workers < 1 or self.max_workers < self.min_workers:
            raise ValueError(
                f"bad worker bounds [{self.min_workers}, "
                f"{self.max_workers}]")
        if not self._workers:
            self._workers = self.min_workers

    # -----------------------------------------------------------------
    # device elasticity (training / mesh path)
    # -----------------------------------------------------------------
    def current(self) -> Tuple[object, ShardingPlan, bool]:
        """Returns (mesh, plan, changed)."""
        if self.make_mesh is None or self.make_rules is None:
            raise RuntimeError(
                "ElasticController.current() needs make_mesh/make_rules "
                "(this controller was built for worker elasticity only)")
        import torch.distributed as dist

        n = dist.get_world_size() if dist.is_initialized() else 1
        changed = self._last_n is not None and n != self._last_n
        if changed:
            self.generation += 1
        self._last_n = n
        mesh = self.make_mesh(n)
        names = tuple(mesh.mesh_dim_names)
        shape = {a: int(s) for a, s in zip(names, mesh.mesh.shape)}
        rules = self.make_rules(shape).restrict(names)
        return mesh, ShardingPlan(mesh=mesh, rules=rules), changed

    # -----------------------------------------------------------------
    # worker elasticity (serving path)
    # -----------------------------------------------------------------
    @property
    def workers(self) -> int:
        """Current worker-pool target (between min/max bounds)."""
        return self._workers

    def desired_workers(self, queued: int, inflight: int) -> int:
        """One observation of load -> the new worker-pool target.

        ``queued`` is work waiting to be launched, ``inflight`` work
        already running.  Scale-up is immediate (one worker per call —
        the caller polls every dispatch round, so a sustained burst
        ramps to ``max_workers`` in a few rounds); scale-down waits for
        ``cooldown`` consecutive calm observations so a gap between
        bursts does not thrash the pool.
        """
        pressure = (queued + inflight) / max(self._workers, 1)
        if pressure > self.scale_up_backlog:
            self._calm = 0
            if self._workers < self.max_workers:
                self._workers += 1
                self.generation += 1
        elif pressure < self.scale_down_backlog:
            self._calm += 1
            if self._calm >= self.cooldown and \
                    self._workers > self.min_workers:
                self._workers -= 1
                self.generation += 1
                self._calm = 0
        else:
            self._calm = 0
        return self._workers
