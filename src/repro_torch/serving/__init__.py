"""Plan-cache serving subsystem of the port.

Amortizes the two per-scenario costs the paper pays offline — the PBQP
solve and building the executable — across a *stream* of request
shapes:

* :mod:`.bucketing`  — canonicalize shapes (and batch sizes) into a
  bounded bucket set;
* :mod:`.plan_cache` — persistent selections + compiled-executable LRU;
* :mod:`.server`     — the per-request :class:`PlanServer` dispatcher
  (bucket -> cache lookup -> (miss) warm-started solve + compile, a
  CUDA graph's capture on the card -> execute), the batched
  :meth:`PlanServer.infer_batch` path and the micro-batching admission
  queue, with hit/miss/latency counters in :mod:`.metrics`;
* :mod:`.towers`     — shape-parameterized demo nets for tests/examples.

``bucketing``, ``metrics``, ``plan_cache`` and ``towers`` are verbatim
copies of the reference's.  The reference also exports
``ContinuousScheduler``; it is not ported yet: its default
``ElasticController`` is built on the LM stack's sharding rules
(``models/sharding.py``), which come with the ROADMAP's slice F.
"""
from .bucketing import (
    BucketPolicy, bucket_key, bucket_scenario, bucket_shape, round_dim,
)
from .metrics import ServingCounters
from .plan_cache import (
    LRU, PlanDiskCache, plan_key, selection_from_payload,
    selection_to_payload,
)
from .server import PlanServer
from .towers import (bottleneck_tower, conv_stack, conv_tower,
                     uniform_stack)

__all__ = [
    "BucketPolicy", "bucket_key", "bucket_shape", "bucket_scenario",
    "round_dim",
    "ServingCounters",
    "LRU", "PlanDiskCache", "plan_key",
    "selection_from_payload", "selection_to_payload",
    "PlanServer", "conv_tower", "conv_stack", "bottleneck_tower",
    "uniform_stack",
]
