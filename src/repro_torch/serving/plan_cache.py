"""Persistent plan cache: PBQP selections on disk, executables in memory.

Two tiers with very different economics:

* **Disk tier** — a :class:`SelectionResult` is a few hundred bytes of
  JSON (per-node primitive names + layouts + conversion chains).  It is
  keyed by ``(net fingerprint, bucket key, cost-model version)`` hashed
  into a file name, so a changed network, a different bucket, or a bumped
  cost model each miss cleanly instead of serving a stale plan.

* **Memory tier** — compiled executables (:class:`~repro.core.plan.
  CompiledNet`) hold XLA programs and packed weights; they are *not*
  serializable and are the expensive artifact.  A small LRU
  (:class:`LRU`) bounds live executables while hot buckets stay resident.

The JSON payload stores primitive *names*; deserialization resolves them
against the live registry and fails loudly (``KeyError``) if a plan
references a primitive that no longer exists — which is exactly the
cost-model-version bump case the key is meant to prevent.
"""
from __future__ import annotations

import hashlib
import json
import logging
import pathlib
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.graph import Net
from ..core.ioutil import atomic_write_text
from ..core.primitives import registry
from ..core.selection import Choice, Placement, SelectionResult

__all__ = ["PLAN_SCHEMA", "plan_key", "selection_to_payload",
           "selection_from_payload", "PlanDiskCache", "LRU"]

#: bump when the payload format below changes shape
#: 2: per-edge fused realizations ("fusions") joined the payload; v1
#:    plans predate fused-edge pricing and must re-solve
#: 3: per-node device placements joined the choices (the unified
#:    choice-space mesh axis); v2 plans predate placement solving
#: 4: placements grew structure — tp and pp<stage> joined {dp, rep}
#:    and round-trip as their canonical strings; v3 plans were solved
#:    over the two-kind domain and must re-solve
PLAN_SCHEMA = 4


def plan_key(net_fingerprint: str, bucket_key: str,
             cost_version: str) -> str:
    """Cache key: every component that could change the optimal plan."""
    raw = f"{PLAN_SCHEMA}|{net_fingerprint}|{bucket_key}|{cost_version}"
    return hashlib.sha256(raw.encode()).hexdigest()[:24]


# ----------------------------------------------------------------------
# SelectionResult <-> JSON
# ----------------------------------------------------------------------
def selection_to_payload(sel: SelectionResult) -> Dict[str, Any]:
    return {
        "schema": PLAN_SCHEMA,
        "choices": {
            nid: [ch.primitive.name if ch.primitive else None,
                  ch.l_in, ch.l_out, ch.placement]
            for nid, ch in sel.choices.items()},
        "conversions": [[src, dst, chain]
                        for (src, dst), chain in sel.conversions.items()],
        "fusions": [[src, dst, kind]
                    for (src, dst), kind in sel.fusions.items()],
        "predicted_cost": sel.predicted_cost,
        "optimal": sel.optimal,
        "strategy": sel.strategy,
        "solver_stats": dict(sel.solver_stats),
    }


def selection_from_payload(payload: Dict[str, Any],
                           net: Net) -> SelectionResult:
    if payload.get("schema") != PLAN_SCHEMA:
        raise ValueError(f"plan schema {payload.get('schema')} != "
                         f"{PLAN_SCHEMA}")
    by_name = {p.name: p for p in registry()}
    choices: Dict[str, Choice] = {}
    for nid, (pname, l_in, l_out, placement) in payload["choices"].items():
        prim = by_name[pname] if pname is not None else None
        # placements persist as canonical strings ("rep", "dp", "tp",
        # "pp<stage>"); parse restores the structured form
        choices[nid] = Choice(prim, l_in, l_out,
                              Placement.parse(str(placement)))
    conversions: Dict[Tuple[str, str], List[str]] = {
        (src, dst): list(chain)
        for src, dst, chain in payload["conversions"]}
    fusions: Dict[Tuple[str, str], str] = {
        (src, dst): str(kind)
        for src, dst, kind in payload["fusions"]}
    return SelectionResult(
        net=net, choices=choices, conversions=conversions,
        predicted_cost=float(payload["predicted_cost"]),
        optimal=bool(payload["optimal"]),
        strategy=str(payload["strategy"]),
        solver_stats={k: int(v)
                      for k, v in payload["solver_stats"].items()},
        fusions=fusions)


# ----------------------------------------------------------------------
_log = logging.getLogger(__name__)


class PlanDiskCache:
    """One JSON file per plan under ``root``; atomic writes.

    A truncated/corrupt file or a stale-schema payload is a *miss*, not
    an error: the bad file is logged, deleted, counted in ``corrupt``
    (and surfaced via ``on_corrupt`` into the server's
    ``plan_cache_corrupt`` counter), and the caller re-solves — a torn
    write or a bit flip must never take down the request path.

    ``fault_injector`` (site ``plan_cache``, kind ``corrupt``) truncates
    the real file on disk just before the read, so chaos tests exercise
    exactly this recovery path, not a simulation of it.
    """

    def __init__(self, root, *,
                 on_corrupt: Optional[Callable[[str], None]] = None,
                 fault_injector=None) -> None:
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.corrupt = 0
        self.on_corrupt = on_corrupt
        self.fault_injector = fault_injector

    def _path(self, key: str) -> pathlib.Path:
        return self.root / f"plan_{key}.json"

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        p = self._path(key)
        if self.fault_injector is not None and p.exists():
            spec = self.fault_injector.check("plan_cache", key=key)
            if spec is not None and spec.kind == "corrupt":
                try:
                    raw = p.read_text()
                    p.write_text(raw[: len(raw) // 2])
                except OSError:
                    pass
        if not p.exists():
            self.misses += 1
            return None
        try:
            payload = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError) as exc:
            return self.discard(key, f"unreadable JSON ({exc})")
        if not isinstance(payload, dict) \
                or payload.get("schema") != PLAN_SCHEMA:
            got = payload.get("schema") if isinstance(payload, dict) \
                else type(payload).__name__
            return self.discard(key, f"schema {got!r} != {PLAN_SCHEMA}")
        self.hits += 1
        return payload

    def discard(self, key: str, why: str) -> None:
        """Treat the entry as corrupt: log, delete, count, miss."""
        _log.warning("plan cache entry %s corrupt (%s): deleting, "
                     "will re-solve", key, why)
        try:
            self._path(key).unlink()
        except OSError:
            pass
        self.corrupt += 1
        self.misses += 1
        if self.on_corrupt is not None:
            self.on_corrupt(key)
        return None

    def put(self, key: str, payload: Dict[str, Any]) -> None:
        """Atomic write, safe under concurrent writers of the same key
        (writer-unique tmp names — see ``core.ioutil.atomic_write_text``;
        both writers produce equivalent payloads for the same key, so
        last-replace-wins is correct)."""
        atomic_write_text(self._path(key), json.dumps(payload))

    def __len__(self) -> int:
        return len(list(self.root.glob("plan_*.json")))


# ----------------------------------------------------------------------
class LRU:
    """Tiny ordered-dict LRU for compiled executables."""

    def __init__(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._d: "OrderedDict[Any, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key):
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return None

    def put(self, key, value) -> None:
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = value
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def pop(self, key):
        """Drop an entry without touching the hit/miss counters (the
        quarantine eviction path: a poisoned executable must not linger
        until capacity pressure finds it)."""
        return self._d.pop(key, None)

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)
