"""Per-(primitive, bucket) circuit breaker for crashing/NaN kernels.

A compiled kernel that crashes or emits non-finite values must not be
re-selected by the very solve that made it optimal — the cost model
knows speed, not health.  :class:`PrimitiveQuarantine` tracks failures
per (primitive name, bucket key); at ``threshold`` failures the pair
trips into quarantine, after which

* the primitive is **priced infinite** in that bucket's choice space
  (``select_pbqp(..., banned=quarantine.banned_for(bucket))`` — see
  :func:`repro.core.selection._conv_domain`), and
* the bucket's **cache keys rotate**: :meth:`version_token` folds the
  active quarantine set into the cost-version string every plan-cache
  tier keys on, so the poisoned plan evicts exactly like a stale
  cost model does in the drift workflow (the same rotation
  mechanism, reused).  Releasing the quarantine rotates back — if the set returns
  to empty the token is ``""`` and the original on-disk plan becomes a
  cache *hit* again, which is the recovery path the chaos benchmark
  demonstrates end to end.

The breaker holds no references into the server; the server drives it
(record failure -> evict its in-memory tiers -> warm-start re-solve).

:func:`diagnose_nonfinite` is the attribution tool for *real* NaN
failures: a per-node re-execution of the compiled plan's own makers
(the walk :class:`repro.obs.drift.InstrumentedNet` rebuilds, minus the
timing) that returns the first conv primitive producing non-finite
output from finite input.

Port of the reference's module: the breaker is its plain Python, and
the attribution walk runs the batch as a leading axis through the
executable's makers, eagerly (never through a captured CUDA graph),
checking ``torch.isfinite``.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["PrimitiveQuarantine", "diagnose_nonfinite"]


class PrimitiveQuarantine:
    """Thread-safe circuit-breaker state: failures, trips, releases."""

    def __init__(self, threshold: int = 1) -> None:
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = int(threshold)
        self._failures: Dict[Tuple[str, str], int] = {}
        #: (primitive, bucket) -> epoch at which the breaker tripped
        self._active: Dict[Tuple[str, str], int] = {}
        self._epoch = 0
        self._lock = threading.Lock()

    # -----------------------------------------------------------------
    def record_failure(self, primitive: str, bucket: str) -> bool:
        """Count one failure; True if this call trips the breaker."""
        with self._lock:
            k = (primitive, bucket)
            n = self._failures.get(k, 0) + 1
            self._failures[k] = n
            if n >= self.threshold and k not in self._active:
                self._epoch += 1
                self._active[k] = self._epoch
                return True
            return False

    def release(self, primitive: str, bucket: str) -> bool:
        """Half-open the breaker: allow the primitive again.

        Clears the failure count too, so the next failure must re-earn
        the threshold.  Returns True if a quarantine was actually
        lifted (the bucket's cache keys rotate again as a result).
        """
        with self._lock:
            k = (primitive, bucket)
            self._failures.pop(k, None)
            return self._active.pop(k, None) is not None

    # -----------------------------------------------------------------
    def is_quarantined(self, primitive: str, bucket: str) -> bool:
        with self._lock:
            return (primitive, bucket) in self._active

    def banned_for(self, bucket: str) -> FrozenSet[str]:
        """Primitive names quarantined in this bucket (solver ban set)."""
        with self._lock:
            return frozenset(p for (p, b) in self._active if b == bucket)

    def active(self) -> List[Tuple[str, str]]:
        """All (primitive, bucket) pairs currently quarantined."""
        with self._lock:
            return sorted(self._active)

    def version_token(self, bucket: str) -> str:
        """Cache-key suffix for this bucket's plan keys.

        Deterministic digest of the bucket's active quarantine entries
        (primitive + trip epoch).  Empty when nothing is quarantined —
        so a fully-recovered bucket keys back onto its original plans.
        """
        with self._lock:
            items = sorted((p, e) for (p, b), e in self._active.items()
                           if b == bucket)
        if not items:
            return ""
        digest = hashlib.sha256(repr(items).encode()).hexdigest()[:8]
        return f"+quar={digest}"


# ----------------------------------------------------------------------
def diagnose_nonfinite(cnet, x) -> Optional[str]:
    """Blame the first kernel producing non-finite output from finite input.

    Re-executes the compiled plan node by node with its own makers
    (conversion chains materialized between), eagerly on the
    executable's device, checking every conv node's output for NaN/Inf.
    Returns that node's primitive name, or None when the failure cannot
    be pinned on a single conv kernel (non-finite *input*, an op node,
    or a plan compiled without makers / with a mesh — attribution needs
    the single-device walk).  On the card a walk that raises re-raises:
    an exception there is the port's own failure, not a kernel's wrong
    answer to quarantine.  On the CPU it blames the conv being run, as
    the reference does.
    """
    from ..core.layouts import LAYOUT_BY_NAME
    from ..core.primitives import convert_layout

    if cnet.mesh is not None or not cnet.makers:
        return None
    sel, params = cnet.sel, cnet.params
    net = sel.net
    x = x if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(x))
    x = x.to(cnet.device)
    if cnet.batch == 1:
        x = x.unsqueeze(0)  # the walk carries a leading batch axis
    if not bool(torch.isfinite(x).all()):
        return None

    vals = {}
    cur = None
    try:
        for nid in net.order:
            cur = nid
            node = net.nodes[nid]
            if node.kind == "input":
                vals[nid] = x
                continue
            ins = []
            for src in node.inputs:
                v = vals[src]
                chain = sel.conversions.get((src, nid))
                if chain:
                    for a, b in zip(chain, chain[1:]):
                        v = convert_layout(v, a, b)
                ins.append(v)
            if node.kind == "conv":
                out = cnet.makers[nid](ins[0], params[nid])
                if not bool(torch.isfinite(out).all()):
                    return sel.choices[nid].primitive.name \
                        if sel.choices[nid].primitive else None
            else:
                layout = LAYOUT_BY_NAME[sel.choices[nid].l_in]
                out = node.op.fn(ins, layout, params.get(nid))
                if not bool(torch.isfinite(out).all()):
                    return None  # an op node went bad: not a kernel
            vals[nid] = out
    except Exception:
        if cnet.device.type == "cuda":
            raise
        # the walk itself crashed: blame the node being executed, if it
        # was a conv kernel
        node = net.nodes.get(cur) if cur is not None else None
        if node is not None and node.kind == "conv":
            ch = sel.choices[cur]
            return ch.primitive.name if ch.primitive else None
        return None
    return None
