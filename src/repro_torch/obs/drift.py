"""Predicted-vs-observed cost drift detection for compiled plans, on
PyTorch (port of the reference's ``obs/drift.py``).

The PBQP optimum is only as good as the cost model it was solved
against.  This module closes that loop:

* :class:`InstrumentedNet` — an instrumented execution mode for a
  :class:`~repro_torch.core.plan.CompiledNet`: the eager walk the plain
  executable runs (``jit=False``: the same kernels in the same order,
  never the captured graph), with every node and every layout-conversion
  chain timed on its own.  Per-node observed seconds come out of every
  call; outputs are the eager walk's bits.
* :func:`plan_predictions` — the exact per-node and per-edge costs the
  solver's objective summed for a plan.
* :class:`DriftDetector` — per (node, primitive, layout, bucket) entry:
  EWMA of the observed time and of ``log(observed / predicted)`` (the
  *drift score*); entries whose |score| exceeds ``log(threshold)`` are
  flagged, and :meth:`DriftDetector.recalibrate` writes their observed
  EWMAs back into a :class:`~repro_torch.calibrate.HardwareProfile` —
  ONLY the flagged entries — which changes the profile's content hash
  and therefore the :class:`~repro_torch.calibrate.CalibratedCostModel`
  version, invalidating every cached plan priced by the stale numbers.

``plan_predictions``, ``DriftEntry``, ``DriftDetector``,
``RestrictedCostModel`` and ``recalibration_loop`` keep the reference's
logic.  The clock is the port's own: the profile's entries come from
``core.costs.time_callable``, the host clock around calls that each end
in a device synchronisation, so :class:`InstrumentedNet` times each step
the same way (host clock, then ``torch.cuda.synchronize``).  Device time
from CUDA events would be held against host-clock prices and flag every
small operator, whose host dispatch is most of its price.

The whole-plan comparison uses the *modeled* total — conv kernels plus
mismatched-edge transforms, the terms the objective actually contains.
Op nodes (relu, pool, ...) are the paper's zero-cost dummy nodes; their
observed time is reported separately as ``unmodeled_s`` so it can never
masquerade as kernel drift.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.costs import CostModel, prim_cost_key, transform_cost_key
from ..core.layouts import LAYOUT_BY_NAME
from ..core.plan import CompiledNet, _tensor
from ..core.primitives import convert_layout
from ..core.selection import Placement, PlacementPricing, SelectionResult
from ..kernels.common import true_f32
from ..serving.bucketing import BucketPolicy, bucket_scenario

__all__ = ["InstrumentedNet", "plan_predictions", "DriftEntry",
           "DriftDetector", "RestrictedCostModel", "recalibration_loop"]

#: the clock :class:`InstrumentedNet` reads (host seconds)
_clock = time.perf_counter


def _net_batch(sel: SelectionResult) -> int:
    return max((n.scn.n for n in sel.net.conv_nodes()), default=1)


# ----------------------------------------------------------------------
# predicted costs, per node and per edge — the objective, itemized
# ----------------------------------------------------------------------
def plan_predictions(sel: SelectionResult, cost: CostModel,
                     mesh_axes: Optional[Dict[str, int]] = None
                     ) -> Dict[str, Dict[Tuple, float]]:
    """Itemize the solver's objective for one plan.

    Returns ``{"node": {nid: s}, "edge": {(src, dst): s},
    "collective": {...}}`` — node entries are the chosen primitive's
    compute at the node's (batched, placement-sharded) scenario,
    exactly what ``selection._build`` put in the cost vector; edge
    entries are the realized conversion chain (per-image hop costs x
    the images the transform touches) or the fused transform.

    For a placement-solved plan pass the ``mesh_axes`` it was solved
    for: the collective terms are then itemized under ``"collective"``
    — ``("node", nid)`` for intra-node terms (the tp channel
    all-gather, the output delivery gather, the pp balance prior) and
    ``("edge", src, dst)`` for resharding / stage-boundary transfers —
    all derived from the same :class:`~repro.core.selection.
    PlacementPricing` the solver priced with.  Without ``mesh_axes``
    only mesh-less (all-``rep``) plans are supported.
    """
    placed = any(ch.placement != "rep" for ch in sel.choices.values())
    if placed and mesh_axes is None:
        raise ValueError("plan_predictions models mesh-less plans only "
                         "unless mesh_axes= names the topology the "
                         "plan was solved for (device placements add "
                         "collective terms)")
    nb = _net_batch(sel)
    net = sel.net
    pm = PlacementPricing(net, cost, mesh_axes) if placed else None
    pl_of = {nid: Placement.parse(ch.placement)
             for nid, ch in sel.choices.items()}

    nodes: Dict[Tuple, float] = {}
    for node in net.conv_nodes():
        prim = sel.choices[node.id].primitive
        c_rep = float(cost.primitive_cost(prim, node.scn))
        if pm is None:
            nodes[node.id] = c_rep
        else:
            compute, _ = pm.conv_cost(node, prim, pl_of[node.id], c_rep)
            nodes[node.id] = float(compute)

    def scale(src: str, dst: str) -> float:
        if pm is None:
            return float(nb)
        return float(pm.transform_images(pl_of[src], pl_of[dst]))

    edges: Dict[Tuple, float] = {}
    for (src, dst), chain in sel.conversions.items():
        shape = net.nodes[src].out_shape
        per_img = sum(cost.transform_cost(a, b, shape, "float32")
                      for a, b in zip(chain, chain[1:]))
        edges[(src, dst)] = float(per_img) * scale(src, dst)
    for (src, dst), kind in sel.fusions.items():
        cu, cv = sel.choices[src], sel.choices[dst]
        if kind == "in":
            per_img = cost.fused_in_cost(cv.primitive,
                                         net.nodes[dst].scn, cu.l_out)
        else:
            per_img = cost.fused_out_cost(cu.primitive,
                                          net.nodes[src].scn, cv.l_in)
        edges[(src, dst)] = float(per_img) * scale(src, dst)

    coll: Dict[Tuple, float] = {}
    if pm is not None:
        for nid in net.order:
            extra = pm.node_extra(net.nodes[nid], pl_of[nid])
            if extra:
                coll[("node", nid)] = float(extra)
        for dst in net.order:
            for src in net.nodes[dst].inputs:
                img = 4.0 * float(np.prod(net.nodes[src].out_shape))
                c = pm.edge_collective(pl_of[src], pl_of[dst], img)
                if c:
                    coll[("edge", src, dst)] = float(c)
    return {"node": nodes, "edge": edges, "collective": coll}


# ----------------------------------------------------------------------
# instrumented execution: the eager walk, one timed step per node/edge
# ----------------------------------------------------------------------
def _run_chain(v, chain):
    for a, b in zip(chain, chain[1:]):
        v = convert_layout(v, a, b)
    return v


class InstrumentedNet:
    """Per-node timed execution of a compiled plan.

    Each :meth:`__call__` walks the DAG as the executable's eager walk
    does (``core.plan._image_walker``: the batch a leading axis, the same
    makers, op functions and conversion chains, in true f32), timing
    every conv kernel, op, conversion chain and output conversion on its
    own: the host clock around the call, ending in a device
    synchronisation on the card (``core.costs.time_callable``'s
    discipline, which priced the profile).  It returns ``(outputs,
    timings)``: the outputs are the eager walk's tensors, bit for bit
    (CHW, a leading N at batch > 1), and ``timings = {"node": {nid: s},
    "edge": {(src, dst): s}, "unmodeled_s": s}`` — ``unmodeled_s`` is
    the op-node + output-conversion remainder the cost model prices at
    zero.  Observed node seconds include per-call dispatch and one call
    each (unlike the ``min_time``-amortized calibration sweep); the drift
    workflow is self-consistent because recalibrated entries come from
    the same instrumented measurement.  Construction warms the walk up
    once (``warmup``).
    """

    def __init__(self, cnet: CompiledNet, warmup: bool = True) -> None:
        if cnet.mesh is not None:
            raise ValueError("instrumented execution is single-device; "
                             "compile the plan without a mesh")
        if not cnet.makers:
            raise ValueError("CompiledNet carries no per-node makers; "
                             "build it with repro_torch.core.plan."
                             "compile_plan")
        self.cnet = cnet
        sel = cnet.sel
        self._out: Dict[str, str] = dict(cnet.out_layouts) \
            if cnet.out_layouts is not None else \
            {nid: sel.choices[nid].l_out for nid in sel.net.outputs()}
        if warmup:
            in_shape = sel.net.nodes[sel.net.order[0]].out_shape
            zeros = np.zeros(in_shape if cnet.batch == 1
                             else (cnet.batch, *in_shape), np.float32)
            self(zeros)

    # -----------------------------------------------------------------
    def __call__(self, x) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, Any]]:
        cnet = self.cnet
        sel, params, dev = cnet.sel, cnet.params, cnet.device
        net = sel.net
        node_s: Dict[str, float] = {}
        edge_s: Dict[Tuple[str, str], float] = {}
        unmodeled = 0.0
        vals: Dict[str, Any] = {}

        def timed(fn, *args):
            t0 = _clock()
            out = fn(*args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return out, _clock() - t0

        xin = _tensor(x, dev)
        with true_f32():
            for nid in net.order:
                node = net.nodes[nid]
                if node.kind == "input":
                    vals[nid] = xin.unsqueeze(0) if cnet.batch == 1 else xin
                    continue
                ins = []
                for src in node.inputs:
                    v = vals[src]
                    chain = sel.conversions.get((src, nid))
                    if chain is not None:
                        v, dt = timed(_run_chain, v, chain)
                        edge_s[(src, nid)] = dt
                    ins.append(v)
                if node.kind == "conv":
                    vals[nid], dt = timed(cnet.makers[nid], ins[0],
                                          params[nid])
                    node_s[nid] = dt
                else:
                    layout = LAYOUT_BY_NAME[sel.choices[nid].l_in]
                    vals[nid], dt = timed(node.op.fn, ins, layout,
                                          params.get(nid))
                    node_s[nid] = dt
                    unmodeled += dt
            outs: Dict[str, torch.Tensor] = {}
            for nid, lay in self._out.items():
                v, dt = timed(convert_layout, vals[nid], lay, "CHW")
                unmodeled += dt
                outs[nid] = v.squeeze(0) if cnet.batch == 1 else v
        return outs, {"node": node_s, "edge": edge_s,
                      "unmodeled_s": unmodeled}


# ----------------------------------------------------------------------
# drift scoring
# ----------------------------------------------------------------------
@dataclass
class DriftEntry:
    """EWMA state for one (node, primitive, layout, bucket) entry."""

    kind: str                 # "node" (conv kernel) | "edge" (transform)
    nid: str                  # node id, or "src->dst" for an edge
    primitive: str            # primitive name / "convert"
    layout: str               # "l_in->l_out" wire layouts
    bucket: str               # calibration bucket key
    predicted_s: float
    #: device placement of the node ("rep"/"dp"/"tp"/"pp<stage>"), or
    #: "src->dst" placements for an edge
    placement: str = "rep"
    ewma_observed_s: float = 0.0
    drift: float = 0.0        # EWMA of log(observed / predicted)
    n: int = 0
    #: recalibration target: profile key this entry's observation
    #: re-prices, and the per-image divisor (edges are priced per image)
    profile_key: Optional[str] = None
    per_image_div: int = 1

    def ratio(self) -> float:
        return math.exp(self.drift)


class DriftDetector:
    """Accumulate instrumented observations against a cost model.

    ``threshold`` is a *ratio*: an entry is flagged when its EWMA
    observed/predicted ratio leaves ``[1/threshold, threshold]``.
    ``alpha`` is the EWMA weight of each new observation.
    """

    def __init__(self, cost: CostModel, *, alpha: float = 0.3,
                 threshold: float = 1.5,
                 policy: Optional[BucketPolicy] = None) -> None:
        if threshold <= 1.0:
            raise ValueError("threshold is a ratio > 1")
        self.cost = cost
        self.alpha = alpha
        self.log_threshold = math.log(threshold)
        self.policy = policy or BucketPolicy()
        self.entries: Dict[Tuple[str, str], DriftEntry] = {}
        #: whole-plan EWMAs (modeled terms only)
        self.predicted_total = 0.0
        self.observed_total = 0.0
        self.unmodeled_s = 0.0
        self.runs = 0

    # -----------------------------------------------------------------
    def _update(self, e: DriftEntry, observed: float) -> None:
        if e.n == 0:
            e.ewma_observed_s = observed
            e.drift = math.log(max(observed, 1e-12) /
                               max(e.predicted_s, 1e-12))
        else:
            a = self.alpha
            e.ewma_observed_s += a * (observed - e.ewma_observed_s)
            e.drift += a * (math.log(max(observed, 1e-12) /
                                     max(e.predicted_s, 1e-12)) - e.drift)
        e.n += 1

    def observe(self, sel: SelectionResult,
                timings: Dict[str, Any]) -> None:
        """Fold one :class:`InstrumentedNet` run into the EWMAs."""
        pred = plan_predictions(sel, self.cost)
        nb = _net_batch(sel)
        net = sel.net
        obs_total = pred_total = 0.0
        for node in net.conv_nodes():
            nid = node.id
            if nid not in timings["node"]:
                continue
            ch = sel.choices[nid]
            b = bucket_scenario(node.scn, self.policy)
            key = ("node", nid)
            e = self.entries.get(key)
            if e is None:
                e = DriftEntry(
                    "node", nid, ch.primitive.name,
                    f"{ch.l_in}->{ch.l_out}", b.key(),
                    predicted_s=pred["node"][nid],
                    placement=str(ch.placement),
                    profile_key=prim_cost_key(ch.primitive.name, b))
                self.entries[key] = e
            e.predicted_s = pred["node"][nid]
            self._update(e, timings["node"][nid])
            obs_total += timings["node"][nid]
            pred_total += e.predicted_s
        for (src, dst), dt in timings["edge"].items():
            if (src, dst) not in pred["edge"]:
                continue
            chain = sel.conversions.get((src, dst))
            key = ("edge", f"{src}->{dst}")
            e = self.entries.get(key)
            if e is None:
                shape = net.nodes[src].out_shape
                pkey = None
                if chain is not None and len(chain) == 2:
                    # single-hop chains recalibrate the dt:: entry
                    # directly; multi-hop observations cannot be split
                    # across hops, so they report but never re-price
                    from ..serving.bucketing import bucket_shape
                    pkey = transform_cost_key(
                        chain[0], chain[1],
                        bucket_shape(shape, self.policy))
                e = DriftEntry(
                    "edge", f"{src}->{dst}", "convert",
                    "->".join(chain) if chain else "fused",
                    "x".join(map(str, net.nodes[src].out_shape)),
                    predicted_s=pred["edge"][(src, dst)],
                    placement=f"{sel.choices[src].placement}->"
                              f"{sel.choices[dst].placement}",
                    profile_key=pkey, per_image_div=nb)
                self.entries[key] = e
            e.predicted_s = pred["edge"][(src, dst)]
            self._update(e, dt)
            obs_total += dt
            pred_total += e.predicted_s
        a = self.alpha if self.runs else 1.0
        self.observed_total += a * (obs_total - self.observed_total)
        self.predicted_total += a * (pred_total - self.predicted_total)
        self.unmodeled_s += a * (timings.get("unmodeled_s", 0.0)
                                 - self.unmodeled_s)
        self.runs += 1

    # -----------------------------------------------------------------
    def flagged(self) -> List[DriftEntry]:
        return [e for e in self.entries.values()
                if abs(e.drift) > self.log_threshold]

    def plan_ratio(self) -> float:
        """Observed/predicted ratio of the modeled plan total."""
        return self.observed_total / max(self.predicted_total, 1e-12)

    def plan_within_threshold(self) -> bool:
        return abs(math.log(max(self.plan_ratio(), 1e-12))) \
            <= self.log_threshold

    def report(self) -> List[Dict[str, Any]]:
        """Per-entry rows, most drifted first (the obs_report table)."""
        rows = []
        for e in sorted(self.entries.values(),
                        key=lambda e: -abs(e.drift)):
            rows.append({
                "kind": e.kind, "node": e.nid, "primitive": e.primitive,
                "layout": e.layout, "bucket": e.bucket,
                "placement": e.placement,
                "predicted_ms": e.predicted_s * 1e3,
                "observed_ms": e.ewma_observed_s * 1e3,
                "ratio": e.ratio(), "drift": e.drift, "n": e.n,
                "flagged": abs(e.drift) > self.log_threshold,
            })
        return rows

    def recommendation(self) -> Dict[str, Any]:
        flagged = self.flagged()
        return {
            "recalibrate": bool(flagged),
            "flagged": [e.nid for e in flagged],
            "plan_ratio": self.plan_ratio(),
            "plan_within_threshold": self.plan_within_threshold(),
            "runs": self.runs,
        }

    # -----------------------------------------------------------------
    def recalibrate(self, profile) -> List[str]:
        """Write flagged entries' observed EWMAs into ``profile``.

        Touches ONLY flagged entries (un-drifted measurements stay
        exactly as the sweep produced them) and returns the re-priced
        keys.  The profile's content hash — and with it
        ``CalibratedCostModel.version()`` and every plan-cache key —
        changes iff this returns a non-empty list.
        """
        updated = []
        for e in self.flagged():
            if e.profile_key is None:
                continue
            profile.put(e.profile_key,
                        e.ewma_observed_s / max(e.per_image_div, 1))
            updated.append(e.profile_key)
        return updated


# ----------------------------------------------------------------------
# the recalibration workflow
# ----------------------------------------------------------------------
class RestrictedCostModel(CostModel):
    """Delegate to an inner model, restricting conv primitives to an
    allowlist (everything else priced infinite, so the selection domain
    shrinks to the allowed names).

    The recalibration loop re-prices a primitive only once the solver
    has *selected* it — with the full ~60-primitive registry the solver
    hops to a new analytically-underpriced candidate every round and
    takes dozens of rounds to run the pool dry.  Demos and tests bound
    that exploration by restricting the candidate set; production
    serving does the same thing over time simply by having a sweep-
    calibrated profile where few candidates are grossly mispriced.
    """

    def __init__(self, inner: CostModel, allowed) -> None:
        self.inner = inner
        self.allowed = frozenset(allowed)

    def primitive_cost(self, prim, scn) -> float:
        if prim.name not in self.allowed:
            return float("inf")
        return self.inner.primitive_cost(prim, scn)

    def transform_cost(self, src, dst, shape_chw, dtype) -> float:
        return self.inner.transform_cost(src, dst, shape_chw, dtype)

    def fused_in_cost(self, prim, scn, l_src) -> float:
        return self.inner.fused_in_cost(prim, scn, l_src)

    def fused_out_cost(self, prim, scn, l_dst) -> float:
        return self.inner.fused_out_cost(prim, scn, l_dst)

    def hardware_spec(self):
        return self.inner.hardware_spec()

    def collective_cost(self, kind, nbytes, n) -> float:
        return self.inner.collective_cost(kind, nbytes, n)

    def version(self) -> str:
        return self.inner.version() + "+allow=" + \
            ",".join(sorted(self.allowed))


def recalibration_loop(net, raw_params, x, profile, *,
                       allowed=None, policy: Optional[BucketPolicy] = None,
                       threshold: float = 2.0, runs: int = 4,
                       max_rounds: int = 8, alpha: float = 0.3,
                       exact: bool = True,
                       fallback: Optional[CostModel] = None,
                       device=None) -> Dict[str, Any]:
    """Iterate solve → instrument → flag → recalibrate to a fixed point.

    One round: price the net with ``CalibratedCostModel(profile)``
    (optionally restricted to the ``allowed`` primitive names), solve,
    compile, run ``runs`` instrumented passes, and fold them into a
    fresh :class:`DriftDetector`.  If anything is flagged, write the
    flagged observations back into ``profile`` and go again — a newly
    priced entry can change the optimum, so the loop continues until a
    round produces no *recalibratable* flags (or ``max_rounds``).

    Returns ``{"rounds": [...], "selection", "detector", "converged"}``
    — ``converged`` means the final plan's every modeled term matched
    its observation within ``threshold``.  This is the workflow of
    docs/observability.md: run it once against an empty profile to
    calibrate from live traffic, and re-run it whenever the detector
    recommends recalibration.

    The port's additions: each round compiles the eager walk
    (``compile_plan(jit=False)``) on ``device`` (the card unless told
    otherwise), whose fingerprint the profile must carry, and
    ``fallback`` prices what the profile does not cover
    (``CalibratedCostModel``'s default, the CPU spec, when None; on the
    card pass ``AnalyticCostModel(H100_SPEC)``).
    """
    from ..calibrate.model import CalibratedCostModel
    from ..core.plan import compile_plan
    from ..core.selection import select_pbqp

    policy = policy or BucketPolicy()
    rounds: List[Dict[str, Any]] = []
    sel = det = None
    for rnd in range(max_rounds):
        cost: CostModel = CalibratedCostModel(profile, policy=policy,
                                              fallback=fallback,
                                              device=device)
        if allowed is not None:
            cost = RestrictedCostModel(cost, allowed)
        sel = select_pbqp(net, cost, exact=exact)
        cnet = compile_plan(sel, raw_params, jit=False, device=device)
        inst = InstrumentedNet(cnet)
        det = DriftDetector(cost, alpha=alpha, threshold=threshold,
                            policy=policy)
        for _ in range(runs):
            _, tm = inst(x)
            det.observe(sel, tm)
        flagged = det.flagged()
        rounds.append({
            "round": rnd,
            "primitives": {n.id: sel.choices[n.id].primitive.name
                           for n in net.conv_nodes()},
            "plan_ratio": det.plan_ratio(),
            "flagged": sorted(e.nid for e in flagged),
            "predicted_cost": sel.predicted_cost,
        })
        if not any(e.profile_key for e in flagged):
            break
        det.recalibrate(profile)
    return {"rounds": rounds, "selection": sel, "detector": det,
            "converged": det is not None and not det.flagged()}
