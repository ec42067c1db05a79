"""PBQP construction, solving, legalization — Section 3 of the paper.

The embedding (built through the unified choice-space bridge of
:mod:`repro.core.choice_space`, which :mod:`repro.core.sharding_select`
shares for its resharding-collective transform kind):

* conv node  -> PBQP node whose domain is the applicable primitives;
  node cost vector = profiled execution time of each primitive.
* op node    -> PBQP node whose domain is the layouts it accepts;
  node cost vector = 0 (the paper's zero-cost dummy nodes).
* edge (u,v) -> cost matrix T[i, j] = APSP cost in the DT graph from
  u's choice-i output layout to v's choice-j input layout, measured on
  the actual tensor shape flowing along the edge (inf if no chain of
  transformations exists).

``legalize`` then bisects every edge whose endpoint layouts differ with
the explicit shortest chain of conversion layers — the cost of which the
optimum already accounts for (the paper's key point: pricing conversions
*after* selection is what makes greedy/local strategies sub-optimal).

**Device placement axis.**  With ``mesh_axes`` (e.g. ``{"data": 2,
"model": 4, "stage": 2}``) the choice space gains a second dimension:
every node's domain crosses primitives (or layouts) with the
structured :class:`~repro.core.choice_space.Placement` domain
{``rep``, ``dp``, ``tp``, ``pp<stage>``}:

* ``rep`` — whole batch replicated on every device.
* ``dp`` — batch sharded over every non-stage axis (``data`` ×
  ``model`` flattened, width D_dp); node costs price the per-device
  shard (``Scenario.n/D_dp``).
* ``tp`` — batch sharded over ``data`` AND conv weights sharded over
  ``model`` (output channels, ``Scenario.m/D_tp``); the node
  additionally pays the intra-node ring all-gather that reassembles
  the channel dimension (op nodes carry ``tp`` as the matching
  data-sharded/model-replicated form at zero extra cost, so runs of
  tp layers wire up for free).
* ``pp<s>`` — the node is resident on pipeline stage ``s``; compute
  is discounted by the GPipe fill-drain overlap factor
  ``(M + S - 1)/(S M)``, edges crossing a stage boundary pay the
  activation send, and backward hops price infinite — the monotone
  stage constraint, encoded so :func:`_legalize` never sees one.

Edges whose endpoints disagree on placement pay the resharding
collective (e.g. ``dp -> rep``: an all-gather of the whole batched
tensor — the distributed analogue of a layout transform); sharded
output nodes pay the final delivery gather.  The solver therefore
trades collective time against replicated compute per layer, exactly
as it trades transform time against primitive speed.
:func:`~repro.core.plan.compile_plan` realizes placements on a mesh:
dp/rep as ``NamedSharding`` constraints, tp as explicit shard_map
collectives over the weight axis, contiguous pp stage runs on
:func:`~repro.runtime.pipeline_parallel.pipeline_apply`
(docs/distributed.md).

docs/solver.md works a small instance through this embedding end to
end; any :class:`~repro.core.costs.CostModel` can price it, including
the measured tables of :class:`repro.calibrate.CalibratedCostModel`
(docs/calibration.md).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import AbstractSet, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import pbqp
from .choice_space import ChoiceEdge, ChoiceNode, Placement, build_pbqp
from .costs import CostModel
from .graph import Net, Node
from .layouts import DTGraph, transform_feasible
from .primitives import Primitive, primitives_for
from .scenario import Scenario

__all__ = ["SelectionResult", "select_pbqp", "select_fixed",
           "select_sum2d", "select_local_optimal", "select_family_best",
           "Choice", "Placement", "PlacementPricing", "warm_assignment",
           "placements_for", "pp_chain", "pp_microbatches"]


@dataclass(frozen=True)
class Choice:
    """Resolved assignment for one node."""
    primitive: Optional[Primitive]  # None for op nodes
    l_in: str
    l_out: str
    #: device placement: "rep" (replicated over the mesh's data axis)
    #: or "dp" (batch sharded over it).  Always "rep" without a mesh.
    placement: str = "rep"


@dataclass
class SelectionResult:
    net: Net
    choices: Dict[str, Choice]
    #: per-edge conversion chains: (src, dst) -> [layout names] (len>=2)
    conversions: Dict[Tuple[str, str], List[str]]
    predicted_cost: float
    optimal: bool
    strategy: str
    solver_stats: Dict[str, int] = field(default_factory=dict)
    #: per-edge fused realizations: (src, dst) -> "in" | "out".  "in":
    #: the consumer's prologue reads the producer's layout directly;
    #: "out": the producer's epilogue emits the consumer's layout.  An
    #: edge is either here or in ``conversions``, never both.
    fusions: Dict[Tuple[str, str], str] = field(default_factory=dict)


def _conv_domain(node: Node, cost: CostModel,
                 families: Optional[Sequence[str]] = None,
                 require_finite: bool = True,
                 banned: Optional[AbstractSet[str]] = None):
    """Candidate (primitive, cost) entries for one conv node.

    ``banned`` prices the named primitives infinite — the circuit
    breaker's quarantine lever (docs/reliability.md): an infinite entry
    is dropped by the finite filter exactly like an unpriceable one, so
    the solver routes around a quarantined kernel.  If quarantine would
    empty the domain the ban is ignored (a degraded plan beats no plan).
    """
    prims = primitives_for(node.scn, families=families)
    entries = [(p, np.inf if banned and p.name in banned
                else cost.primitive_cost(p, node.scn)) for p in prims]
    if require_finite:
        finite = [(p, c) for (p, c) in entries if np.isfinite(c)]
        if not finite and banned:
            # every survivor is quarantined: lift the ban rather than
            # hand the solver an all-infinite (infeasible) node
            entries = [(p, cost.primitive_cost(p, node.scn))
                       for p in prims]
            finite = [(p, c) for (p, c) in entries if np.isfinite(c)]
        entries = finite or entries
    if not entries:
        raise ValueError(f"no primitive supports {node.scn}")
    return entries


def _fused_options(cost: CostModel, src_node: Node, dst_node: Node,
                   cu: Choice, cv: Choice, single_consumer: bool,
                   shape) -> List[Tuple[float, str]]:
    """Fused realizations available for one (choice, choice) edge pair.

    Returns ``[(per-image cost, kind)]`` with kind ``"in"`` (consumer
    prologue reads ``cu.l_out``) or ``"out"`` (producer epilogue emits
    ``cv.l_in``).  Capability comes from the primitive registry's
    ``fusable_in``/``fusable_out`` declarations; blocked-layout
    feasibility from :func:`~repro.core.layouts.transform_feasible`.
    Epilogue fusion is only offered when the producer has a single
    consumer — a fused-out producer changes the value *every* consumer
    sees, so fan-out edges must materialize (or fuse on the consumer
    side).
    """
    opts: List[Tuple[float, str]] = []
    if cu.l_out == cv.l_in:
        return opts
    pv = cv.primitive
    if pv is not None and cu.l_out in pv.fusable_in and \
            transform_feasible(cu.l_out, pv.l_in, shape):
        opts.append((cost.fused_in_cost(pv, dst_node.scn, cu.l_out), "in"))
    pu = cu.primitive
    if pu is not None and single_consumer and cv.l_in in pu.fusable_out \
            and transform_feasible(pu.l_out, cv.l_in, shape):
        opts.append((cost.fused_out_cost(pu, src_node.scn, cv.l_in), "out"))
    return opts


def _out_degree(net: Net) -> Dict[str, int]:
    deg: Dict[str, int] = {}
    for (src, _) in net.edges():
        deg[src] = deg.get(src, 0) + 1
    return deg


def _net_batch(net: Net) -> int:
    """The net's minibatch (single definition: placement domains and
    dp shard pricing must derive it identically)."""
    return max((n.scn.n for n in net.conv_nodes()), default=1)


def _mesh_dims(mesh_axes: Optional[Dict[str, int]]
               ) -> Tuple[int, int, int]:
    """``(d_data, d_tp, s_pp)`` of a ``mesh_axes`` dict; absent axes
    are 1-wide.  ``data`` shards batches, ``model`` shards weights,
    ``stage`` holds pipeline stages."""
    if not mesh_axes:
        return 1, 1, 1
    return (int(mesh_axes.get("data", 1)),
            int(mesh_axes.get("model", 1)),
            int(mesh_axes.get("stage", 1)))


def pp_microbatches(nb: int, s: int) -> int:
    """Microbatch count for a batch of ``nb`` over ``s`` pipeline
    stages: the largest divisor of ``nb`` not exceeding ``2s`` — enough
    microbatches to keep the fill-drain bubble small, few enough that
    per-microbatch dispatch overhead stays bounded.  Pure function of
    (nb, s): pricing and :func:`~repro.core.plan.compile_plan` must
    derive it identically."""
    target = min(nb, max(2 * s, 1))
    for m in range(target, 0, -1):
        if nb % m == 0:
            return m
    return 1


def pp_chain(net: Net) -> Optional[List[str]]:
    """The net's node ids in order iff it is pipelineable: a single
    linear chain (every node consumes exactly the previous node), a
    single output (the last node), and every node shape-preserving —
    the fixed carry shape :func:`~repro.runtime.pipeline_parallel.
    pipeline_apply` rotates between stages.  Returns None otherwise;
    pp placements are only offered on pipelineable nets."""
    order = net.order
    if not order:
        return None
    in_shape = net.nodes[order[0]].out_shape
    prev: Optional[str] = None
    for i, nid in enumerate(order):
        node = net.nodes[nid]
        if i == 0:
            if node.kind != "input":
                return None
        elif list(node.inputs) != [prev]:
            return None
        if tuple(node.out_shape) != tuple(in_shape):
            return None
        prev = nid
    if net.outputs() != [order[-1]]:
        return None
    return list(order)


def placements_for(net: Net,
                   mesh_axes: Optional[Dict[str, int]]) -> List[str]:
    """Generic placement domain for a net on a mesh.  Sharded kinds
    first and ``rep`` last, so cost *ties* (zero-cost op nodes, free
    edges) resolve to the sharded choice: replicated execution at equal
    priced time still burns D× the compute.  Kinds are offered only
    when feasible: ``dp`` needs the flattened data×model width to
    divide the batch, ``tp`` needs a >1 ``model`` axis and a
    data-divisible batch (per-primitive weight divisibility is filtered
    per node), ``pp`` needs a >1 ``stage`` axis and a pipelineable net
    (:func:`pp_chain`)."""
    d_data, d_tp, s_pp = _mesh_dims(mesh_axes)
    nb = _net_batch(net)
    d_dp = d_data * d_tp
    out: List[str] = []
    if d_dp > 1 and nb >= d_dp and nb % d_dp == 0:
        out.append(Placement("dp"))
    if d_tp > 1 and nb >= d_data and nb % d_data == 0:
        out.append(Placement("tp"))
    if s_pp > 1 and pp_chain(net) is not None:
        out.extend(Placement("pp", s) for s in range(s_pp))
    out.append(Placement("rep"))
    return out


class PlacementPricing:
    """Placement-axis pricing, stated once.

    Both the PBQP builder (:func:`_build`) and the observability
    itemizer (:func:`repro.obs.drift.plan_predictions`) derive every
    placement cost term from this class, so the drift detector's
    predicted ledger is exactly the objective the solver minimized.

    Terms:

    * ``conv_cost`` — per-device compute of a primitive under a
      placement, plus the placement's intra-node extras (tp channel
      all-gather, output delivery gather, pp balance prior).
    * ``transform_images`` — how many images an edge's layout
      transform actually touches (the sharded side of a mixed edge;
      the overlap-discounted batch inside a pipeline).
    * ``edge_collective`` — the resharding collective between unlike
      placements, the pp stage-boundary send, and the infinite
      entries that encode pipeline monotonicity.
    """

    #: stage-balance prior weight (seconds per stage of imbalance).
    #: Monotone chains make every stage split cost-identical under the
    #: additive objective, so this epsilon tie-breaks toward the
    #: balanced split the fill-drain discount assumes.  It must exceed
    #: the branch-and-bound prune tolerance (1e-9 relative) to survive
    #: the solve, and stays ~1000x below real node costs (~µs) so it
    #: never decides anything but ties.
    PP_EPS = 1e-8

    def __init__(self, net: Net, cost: CostModel,
                 mesh_axes: Optional[Dict[str, int]]):
        self.net = net
        self.cost = cost
        self.nb = _net_batch(net)
        self.d_data, self.d_tp, self.s_pp = _mesh_dims(mesh_axes)
        self.d_dp = self.d_data * self.d_tp
        self.outputs = set(net.outputs())
        self.base = [Placement.parse(p)
                     for p in placements_for(net, mesh_axes)]
        self.n_micro = pp_microbatches(self.nb, self.s_pp)
        self.ppf = ((self.n_micro + self.s_pp - 1)
                    / (self.s_pp * self.n_micro)) if self.s_pp > 1 else 1.0
        self.pos = {nid: i for i, nid in enumerate(net.order)}

    # ---------------- node domains ----------------
    def node_placements(self, node: Node) -> List[Placement]:
        """Per-node filter of the generic domain: the input node spans
        from stage 0, output nodes to stage S-1 (so a pipelined plan
        covers the whole mesh), and inputs never carry tp (data-sharded
        entry is dp's job; a reshard edge prices the difference)."""
        out = []
        for pl in self.base:
            if pl.kind == "pp":
                if node.kind == "input" and pl.stage != 0:
                    continue
                if node.id in self.outputs and pl.stage != self.s_pp - 1:
                    continue
            if pl.kind == "tp" and node.kind == "input":
                continue
            out.append(pl)
        return out

    def tp_feasible(self, node: Node, prim: Primitive) -> bool:
        """tp shards ``prim``'s output channels D_tp ways: the shard
        scenario must divide evenly, stay supported, and be
        CHW-convertible on both sides of the channel all-gather."""
        scn = node.scn
        if self.d_tp <= 1 or scn.m % self.d_tp != 0:
            return False
        scn_tp = scn.with_(m=scn.m // self.d_tp)
        if not prim.supports(scn_tp):
            return False
        return transform_feasible(prim.l_out, "CHW",
                                  scn_tp.out_shape_chw) and \
            transform_feasible("CHW", prim.l_out, scn.out_shape_chw)

    # ---------------- node cost terms ----------------
    def conv_cost(self, node: Node, prim: Primitive, pl: Placement,
                  c_rep: float) -> Tuple[float, float]:
        """``(compute, extra)`` seconds for one conv choice: per-device
        compute under the placement, and the placement's collective /
        prior terms (tp channel gather, delivery, pp balance)."""
        k = pl.kind
        if k == "dp":
            compute = self.cost.primitive_cost(
                prim, node.scn.with_(n=self.nb // self.d_dp))
        elif k == "tp":
            scn_tp = node.scn.with_(n=self.nb // self.d_data,
                                    m=node.scn.m // self.d_tp)
            compute = self.cost.primitive_cost(prim, scn_tp)
        elif k == "pp":
            compute = c_rep * self.ppf
        else:
            compute = c_rep
        return compute, self.node_extra(node, pl)

    def node_extra(self, node: Node, pl: Placement) -> float:
        """Non-compute node terms: the tp channel all-gather, the
        output delivery gather, and the pp balance prior."""
        extra = self.balance_eps(node, pl)
        img = 4.0 * float(np.prod(node.out_shape))
        if pl.kind == "tp" and node.kind == "conv":
            # reassemble the channel shards within each data group
            extra += self.cost.collective_cost(
                "all_gather", img * (self.nb // self.d_data), self.d_tp)
        extra += self.delivery(node, pl)
        return extra

    def delivery(self, node: Node, pl: Placement) -> float:
        """Final all-gather a sharded *output* node pays so the caller
        sees the full batch (rep outputs are already whole)."""
        if node.id not in self.outputs:
            return 0.0
        nbytes = 4.0 * float(np.prod(node.out_shape)) * self.nb
        if pl.kind == "dp":
            return self.cost.collective_cost("all_gather", nbytes,
                                             self.d_dp)
        if pl.kind == "tp":
            return self.cost.collective_cost("all_gather", nbytes,
                                             self.d_data)
        if pl.kind == "pp":
            # pipeline_apply's final psum broadcast of the last stage
            return self.cost.collective_cost("all_gather", nbytes,
                                             self.s_pp)
        return 0.0

    def balance_eps(self, node: Node, pl: Placement) -> float:
        if pl.kind != "pp":
            return 0.0
        n = max(len(self.net.order), 1)
        ideal = min(self.s_pp - 1, self.pos[node.id] * self.s_pp // n)
        return self.PP_EPS * abs(pl.stage - ideal)

    # ---------------- edge terms ----------------
    def rows(self, pl: Placement) -> int:
        """Images materialized per device under a placement."""
        if pl.kind == "dp":
            return self.nb // self.d_dp
        if pl.kind == "tp":
            return self.nb // self.d_data
        return self.nb

    def transform_images(self, pu: Placement, pv: Placement) -> float:
        """Images an edge's layout transform touches: the sharded side
        of a mixed edge (GSPMD transforms before gathering / after
        slicing), the overlap-discounted whole batch inside a
        pipeline."""
        if pu.kind == "pp" or pv.kind == "pp":
            return self.nb * self.ppf
        return float(min(self.rows(pu), self.rows(pv)))

    def edge_collective(self, pu: Placement, pv: Placement,
                        img_bytes: float) -> float:
        """Resharding / stage-boundary collective seconds for one edge.
        ``inf`` encodes the illegal transitions: entering or leaving
        the pipeline mid-net, and backward stage hops (the monotone
        stage constraint)."""
        ku, kv = pu.kind, pv.kind
        if (ku == "pp") != (kv == "pp"):
            return float("inf")
        if ku == "pp":
            if pv.stage < pu.stage:
                return float("inf")
            if pv.stage == pu.stage:
                return 0.0
            # each boundary ships the whole activation batch once
            # (as n_micro microbatch sends; linear in bytes)
            return (pv.stage - pu.stage) * self.cost.collective_cost(
                "send", img_bytes * self.nb, 2)
        if ku == kv:
            return 0.0
        if ku == "dp" and kv == "rep":
            return self.cost.collective_cost(
                "all_gather", img_bytes * self.nb, self.d_dp)
        if ku == "dp" and kv == "tp":
            # gather the model-axis batch shards within each data group
            return self.cost.collective_cost(
                "all_gather", img_bytes * (self.nb // self.d_data),
                self.d_tp)
        if ku == "tp" and kv == "rep":
            return self.cost.collective_cost(
                "all_gather", img_bytes * self.nb, self.d_data)
        # rep->dp, rep->tp, tp->dp: a local slice, free
        return 0.0


def _build(net: Net, cost: CostModel, *,
           fixed: Optional[Dict[str, Primitive]] = None,
           families: Optional[Sequence[str]] = None,
           fuse: bool = False,
           mesh_axes: Optional[Dict[str, int]] = None,
           banned: Optional[AbstractSet[str]] = None):
    """Build the PBQP instance; returns (problem, domains).

    ``fixed`` pins given conv nodes to a single primitive (domain size 1)
    — used by the baseline strategies, which still get optimal *layout*
    legalization through the op nodes.

    ``fuse`` prices every edge entry as ``min(materialized DT chain,
    fused prologue, fused epilogue)`` — the solver then sees transforms
    at their fused price and can pick primitive pairs a materialized-only
    model would reject (the tentpole of the fusion subsystem).

    ``mesh_axes`` (e.g. ``{"data": 2, "model": 4, "stage": 2}``)
    enables the device-placement axis: domains cross with the
    feasibility-filtered {rep, dp, tp, pp<stage>} domain and every
    placement cost term comes from :class:`PlacementPricing` — the same
    object :func:`repro.obs.drift.plan_predictions` itemizes from, so
    the observed ledger always matches the solved objective.  The whole
    construction goes through the shared
    :func:`repro.core.choice_space.build_pbqp` bridge — the same one
    :mod:`repro.core.sharding_select` builds its collective-priced
    instances with.
    """
    dt = cost.dt_graph()
    pm = PlacementPricing(net, cost, mesh_axes)

    nodes: List[ChoiceNode] = []
    for nid in net.order:
        node = net.nodes[nid]
        pls = pm.node_placements(node)
        if node.kind == "input":
            choices = [Choice(None, "CHW", "CHW", pl) for pl in pls]
            costs = [pm.node_extra(node, pl) for pl in pls]
        elif node.kind == "conv":
            if fixed and nid in fixed:
                p = fixed[nid]
                c = cost.primitive_cost(p, node.scn)
                entries = [(p, c if np.isfinite(c) else 1e6)]
            else:
                entries = _conv_domain(node, cost, families, banned=banned)
            choices, costs = [], []
            for p, c_rep in entries:
                for pl in pls:
                    if pl.kind == "tp" and not pm.tp_feasible(node, p):
                        continue
                    compute, extra = pm.conv_cost(node, p, pl, c_rep)
                    choices.append(Choice(p, p.l_in, p.l_out, pl))
                    costs.append(compute + extra)
        else:  # op
            choices = [Choice(None, l, l, pl) for l in node.op.layouts
                       for pl in pls]
            costs = [pm.node_extra(node, Placement.parse(ch.placement))
                     for ch in choices]
        nodes.append(ChoiceNode(nid, choices, costs))

    # Transform costs are priced per image by the DT graph and scale
    # with the images each device actually transforms
    # (PlacementPricing.transform_images); placement-mismatched edges
    # additionally pay the resharding collective — the distributed
    # "layout transformation" — and pp stage boundaries pay the
    # activation send through the CHW boundary wire.
    deg = _out_degree(net)
    edges: List[ChoiceEdge] = []
    for (src, dst) in net.edges():
        shape = net.nodes[src].out_shape
        dtcosts, idx = dt.cost_matrix(shape)
        sn, dn = net.nodes[src], net.nodes[dst]
        single = deg.get(src, 0) == 1
        img_bytes = 4 * float(np.prod(shape))

        def transition(cu: Choice, cv: Choice, *, dtcosts=dtcosts,
                       idx=idx, sn=sn, dn=dn, single=single,
                       shape=shape, img_bytes=img_bytes) -> float:
            pu = Placement.parse(cu.placement)
            pv = Placement.parse(cv.placement)
            coll = pm.edge_collective(pu, pv, img_bytes)
            if not np.isfinite(coll):
                return coll
            if pu.kind == "pp" and pv.kind == "pp" and \
                    pu.stage != pv.stage:
                # stage boundaries wire CHW activations between
                # devices: price the via-CHW conversion route
                per_img = dtcosts[idx[cu.l_out], idx["CHW"]] + \
                    dtcosts[idx["CHW"], idx[cv.l_in]]
            else:
                per_img = dtcosts[idx[cu.l_out], idx[cv.l_in]]
                if fuse and cu.placement == cv.placement \
                        and pu.kind != "tp":
                    for c, _ in _fused_options(cost, sn, dn, cu, cv,
                                               single, shape):
                        if c < per_img:
                            per_img = c
            return per_img * pm.transform_images(pu, pv) + coll

        edges.append(ChoiceEdge(src, dst, transition))

    pb, domains = build_pbqp(nodes, edges)
    return pb, domains, dt


def _legalize(net: Net, dt: DTGraph, choices: Dict[str, Choice], *,
              cost: Optional[CostModel] = None, fuse: bool = False
              ) -> Tuple[Dict[Tuple[str, str], List[str]],
                         Dict[Tuple[str, str], str]]:
    """Realize every mismatched edge as either a materialized conversion
    chain or a fused prologue/epilogue.

    The realization replays exactly the pricing :func:`_build` fed the
    solver — ``min(materialized, fused options)``, materialized
    preferred on ties, fused options only offered when both endpoints
    share a device placement and neither is tp (exactly as the edge
    matrices were priced; shard-level blocked layouts make fused
    feasibility diverge from the full-shape check, so tp edges always
    materialize) — so the executed plan's transform cost is the one the
    optimum accounted for.  Edges that cross a pipeline stage boundary
    wire CHW activations between devices: their chain is the glued
    shortest path through CHW (recorded even when the endpoint layouts
    agree), which the pipeline executor splits at CHW into the
    producer stage's exit hops and the consumer stage's entry hops.
    With ``fuse=False`` (the paper's system), every mismatched edge
    materializes.
    """
    conversions: Dict[Tuple[str, str], List[str]] = {}
    fusions: Dict[Tuple[str, str], str] = {}
    deg = _out_degree(net)
    for (src, dst) in net.edges():
        cu, cv = choices[src], choices[dst]
        pu = Placement.parse(cu.placement)
        pv = Placement.parse(cv.placement)
        lo = cu.l_out
        li = cv.l_in
        if pu.kind == "pp" and pv.kind == "pp" and pu.stage != pv.stage:
            shape = net.nodes[src].out_shape
            p1 = dt.shortest_chain(lo, "CHW", shape) \
                if lo != "CHW" else ["CHW"]
            p2 = dt.shortest_chain("CHW", li, shape) \
                if li != "CHW" else ["CHW"]
            if p1 is None or p2 is None:
                raise RuntimeError(
                    f"illegal stage boundary {src}->{dst}: no DT path "
                    f"through CHW ({lo}->{li})")
            chain = list(p1) + list(p2)[1:]
            if len(chain) >= 2:
                conversions[(src, dst)] = chain
            continue
        if lo == li:
            continue
        shape = net.nodes[src].out_shape
        kind = "dt"
        if fuse and cost is not None and \
                cu.placement == cv.placement and pu.kind != "tp":
            costs, idx = dt.cost_matrix(shape)
            options = [(costs[idx[lo], idx[li]], "dt")]
            options += _fused_options(cost, net.nodes[src], net.nodes[dst],
                                      choices[src], choices[dst],
                                      deg.get(src, 0) == 1, shape)
            best = min(options, key=lambda t: t[0])  # stable: dt on ties
            if np.isfinite(best[0]):
                kind = best[1]
        if kind == "dt":
            chain = dt.shortest_chain(lo, li, shape)
            if chain is None:
                raise RuntimeError(
                    f"illegal edge {src}->{dst}: no DT path {lo}->{li}")
            conversions[(src, dst)] = chain
        else:
            fusions[(src, dst)] = kind
    return conversions, fusions


def warm_assignment(prev: "SelectionResult",
                    domains: Dict[str, List[Choice]]
                    ) -> Optional[Dict[str, int]]:
    """Map a previous selection onto new PBQP domains (warm start).

    Neighbouring serving buckets share graph topology but have different
    scenarios, so per-node domains may differ; choices are matched by
    primitive name + placement (conv nodes) / input layout + placement
    (op nodes), degrading to a primitive/layout-only match when the
    previous placement no longer exists in the new domain (e.g. warm
    starting a mesh solve from a meshless plan).  Nodes whose previous
    choice no longer exists fall back to index 0 — the resulting
    assignment is still feasible-or-infinite, and an infinite warm cost
    simply disables the bound (see :func:`repro.core.pbqp.solve_warm`).
    Returns None when the topologies do not line up at all.
    """
    def matches(ch: Choice, pc: Choice, with_placement: bool) -> bool:
        if with_placement and ch.placement != pc.placement:
            return False
        if pc.primitive is None:
            return ch.primitive is None and ch.l_in == pc.l_in
        return ch.primitive is not None and \
            ch.primitive.name == pc.primitive.name

    asg: Dict[str, int] = {}
    for nid, dom in domains.items():
        pc = prev.choices.get(nid)
        if pc is None:
            return None
        idx = 0
        for with_placement in (True, False):
            hit = next((i for i, ch in enumerate(dom)
                        if matches(ch, pc, with_placement)), None)
            if hit is not None:
                idx = hit
                break
        asg[nid] = idx
    return asg


def select_pbqp(net: Net, cost: CostModel, *, exact: bool = True,
                families: Optional[Sequence[str]] = None,
                warm_start: Optional["SelectionResult"] = None,
                fuse: bool = False,
                mesh_axes: Optional[Dict[str, int]] = None,
                banned: Optional[AbstractSet[str]] = None,
                deadline_s: Optional[float] = None,
                bb_budget: int = 200_000) -> SelectionResult:
    """The paper's approach: globally optimal primitive selection.

    ``warm_start`` seeds the branch-and-bound incumbent with a previous
    :class:`SelectionResult` for a structurally-identical net (e.g. the
    neighbouring scenario bucket in the serving plan cache) — same optimum,
    typically far fewer branch-and-bound nodes.

    ``fuse=True`` enables transform fusion: edges are priced
    ``min(materialized DT, fused prologue, fused epilogue)`` and the
    result carries per-edge fused realizations that
    :func:`~repro.core.plan.compile_plan` turns into fused calls.  Off
    by default — the materialized system is the paper's.

    ``mesh_axes`` (e.g. ``mesh_shape_dict(mesh)``) additionally solves
    the device-placement axis over the mesh's ``data`` axis; realize the
    result with ``compile_plan(..., mesh=mesh, batch=nb)``.

    ``banned`` prices the named primitives infinite (circuit-breaker
    quarantine — see :func:`_conv_domain`); ``deadline_s`` turns the
    solve *anytime* — past the wall-clock allowance branch-and-bound
    stops and the RN heuristic completes the assignment
    (``solver_stats["DEADLINE"]`` records the degradation); ``bb_budget``
    caps branch-and-bound node expansions the same way.
    """
    pb, domains, dt = _build(net, cost, families=families, fuse=fuse,
                             mesh_axes=mesh_axes, banned=banned)
    if warm_start is not None:
        warm = warm_assignment(warm_start, domains)
        sol = pbqp.solve_warm(pb, warm, exact=exact, bb_budget=bb_budget,
                              deadline_s=deadline_s)
    else:
        sol = pbqp.solve(pb, exact=exact, bb_budget=bb_budget,
                         deadline_s=deadline_s)
    choices = {nid: domains[nid][sol.assignment[nid]] for nid in net.order}
    conversions, fusions = _legalize(net, dt, choices, cost=cost, fuse=fuse)
    return SelectionResult(net, choices, conversions, sol.cost, sol.optimal,
                           "pbqp", sol.stats, fusions)


def select_fixed(net: Net, cost: CostModel,
                 pick: Dict[str, Primitive], strategy: str, *,
                 fuse: bool = False) -> SelectionResult:
    """Pin conv nodes to given primitives; op-node layouts still get the
    optimal legalization (restricted PBQP over layouts only)."""
    pb, domains, dt = _build(net, cost, fixed=pick, fuse=fuse)
    sol = pbqp.solve(pb, exact=True)
    choices = {nid: domains[nid][sol.assignment[nid]] for nid in net.order}
    conversions, fusions = _legalize(net, dt, choices, cost=cost, fuse=fuse)
    return SelectionResult(net, choices, conversions, sol.cost, sol.optimal,
                           strategy, sol.stats, fusions)


def _sum2d_prim() -> Primitive:
    from .primitives import registry
    return next(p for p in registry() if p.name == "sum2d")


def select_sum2d(net: Net, cost: CostModel) -> SelectionResult:
    """The paper's baseline: every conv is the textbook SUM2D routine."""
    p = _sum2d_prim()
    pick = {n.id: p for n in net.conv_nodes()}
    return select_fixed(net, cost, pick, "sum2d")


def select_local_optimal(net: Net, cost: CostModel,
                         canonical: str = "CHW",
                         banned: Optional[AbstractSet[str]] = None
                         ) -> SelectionResult:
    """The paper's 'local optimal': canonical layout everywhere, fastest
    primitive that natively consumes and produces that layout.

    ``banned`` excludes quarantined primitives from the per-node pick —
    the greedy rung of the serving fallback ladder must not re-select
    the kernel whose crash demoted the request to it."""
    pick = {}
    for node in net.conv_nodes():
        cands = [p for p in primitives_for(node.scn)
                 if p.l_in == canonical and p.l_out == canonical
                 and not (banned and p.name in banned)]
        costs = [(cost.primitive_cost(p, node.scn), p) for p in cands]
        costs = [(c, p) for c, p in costs if np.isfinite(c)]
        if not costs:
            raise ValueError(
                f"select_local_optimal: no {canonical}->{canonical} "
                f"primitive has finite cost for node {node.id!r} "
                f"({node.scn}); the canonical-layout strategy cannot "
                f"cover this scenario under this cost model")
        pick[node.id] = min(costs, key=lambda t: t[0])[1]
    return select_fixed(net, cost, pick, "local_optimal")


def select_family_best(net: Net, cost: CostModel,
                       family: str) -> SelectionResult:
    """The paper's per-family bars: replace SUM2D with the family's
    fastest variant when that variant is faster (node cost only — layout
    transformation costs are NOT considered in the pick, which is
    exactly the trap Section 5.8 demonstrates)."""
    sum2d = _sum2d_prim()
    pick = {}
    for node in net.conv_nodes():
        base_c = cost.primitive_cost(sum2d, node.scn)
        cands = [p for p in primitives_for(node.scn, families=[family])]
        best, best_c = sum2d, base_c
        for p in cands:
            c = cost.primitive_cost(p, node.scn)
            if np.isfinite(c) and c < best_c:
                best, best_c = p, c
        pick[node.id] = best
    return select_fixed(net, cost, pick, f"family_{family}")
