"""Partitioned Boolean Quadratic Programming (PBQP) solver.

This is the computational heart of the paper (Anderson & Gregg 2017):
primitive selection in the presence of data-layout transformations is
embedded into PBQP and solved with a reduction-based solver in the style
of Scholz/Eckstein/Hames [LCTES'02, CC'03, SAS'06].

A PBQP instance is an undirected graph.  Every node ``u`` has a cost
vector ``c_u`` of length ``k_u`` (one entry per candidate assignment —
for us: one per applicable primitive/sharding).  Every edge ``(u, v)``
carries a cost matrix ``C_uv`` of shape ``(k_u, k_v)`` (for us: the
data-layout / resharding transition cost between the two chosen
primitives).  The objective is to pick one assignment per node
minimising::

    sum_u c_u[x_u]  +  sum_{(u,v)} C_uv[x_u, x_v]

The solver applies the optimality-preserving reductions R0 (isolated
node), RI (degree-1 node) and RII (degree-2 node) until the graph is
trivial.  If nodes of degree >= 3 remain, it either

* branches exactly (branch-and-bound over the smallest-domain high-degree
  node, re-entering the reduction engine on each sub-problem), or
* applies the RN heuristic (locally-minimal choice, not optimality
  preserving) when ``exact=False`` or the B&B budget is exhausted.

Infinite costs (``np.inf``) encode illegal combinations (e.g. no chain of
layout transformations exists between two layouts).  The solver treats a
fully-infinite optimum as infeasibility and raises :class:`Infeasible`.

The implementation is pure numpy — it runs in micro/milliseconds for
DNN-sized graphs (the paper reports < 1s per network; we match that, see
benchmarks/bench_solver.py).

docs/solver.md walks through the reductions, the branch-and-bound
pruning argument, and warm starting with a small worked example.
"""
from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from ..obs.trace import get_tracer

__all__ = [
    "PBQP",
    "Solution",
    "Infeasible",
    "solve",
    "solve_warm",
    "brute_force",
]


class Infeasible(Exception):
    """Raised when every full assignment has infinite cost."""


@dataclass
class Solution:
    """Result of a PBQP solve."""

    cost: float
    assignment: Dict[Hashable, int]
    #: True if produced purely by optimality-preserving reductions / exact
    #: branch-and-bound; False if the RN heuristic fired.
    optimal: bool
    #: number of reduction steps of each kind, for diagnostics
    stats: Dict[str, int] = field(default_factory=dict)


class PBQP:
    """A PBQP problem instance under construction.

    Nodes are identified by arbitrary hashable ids.  Edge matrices are
    oriented: ``add_edge(u, v, M)`` means ``M[i, j]`` is the cost of
    assigning choice ``i`` to ``u`` and choice ``j`` to ``v``.  Parallel
    edges are summed.
    """

    def __init__(self) -> None:
        self._costs: Dict[Hashable, np.ndarray] = {}
        self._edges: Dict[Tuple[Hashable, Hashable], np.ndarray] = {}

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def add_node(self, u: Hashable, costs: Sequence[float]) -> None:
        c = np.asarray(costs, dtype=np.float64)
        if c.ndim != 1 or c.size == 0:
            raise ValueError(f"node {u!r}: cost vector must be 1-D, non-empty")
        if u in self._costs:
            raise ValueError(f"duplicate node {u!r}")
        self._costs[u] = c.copy()

    def add_edge(self, u: Hashable, v: Hashable, matrix: np.ndarray) -> None:
        for node in (u, v):
            if node not in self._costs:
                raise ValueError(
                    f"edge {u!r}->{v!r}: unknown node {node!r}")
        if u == v:
            # A self loop is just a node-cost adjustment along the diagonal.
            M = np.asarray(matrix, dtype=np.float64)
            k = len(self._costs[u])
            if M.shape != (k, k):
                raise ValueError(
                    f"edge {u!r}->{v!r}: matrix shape {M.shape} "
                    f"incompatible with domains ({k}, {k})")
            self._costs[u] = self._costs[u] + np.diag(M)
            return
        M = np.asarray(matrix, dtype=np.float64)
        ku, kv = len(self._costs[u]), len(self._costs[v])
        key, mat = ((u, v), M) if self._key_lt(u, v) else ((v, u), M.T)
        a, b = key
        if mat.shape != (len(self._costs[a]), len(self._costs[b])):
            raise ValueError(
                f"edge {u!r}->{v!r}: matrix shape {M.shape} incompatible with "
                f"domains ({ku}, {kv})"
            )
        if key in self._edges:
            self._edges[key] = self._edges[key] + mat
        else:
            self._edges[key] = mat.copy()

    def set_node_cost(self, u: Hashable, costs: Sequence[float]) -> None:
        """Replace node ``u``'s cost vector in place (same domain size).

        This is the mutation hook of the incremental re-solve workflow:
        neighbouring serving buckets share graph structure and differ only
        in a subset of node cost vectors, so callers update those vectors
        and re-solve with :func:`solve_warm`.
        """
        c = np.asarray(costs, dtype=np.float64)
        if u not in self._costs:
            raise KeyError(f"unknown node {u!r}")
        if c.shape != self._costs[u].shape:
            raise ValueError(
                f"node {u!r}: new cost shape {c.shape} != {self._costs[u].shape}")
        self._costs[u] = c.copy()

    def copy(self) -> "PBQP":
        new = PBQP()
        new._costs = {u: c.copy() for u, c in self._costs.items()}
        new._edges = {k: M.copy() for k, M in self._edges.items()}
        return new

    @staticmethod
    def _key_lt(u, v) -> bool:
        return str((type(u).__name__, u)) < str((type(v).__name__, v))

    # ------------------------------------------------------------------
    # accessors
    # ------------------------------------------------------------------
    @property
    def nodes(self) -> List[Hashable]:
        return list(self._costs)

    def domain(self, u: Hashable) -> int:
        return len(self._costs[u])

    def node_cost(self, u: Hashable) -> np.ndarray:
        return self._costs[u]

    def edge_cost(self, u: Hashable, v: Hashable) -> Optional[np.ndarray]:
        if self._key_lt(u, v):
            M = self._edges.get((u, v))
            return M
        M = self._edges.get((v, u))
        return None if M is None else M.T

    def evaluate(self, assignment: Dict[Hashable, int]) -> float:
        """Total cost of a full assignment."""
        total = 0.0
        for u, c in self._costs.items():
            total += c[assignment[u]]
        for (u, v), M in self._edges.items():
            total += M[assignment[u], assignment[v]]
        return float(total)

    # ------------------------------------------------------------------
    def solve(self, exact: bool = True, bb_budget: int = 200_000,
              deadline_s: Optional[float] = None) -> Solution:
        return solve(self, exact=exact, bb_budget=bb_budget,
                     deadline_s=deadline_s)

    def solve_warm(self, warm: Dict[Hashable, int], *, exact: bool = True,
                   bb_budget: int = 200_000,
                   deadline_s: Optional[float] = None) -> Solution:
        return solve_warm(self, warm, exact=exact, bb_budget=bb_budget,
                          deadline_s=deadline_s)


# ----------------------------------------------------------------------
# solver internals: work on a mutable adjacency representation
# ----------------------------------------------------------------------
class _Graph:
    def __init__(self, pb: PBQP):
        self.costs: Dict[Hashable, np.ndarray] = {u: c.copy() for u, c in pb._costs.items()}
        # adj[u][v] = matrix oriented (u, v)
        self.adj: Dict[Hashable, Dict[Hashable, np.ndarray]] = {u: {} for u in self.costs}
        for (u, v), M in pb._edges.items():
            self.adj[u][v] = M.copy()
            self.adj[v][u] = M.T  # view; kept consistent manually below
        self.base = 0.0  # accumulated constant cost

    def degree(self, u) -> int:
        return len(self.adj[u])

    def remove_node(self, u) -> None:
        for v in list(self.adj[u]):
            del self.adj[v][u]
        del self.adj[u]
        del self.costs[u]

    def set_edge(self, u, v, M: np.ndarray) -> None:
        self.adj[u][v] = M
        self.adj[v][u] = M.T

    def add_to_edge(self, u, v, M: np.ndarray) -> None:
        if v in self.adj[u]:
            self.set_edge(u, v, self.adj[u][v] + M)
        else:
            self.set_edge(u, v, M)

    def prune_trivial_edges(self) -> None:
        """Drop edges whose matrix is constant (fold the constant into base)."""
        for u in list(self.adj):
            for v in list(self.adj[u]):
                M = self.adj[u][v]
                finite = M[np.isfinite(M)]
                if finite.size == M.size and M.size and np.all(M == M.flat[0]):
                    self.base += float(M.flat[0])
                    del self.adj[u][v]
                    del self.adj[v][u]


def solve(pb: PBQP, exact: bool = True, bb_budget: int = 200_000,
          upper_bound: Optional[float] = None,
          deadline_s: Optional[float] = None) -> Solution:
    """Solve a PBQP instance.

    exact=True attempts an exact solve: RI/RII reductions are always
    optimality preserving; remaining degree->=3 nodes are handled by
    branch-and-bound with a node budget.  If the budget is exhausted the
    solver falls back to the RN heuristic for the remaining component and
    flags the solution as non-optimal.

    ``upper_bound`` is an optional *achievable* total-cost bound (e.g. the
    cost of a known feasible assignment).  Branch-and-bound prunes any
    sub-problem whose admissible lower bound strictly exceeds it, which is
    optimality preserving: the branch containing an optimum has a lower
    bound <= optimum <= upper_bound and thus survives.

    ``deadline_s`` makes the solve *anytime*: a wall-clock allowance
    (relative seconds) checked at every branch-and-bound entry.  When it
    expires, the search stops where it is and the RN heuristic completes
    the remaining component — a valid full assignment comes back no
    matter how hard the instance is, flagged ``optimal=False`` with
    ``stats["DEADLINE"] = 1``.  Exhausting ``bb_budget`` degrades the
    same way; neither ever raises.  This is the serving fallback
    ladder's "heuristic solve under a deadline" rung
    (docs/reliability.md).

    Emits a ``pbqp.solve`` trace span (repro.obs.trace) carrying the
    instance size and the B&B work actually done: ``bb`` nodes entered,
    ``prunes`` sub-problems cut by the bound test.
    """
    with get_tracer().span("pbqp.solve", nodes=len(pb._costs),
                           edges=len(pb._edges),
                           warm=upper_bound is not None) as sp:
        sol = _solve_impl(pb, exact, bb_budget, upper_bound, deadline_s)
        sp.set(cost=sol.cost, optimal=sol.optimal,
               bb=sol.stats.get("BB", 0),
               prunes=sol.stats.get("PRUNE", 0),
               deadline=sol.stats.get("DEADLINE", 0))
        return sol


def _solve_impl(pb: PBQP, exact: bool, bb_budget: int,
                upper_bound: Optional[float],
                deadline_s: Optional[float] = None) -> Solution:
    g = _Graph(pb)
    g.prune_trivial_edges()
    stats = {"R0": 0, "RI": 0, "RII": 0, "RN": 0, "BB": 0, "PRUNE": 0}
    t_end = (time.perf_counter() + deadline_s) \
        if deadline_s is not None else None
    # backtrack stack: callables applied in reverse to extend assignment
    trail: List[Callable[[Dict[Hashable, int]], None]] = []
    optimal = True

    budget = [bb_budget]

    def reduce_all() -> None:
        """Apply R0/RI/RII to a fixpoint."""
        work = [u for u in g.costs if g.degree(u) <= 2]
        in_work = set(work)
        while work:
            u = work.pop()
            in_work.discard(u)
            if u not in g.costs:
                continue
            d = g.degree(u)
            if d > 2:
                continue
            if d == 0:
                _r0(g, u, trail, stats)
            elif d == 1:
                v = _ri(g, u, trail, stats)
                if g.degree(v) <= 2 and v not in in_work:
                    work.append(v)
                    in_work.add(v)
            else:
                v, w = _rii(g, u, trail, stats)
                for n in (v, w):
                    if n in g.costs and g.degree(n) <= 2 and n not in in_work:
                        work.append(n)
                        in_work.add(n)

    reduce_all()

    while g.costs:
        # All remaining nodes have degree >= 3.
        if exact and budget[0] > 0 and not _expired(t_end):
            ok = _branch_and_bound(g, trail, stats, budget, upper_bound,
                                   t_end)
            if not ok:
                optimal = False
                if _expired(t_end):
                    stats["DEADLINE"] = 1
                _rn(g, trail, stats)
        else:
            optimal = False
            if _expired(t_end):
                stats["DEADLINE"] = 1
            _rn(g, trail, stats)
        reduce_all()

    if not np.isfinite(g.base):
        raise Infeasible("every assignment has infinite cost")

    assignment: Dict[Hashable, int] = {}
    for bt in reversed(trail):
        bt(assignment)
    cost = pb.evaluate(assignment)
    if not np.isfinite(cost):
        raise Infeasible("optimal assignment has infinite cost")
    return Solution(cost=cost, assignment=assignment, optimal=optimal, stats=stats)


def solve_warm(pb: PBQP, warm: Optional[Dict[Hashable, int]], *,
               exact: bool = True, bb_budget: int = 200_000,
               deadline_s: Optional[float] = None) -> Solution:
    """Incremental re-solve seeded by a previous solution.

    ``warm`` is a (possibly stale) full assignment — typically the optimum
    of a neighbouring instance that shares this instance's graph but had
    different node cost vectors.  Its cost *on this instance* is a valid
    achievable upper bound, so branch-and-bound starts with a tight
    incumbent instead of infinity and prunes most of the search tree.  The
    reductions (R0/RI/RII) and the bound-pruning are all optimality
    preserving, so the result is exactly as optimal as a fresh
    ``solve(exact=True)`` (verified bit-identical-cost in
    tests/test_warm_start.py).

    An invalid or infeasible warm assignment silently degrades to a cold
    solve — warm starting is a pure acceleration, never a correctness
    hazard.  ``stats['WARM']`` records whether the bound was usable;
    ``stats['WARM_DIST']`` the seed distance (number of nodes where the
    final assignment differs from the warm seed — 0 means the seed was
    already optimal for this instance).  A ``pbqp.solve_warm`` trace
    span reports both, around the inner ``pbqp.solve`` span.
    """
    with get_tracer().span("pbqp.solve_warm",
                           nodes=len(pb._costs)) as sp:
        ub: Optional[float] = None
        if warm is not None and set(warm) == set(pb._costs):
            if all(0 <= warm[u] < pb.domain(u) for u in warm):
                cand = pb.evaluate(warm)
                if np.isfinite(cand):
                    ub = cand
        sol = solve(pb, exact=exact, bb_budget=bb_budget, upper_bound=ub,
                    deadline_s=deadline_s)
        sol.stats["WARM"] = int(ub is not None)
        sol.stats["WARM_DIST"] = (
            sum(1 for u, i in sol.assignment.items() if warm[u] != i)
            if ub is not None else len(sol.assignment))
        sp.set(warm=sol.stats["WARM"], warm_dist=sol.stats["WARM_DIST"],
               bb=sol.stats.get("BB", 0),
               prunes=sol.stats.get("PRUNE", 0))
        return sol


def _r0(g: _Graph, u, trail, stats) -> None:
    c = g.costs[u]
    i = int(np.argmin(c))
    g.base += float(c[i])
    g.remove_node(u)
    stats["R0"] += 1
    trail.append(lambda asg, u=u, i=i: asg.__setitem__(u, i))


def _ri(g: _Graph, u, trail, stats):
    """Degree-1 reduction: fold u into its unique neighbour v."""
    (v, M), = g.adj[u].items()  # M oriented (u, v)
    cu = g.costs[u]
    # delta[j] = min_i cu[i] + M[i, j]; keep the argmin for backtracking
    tot = cu[:, None] + M
    best_i = np.argmin(tot, axis=0)
    delta = tot[best_i, np.arange(tot.shape[1])]
    g.costs[v] = g.costs[v] + delta
    g.remove_node(u)
    stats["RI"] += 1

    def bt(asg, u=u, v=v, best_i=best_i):
        asg[u] = int(best_i[asg[v]])

    trail.append(bt)
    return v


def _rii(g: _Graph, u, trail, stats):
    """Degree-2 reduction: fold u into an edge between its neighbours."""
    (v, Mv), (w, Mw) = g.adj[u].items()  # oriented (u, v), (u, w)
    cu = g.costs[u]
    kv, kw = Mv.shape[1], Mw.shape[1]
    # tot[i, j, k] = cu[i] + Mv[i, j] + Mw[i, k]
    tot = cu[:, None, None] + Mv[:, :, None] + Mw[:, None, :]
    best_i = np.argmin(tot, axis=0)  # (kv, kw)
    delta = np.min(tot, axis=0)
    g.remove_node(u)
    g.add_to_edge(v, w, delta)  # oriented (v, w)
    stats["RII"] += 1

    def bt(asg, u=u, v=v, w=w, best_i=best_i):
        asg[u] = int(best_i[asg[v], asg[w]])

    trail.append(bt)
    return v, w


def _rn(g: _Graph, trail, stats) -> None:
    """Heuristic reduction of one degree->=3 node (not optimality preserving).

    Picks the max-degree node and the assignment minimising its local cost
    (node cost + sum over neighbours of the best-case edge+neighbour cost),
    then folds the fixed choice's edge rows into the neighbours' vectors.
    """
    u = max(g.costs, key=lambda n: (g.degree(n), -g.costs[n].size))
    cu = g.costs[u].copy()
    local = cu.copy()
    for v, M in g.adj[u].items():
        local = local + np.min(M + g.costs[v][None, :], axis=1)
    i = int(np.argmin(local))
    g.base += float(cu[i])
    for v, M in list(g.adj[u].items()):
        g.costs[v] = g.costs[v] + M[i, :]
    g.remove_node(u)
    stats["RN"] += 1
    trail.append(lambda asg, u=u, i=i: asg.__setitem__(u, i))


def _expired(t_end: Optional[float]) -> bool:
    """Has the anytime wall-clock deadline passed?  (None: never.)"""
    return t_end is not None and time.perf_counter() >= t_end


def _lower_bound(g: _Graph) -> float:
    """Cheap admissible lower bound: node minima + half edge minima."""
    lb = g.base
    for c in g.costs.values():
        lb += float(np.min(c))
    for u in g.adj:
        for v, M in g.adj[u].items():
            if str((type(u).__name__, u)) < str((type(v).__name__, v)):
                lb += float(np.min(M))
    return lb


def _branch_and_bound(g: _Graph, trail, stats, budget,
                      ub: Optional[float] = None,
                      t_end: Optional[float] = None) -> bool:
    """Exactly resolve ONE degree->=3 node by enumerating its domain.

    For each choice we recursively solve the reduced sub-problem (full
    solver recursion on a copy).  Returns False if the budget or the
    wall-clock deadline (``t_end``, absolute perf_counter seconds) is
    exhausted (caller falls back to RN).  ``ub`` is an optional
    achievable global upper bound (warm start); sub-problems with lower
    bound > ub are pruned without losing any optimum.
    """
    # Pick the highest-degree node with the smallest domain: cheap to
    # enumerate, high simplification payoff.
    u = min(g.costs, key=lambda n: (g.costs[n].size, -g.degree(n)))
    k = g.costs[u].size
    if budget[0] < k or _expired(t_end):
        return False
    budget[0] -= k
    stats["BB"] += 1

    best_cost = np.inf
    best_choice = -1
    best_sub: Optional[Tuple[List[Callable], Dict]] = None

    for i in range(k):
        if not np.isfinite(g.costs[u][i]):
            continue
        sub = _clone(g)
        # fix u := i
        sub.base += float(sub.costs[u][i])
        for v, M in list(sub.adj[u].items()):
            sub.costs[v] = sub.costs[v] + M[i, :]
        sub.remove_node(u)
        lb = _lower_bound(sub)
        # ub tolerance: lb and the warm cost are summed in different
        # orders, so an exactly-optimal warm bound could otherwise prune
        # the optimal branch by a rounding ulp (-> spurious Infeasible).
        if lb >= best_cost or \
                (ub is not None and lb > ub + 1e-9 * max(1.0, abs(ub))):
            stats["PRUNE"] += 1
            continue
        sub_trail: List[Callable] = []
        sub_stats = {"R0": 0, "RI": 0, "RII": 0, "RN": 0, "BB": 0,
                     "PRUNE": 0}
        ok = _solve_rec(sub, sub_trail, sub_stats, budget, ub, t_end)
        if not ok:
            return False
        if sub.base < best_cost:
            best_cost = sub.base
            best_choice = i
            best_sub = (sub_trail, sub_stats)

    if best_choice < 0:
        # Every choice of u is infinite (or every branch infeasible):
        # this whole component has no finite assignment.  Record a
        # *total* fallback assignment covering u AND every remaining
        # node — an empty sub-trail would leave those nodes out of the
        # assignment and turn the top-level ``pb.evaluate`` into a
        # KeyError; with the trail complete, evaluate() reports inf and
        # solve() raises Infeasible (its base check fires first anyway,
        # since base becomes inf below).
        remaining = [n for n in g.costs if n != u]
        best_choice = 0
        best_sub = ([lambda asg, ns=tuple(remaining):
                     asg.update({n: 0 for n in ns})], {})
        best_cost = np.inf

    sub_trail, sub_stats = best_sub
    for key, val in sub_stats.items():
        stats[key] += val
    # Splice: u's choice, then the winning sub-problem's backtracks.
    trail.append(lambda asg, u=u, i=best_choice: asg.__setitem__(u, i))
    trail.extend(sub_trail)
    # Mutate g to empty: the sub-solve has fully consumed the graph.
    g.costs.clear()
    g.adj.clear()
    g.base = best_cost
    return True


def _solve_rec(g: _Graph, trail, stats, budget,
               ub: Optional[float] = None,
               t_end: Optional[float] = None) -> bool:
    """Run reductions + B&B to completion on g (used inside B&B)."""
    def reduce_all():
        work = [u for u in g.costs if g.degree(u) <= 2]
        in_work = set(work)
        while work:
            u = work.pop()
            in_work.discard(u)
            if u not in g.costs:
                continue
            d = g.degree(u)
            if d > 2:
                continue
            if d == 0:
                _r0(g, u, trail, stats)
            elif d == 1:
                v = _ri(g, u, trail, stats)
                if g.degree(v) <= 2 and v not in in_work:
                    work.append(v); in_work.add(v)
            else:
                v, w = _rii(g, u, trail, stats)
                for n in (v, w):
                    if n in g.costs and g.degree(n) <= 2 and n not in in_work:
                        work.append(n); in_work.add(n)

    reduce_all()
    while g.costs:
        if budget[0] <= 0 or _expired(t_end):
            return False
        if not _branch_and_bound(g, trail, stats, budget, ub, t_end):
            return False
        reduce_all()
    return True


def _clone(g: _Graph) -> _Graph:
    new = _Graph.__new__(_Graph)
    new.costs = {u: c.copy() for u, c in g.costs.items()}
    new.adj = {u: {} for u in g.costs}
    seen = set()
    for u in g.adj:
        for v, M in g.adj[u].items():
            if (v, u) in seen:
                continue
            seen.add((u, v))
            new.adj[u][v] = M.copy()
            new.adj[v][u] = new.adj[u][v].T
    new.base = g.base
    return new


# ----------------------------------------------------------------------
# brute force (testing oracle)
# ----------------------------------------------------------------------
def brute_force(pb: PBQP) -> Solution:
    """Exhaustive minimum — exponential; for testing only."""
    nodes = pb.nodes
    domains = [range(pb.domain(u)) for u in nodes]
    best = np.inf
    best_asg: Optional[Dict[Hashable, int]] = None
    for combo in itertools.product(*domains):
        asg = dict(zip(nodes, combo))
        c = pb.evaluate(asg)
        if c < best:
            best = c
            best_asg = asg
    if best_asg is None or not np.isfinite(best):
        raise Infeasible("every assignment has infinite cost")
    return Solution(cost=float(best), assignment=best_asg, optimal=True)
