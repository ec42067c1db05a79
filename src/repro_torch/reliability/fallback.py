"""The solve-side fallback ladder: exact -> anytime -> greedy -> reference.

De Prado et al. (PAPERS.md) observe that search-based primitive
selection is only deployable with a fallback to known-good primitives;
this module is that ladder for the PBQP serve path.  Each rung trades
plan quality for availability and is strictly harder to break than the
one above it:

========== ===========================================================
rung       what runs
========== ===========================================================
exact      ``select_pbqp(exact=True)`` — the paper's optimum (possibly
           warm-started), finished within budget and deadline
anytime    the same solve, degraded: the wall-clock deadline or B&B
           budget expired and the RN heuristic completed the
           assignment best-so-far (``optimal=False``) — also the rung
           a server configured with ``exact=False`` always serves from
greedy     :func:`~repro.core.selection.select_local_optimal` — the
           paper's canonical-layout baseline; no branch-and-bound, no
           edge reasoning, millisecond-safe
reference  :func:`reference_selection` — hand-built plan on the
           textbook ``sum2d`` jnp primitive in CHW everywhere; no
           solver involvement at all, cannot fail as long as the net
           itself is well-formed
========== ===========================================================

Every demotion is counted in the metrics registry (``ladder_<rung>``
counters) and emitted as a trace event, so a fleet quietly serving
greedy plans is visible in ``tools/obs_report.py`` long before anyone
reads a log.  A :class:`~repro.reliability.faults.FaultInjector` can
fail the solve rung (kind ``raise``) or shrink its B&B budget (kind
``budget``) to force demotions deterministically.
"""
from __future__ import annotations

import random
import time
from typing import AbstractSet, Callable, Dict, Optional, Tuple

import numpy as np

from ..core.costs import CostModel
from ..core.graph import Net
from ..core.layouts import default_dt_graph
from ..core.selection import (Choice, SelectionResult,
                              select_local_optimal, select_pbqp)
from ..obs.trace import get_tracer
from .errors import InjectedFault
from .faults import FaultInjector

__all__ = ["RUNGS", "FallbackLadder", "reference_selection", "retry_call"]

#: ladder rungs, best to last-resort; counter names are ``ladder_<rung>``
RUNGS = ("exact", "anytime", "greedy", "reference")


class FallbackLadder:
    """Run a selection down the ladder until a rung holds.

    Parameters
    ----------
    cost:
        Cost model for every rung that prices anything.
    exact:
        Rung-0 solver mode (a ``False`` server never produces the
        ``exact`` rung — its solves classify as ``anytime``).
    deadline_s:
        Wall-clock allowance per solve; makes branch-and-bound anytime
        (None: no deadline, budget only).
    bb_budget:
        Branch-and-bound node budget for the solve rung.
    counters:
        Optional :class:`~repro.serving.metrics.ServingCounters`-style
        sink; each selection bumps ``ladder_<rung>``.
    fault_injector:
        Optional chaos hook (site ``solve``).
    """

    def __init__(self, cost: CostModel, *, exact: bool = True,
                 deadline_s: Optional[float] = None,
                 bb_budget: int = 200_000,
                 counters=None,
                 fault_injector: Optional[FaultInjector] = None) -> None:
        self.cost = cost
        self.exact = exact
        self.deadline_s = deadline_s
        self.bb_budget = int(bb_budget)
        self.counters = counters
        self.faults = fault_injector

    # -----------------------------------------------------------------
    def select(self, net: Net, *, bucket: str = "",
               warm_start: Optional[SelectionResult] = None,
               fuse: bool = False,
               mesh_axes: Optional[Dict[str, int]] = None,
               banned: Optional[AbstractSet[str]] = None
               ) -> Tuple[SelectionResult, str]:
        """Select a plan for ``net``, degrading as needed.

        Returns ``(selection, rung)``.  Never raises short of the
        reference rung itself failing (a malformed net).
        """
        budget = self.bb_budget
        fail_solve = False
        if self.faults is not None:
            spec = self.faults.check("solve", key=bucket)
            if spec is not None:
                if spec.kind == "budget":
                    budget = max(0, int(spec.value))
                else:
                    fail_solve = True
        sel: Optional[SelectionResult] = None
        rung = "reference"
        try:
            if fail_solve:
                raise InjectedFault("solve", "raise", bucket)
            sel = select_pbqp(net, self.cost, exact=self.exact,
                              warm_start=warm_start, fuse=fuse,
                              mesh_axes=mesh_axes, banned=banned,
                              deadline_s=self.deadline_s,
                              bb_budget=budget)
            rung = "exact" if sel.optimal else "anytime"
        except Exception:
            try:
                sel = select_local_optimal(net, self.cost, banned=banned)
                rung = "greedy"
            except Exception:
                sel = reference_selection(net, self.cost)
                rung = "reference"
        if self.counters is not None:
            self.counters.add(**{f"ladder_{rung}": 1})
        if rung != "exact":
            # demotions are span *events*: cheap, always-on, and they
            # surface in trace summaries next to the solve spans
            now = time.perf_counter()
            get_tracer().emit("ladder_demotion", now, now,
                              rung=rung, bucket=bucket)
        return sel, rung


# ----------------------------------------------------------------------
def reference_selection(net: Net,
                        cost: Optional[CostModel] = None
                        ) -> SelectionResult:
    """Solver-free last-resort plan: ``sum2d`` in CHW, everywhere.

    Builds the assignment by hand — the textbook jnp reference
    primitive for every conv node, CHW layouts wherever the op allows
    them — and legalizes the few mismatched edges over the default DT
    graph.  No PBQP instance, no reductions, no cost-model pricing on
    the critical path (``cost`` only prices ``predicted_cost`` for
    observability; any pricing failure degrades to a nominal constant,
    never an exception).
    """
    from ..core.primitives import registry
    ref = next(p for p in registry() if p.name == "sum2d")
    choices: Dict[str, Choice] = {}
    for nid in net.order:
        node = net.nodes[nid]
        if node.kind == "conv":
            choices[nid] = Choice(ref, ref.l_in, ref.l_out)
        elif node.kind == "input":
            choices[nid] = Choice(None, "CHW", "CHW")
        else:
            lay = "CHW" if "CHW" in node.op.layouts else node.op.layouts[0]
            choices[nid] = Choice(None, lay, lay)

    try:
        dt = cost.dt_graph() if cost is not None else default_dt_graph()
    except Exception:
        dt = default_dt_graph()
    conversions: Dict[Tuple[str, str], list] = {}
    for (src, dst) in net.edges():
        lo, li = choices[src].l_out, choices[dst].l_in
        if lo == li:
            continue
        shape = net.nodes[src].out_shape
        chain = dt.shortest_chain(lo, li, shape)
        if chain is None:
            raise RuntimeError(
                f"reference plan: no DT path {lo}->{li} on edge "
                f"{src}->{dst}")
        conversions[(src, dst)] = list(chain)

    predicted = 1e-3
    if cost is not None:
        try:
            nb = max((n.scn.n for n in net.conv_nodes()), default=1)
            total = sum(float(cost.primitive_cost(ref, n.scn))
                        for n in net.conv_nodes())
            for (src, dst), chain in conversions.items():
                shape = net.nodes[src].out_shape
                total += nb * sum(
                    float(cost.transform_cost(a, b, shape, "float32"))
                    for a, b in zip(chain, chain[1:]))
            if np.isfinite(total) and total > 0:
                predicted = total
        except Exception:
            pass
    return SelectionResult(net=net, choices=choices,
                           conversions=conversions,
                           predicted_cost=predicted, optimal=False,
                           strategy="reference", solver_stats={})


# ----------------------------------------------------------------------
def retry_call(fn: Callable, *, retries: int, base_delay_s: float,
               rng: Optional[random.Random] = None,
               on_retry: Optional[Callable[[int, BaseException],
                                           None]] = None):
    """Bounded retry with jittered exponential backoff.

    Runs ``fn()`` up to ``1 + retries`` times.  Attempt ``k`` (1-based)
    sleeps ``base_delay_s * 2**(k-1) * U[1, 2)`` first — the jitter is
    drawn from ``rng`` (seeded by the caller) so chaos runs replay
    deterministically.  ``on_retry(attempt, exc)`` fires before each
    sleep; the final failure re-raises.
    """
    if retries < 0:
        raise ValueError("retries must be >= 0")
    rng = rng or random.Random()
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as exc:
            attempt += 1
            if attempt > retries:
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            time.sleep(base_delay_s * (2 ** (attempt - 1))
                       * (1.0 + rng.random()))
