"""Pareto dominance pruning over the bucket sweep.

A generated variant earns a registry slot only if there is at least one
scenario bucket where nothing else (hand-written entry or sibling
variant) is at least as good everywhere and better somewhere.  Pruning
is restricted to *groups* of candidates with identical PBQP-visible
structure — same layouts, same fusable sets, same support over the
sweep buckets — so removing a dominated candidate only removes
node-cost columns that another candidate weakly improves on: the PBQP
optimum provably never needs the pruned variant (the property tests in
tests/test_autotune.py check exactly this).

The rule is deterministic and order-free: candidate ``v`` is pruned iff
some candidate ``u`` in the same group covers ``v``'s buckets with
``cost_u <= cost_v`` everywhere, and either is strictly better
somewhere or ties everywhere and wins the name tiebreak (hand-written
entries always win ties).  Measurement order cannot change the result —
only the (key -> cost) table matters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

from ..core.primitives import Primitive
from ..core.scenario import Scenario

__all__ = ["Candidate", "candidates_from_costs", "prune_dominated",
           "group_key"]


def group_key(prim: Primitive,
              support: Tuple[str, ...]) -> Hashable:
    """Candidates are comparable only within identical PBQP structure."""
    return (prim.family, prim.l_in, prim.l_out,
            tuple(prim.fusable_in), tuple(prim.fusable_out), support)


@dataclass(frozen=True)
class Candidate:
    """One entrant in the dominance tournament."""

    name: str
    #: hand-written entries compete but are never pruned
    prunable: bool
    group: Hashable
    #: bucket key -> measured/priced seconds; missing = unsupported
    costs: Tuple[Tuple[str, float], ...]

    def cost_map(self) -> Dict[str, float]:
        return dict(self.costs)


def candidates_from_costs(prims: Sequence[Primitive],
                          buckets: Sequence[Scenario],
                          cost_of) -> List[Candidate]:
    """Build candidates from a cost lookup ``(prim, scn) -> float|None``
    (typically a tuned :class:`~repro.calibrate.profile.HardwareProfile`
    read through ``prim_cost_key``)."""
    out = []
    for p in prims:
        costs = []
        support = []
        for scn in buckets:
            if not p.supports(scn):
                continue
            support.append(scn.key())
            c = cost_of(p, scn)
            if c is not None and c == c and c != float("inf"):
                costs.append((scn.key(), float(c)))
        out.append(Candidate(name=p.name, prunable=bool(p.params),
                             group=group_key(p, tuple(support)),
                             costs=tuple(sorted(costs))))
    return out


def prune_dominated(cands: Sequence[Candidate]
                    ) -> Tuple[List[str], Dict[str, str]]:
    """Returns ``(survivor names, pruned name -> dominating name)``.

    Order-free: every candidate is compared against every other in its
    group; dominance (with the deterministic tiebreak) is transitive,
    so a candidate pruned by another pruned candidate is still covered
    by some survivor.
    """
    by_group: Dict[Hashable, List[Candidate]] = {}
    for c in sorted(cands, key=lambda c: c.name):
        by_group.setdefault(c.group, []).append(c)

    survivors: List[str] = []
    pruned: Dict[str, str] = {}
    for group in by_group.values():
        for v in group:
            if not v.prunable:
                survivors.append(v.name)
                continue
            vc = v.cost_map()
            dominator: Optional[str] = None
            for u in group:
                if u.name == v.name:
                    continue
                uc = u.cost_map()
                if not vc or not set(vc) <= set(uc):
                    continue
                if any(uc[b] > vc[b] for b in vc):
                    continue
                strict = any(uc[b] < vc[b] for b in vc)
                tie_win = (not strict
                           and (not u.prunable or u.name < v.name))
                if strict or tie_win:
                    dominator = u.name
                    break
            if dominator is None:
                survivors.append(v.name)
            else:
                pruned[v.name] = dominator
    return sorted(survivors), pruned
