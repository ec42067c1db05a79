"""Unified choice-space PBQP construction — one builder for every
transformation kind.

The paper's core claim is that implementation selection and data-format
transformation are ONE joint optimization problem.  This module is that
claim as code: a single, transform-kind-agnostic bridge from a *choice
space* (per-entity choice domains with setup costs, plus pluggable
transition pricing between adjacent entities) to a
:class:`~repro.core.pbqp.PBQP` instance.  Two very different selection
problems build through it:

* **Layout-level selection** (:mod:`repro.core.selection`): entities are
  the layers of a conv net, choices are primitives (or accepted layouts,
  for op nodes), and transitions price
  ``min(materialized DT conversion chain, fused prologue/epilogue)``.
* **Sharding-level selection** (:mod:`repro.core.sharding_select`):
  entities are the tensor groups of a transformer program, choices are
  sharding rule-sets, and transitions price resharding collectives —
  the "layout transformation" of the distributed world.

Either way the objective the solver sees is the paper's::

    sum_u setup(choice_u)  +  sum_{(u,v)} transition(choice_u, choice_v)

and the same exact reduction/branch-and-bound engine
(:func:`repro.core.pbqp.solve`) finds the global optimum.
``docs/distributed.md`` maps the two instantiations side by side.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (
    Any, Callable, Dict, Hashable, List, Sequence, Tuple,
)

import numpy as np

from . import pbqp

__all__ = ["ChoiceNode", "ChoiceEdge", "Placement", "build_pbqp",
           "drop_infinite"]


class Placement(str):
    """A device-placement choice, as a structured string.

    The placement axis of the choice space covers four kinds:

    ``rep``
        replicated — every device holds the full tensor/batch.
    ``dp``
        data-parallel — the batch is sharded over every non-stage mesh
        axis (``data`` x ``model`` flattened).
    ``tp``
        tensor-parallel — the batch is sharded over the ``data`` axis
        and conv weights are sharded over the ``model`` axis
        (output-channel split); the node pays the intra-node
        all-gather that reassembles the channel dimension.
    ``pp<stage>``
        pipeline-parallel — the node is resident on pipeline stage
        ``<stage>`` of the ``stage`` mesh axis; edges that cross a
        stage boundary pay the activation send.

    Subclassing :class:`str` keeps the whole pre-existing surface
    working unchanged: ``choice.placement == "dp"`` comparisons,
    dict/set hashing, JSON plan-cache round trips, and
    ``dataclasses.replace(choice, placement="dp")`` in tests all see a
    plain string.  The structure (``kind``, ``stage``) rides along as
    attributes.
    """

    KINDS = ("rep", "dp", "tp", "pp")

    def __new__(cls, kind: str, stage: int = 0):
        if kind not in cls.KINDS:
            raise ValueError(f"unknown placement kind {kind!r}")
        if kind == "pp":
            if stage < 0:
                raise ValueError(f"negative pipeline stage {stage}")
            s = f"pp{stage}"
        else:
            stage = 0
            s = kind
        self = super().__new__(cls, s)
        self.kind = kind
        self.stage = int(stage)
        return self

    @classmethod
    def parse(cls, s: "str | Placement") -> "Placement":
        """Recover the structured form from its canonical string
        (idempotent on :class:`Placement` instances)."""
        if isinstance(s, Placement):
            return s
        if s in ("rep", "dp", "tp"):
            return cls(s)
        if s.startswith("pp") and s[2:].isdigit():
            return cls("pp", int(s[2:]))
        raise ValueError(f"unparsable placement {s!r}")


@dataclass
class ChoiceNode:
    """One entity's choice domain.

    ``costs[i]`` is the setup cost of picking ``choices[i]`` for this
    entity alone (a primitive's invocation time; a sharding rule's
    intra-group collective time).  Infinite costs mark choices the
    solver may only take when nothing finite exists.
    """
    id: Hashable
    choices: Sequence[Any]
    costs: Sequence[float]

    def __post_init__(self):
        if len(self.choices) != len(self.costs):
            raise ValueError(
                f"node {self.id!r}: {len(self.choices)} choices but "
                f"{len(self.costs)} costs")
        if not self.choices:
            raise ValueError(f"node {self.id!r}: empty choice domain")


@dataclass
class ChoiceEdge:
    """Transition pricing between two adjacent entities.

    ``transition(cu, cv)`` returns the cost of moving data produced
    under choice ``cu`` (of ``src``) into the form choice ``cv`` (of
    ``dst``) consumes — a layout-conversion chain, a fused variant, a
    resharding collective, ``inf`` when no transformation exists.
    Scaling (minibatch, per-layer repeat counts) belongs inside
    ``transition``: both callers scale per pair.
    """
    src: Hashable
    dst: Hashable
    transition: Callable[[Any, Any], float]


def build_pbqp(nodes: Sequence[ChoiceNode], edges: Sequence[ChoiceEdge],
               ) -> Tuple[pbqp.PBQP, Dict[Hashable, List[Any]]]:
    """Materialize a choice space as a PBQP instance.

    Returns ``(problem, domains)`` where ``domains[id]`` lists the node's
    choice objects in the order the solver's assignment indexes them —
    the caller recovers the winning choices as
    ``{id: domains[id][sol.assignment[id]]}``.
    """
    pb = pbqp.PBQP()
    domains: Dict[Hashable, List[Any]] = {}
    for node in nodes:
        domains[node.id] = list(node.choices)
        pb.add_node(node.id, [float(c) for c in node.costs])
    for edge in edges:
        cu, cv = domains[edge.src], domains[edge.dst]
        M = np.empty((len(cu), len(cv)), dtype=np.float64)
        for i, a in enumerate(cu):
            for j, b in enumerate(cv):
                M[i, j] = edge.transition(a, b)
        pb.add_edge(edge.src, edge.dst, M)
    return pb, domains


def drop_infinite(entries: Sequence[Tuple[Any, float]]
                  ) -> List[Tuple[Any, float]]:
    """Drop infinite-cost choices — unless that would empty the domain.

    A domain of only-infinite choices is kept intact so the solver can
    report :class:`~repro.core.pbqp.Infeasible` (or legalize through
    edges) instead of the builder crashing on a degenerate instance.
    """
    finite = [(c, v) for (c, v) in entries if np.isfinite(v)]
    return finite or list(entries)
