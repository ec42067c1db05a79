"""Logical-axis sharding plans — the LM-side 'data layout' abstraction.

Port of the reference's ``models/sharding.py``.  Models annotate tensors
with *logical* axes; a :class:`Rules` mapping (logical axis -> mesh axis)
resolves annotations to concrete partition specs, here plain tuples (one
entry per dimension: a mesh axis, a tuple of them, or None).

The port runs on one device: :class:`ShardingPlan` without a mesh makes
:meth:`~ShardingPlan.constrain` the identity, as the reference's does,
and a mesh is refused until the ROADMAP's slice G2 brings the LM mesh
to the port.

:func:`init_from_defs` draws the reference's distributions from a
``torch.Generator``: the values differ from those of the reference's
random keys, so parity tests carry the reference's parameters across
(``models.params_from_numpy``), never the seed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from ..kernels.common import resolve_device

MeshAxes = Union[None, str, Tuple[str, ...]]

__all__ = ["Rules", "ShardingPlan", "PDef", "init_from_defs",
           "pspecs_from_defs", "map_defs", "MEGATRON_RULES",
           "REPLICATED_RULES"]


@dataclass(frozen=True)
class Rules:
    """Logical axis -> mesh axis mapping (MaxText-style rules)."""

    table: Tuple[Tuple[str, MeshAxes], ...] = ()

    def get(self, logical: str) -> MeshAxes:
        for k, v in self.table:
            if k == logical:
                return v
        return None

    def spec(self, axes: Sequence[Optional[str]]) -> Tuple[MeshAxes, ...]:
        used = set()
        parts = []
        for a in axes:
            m = self.get(a) if a else None
            # a mesh axis may appear at most once in a partition spec
            if m is None:
                parts.append(None)
                continue
            ms = (m,) if isinstance(m, str) else tuple(m)
            ms = tuple(x for x in ms if x not in used)
            used.update(ms)
            parts.append(ms if len(ms) > 1 else (ms[0] if ms else None))
        return tuple(parts)


#: canonical fixed-rule baselines (the LM analogue of the paper's
#: "local optimal": one canonical layout everywhere)
MEGATRON_RULES = Rules((
    ("batch", ("pod", "data")),
    ("seq", None),
    ("d_model", None),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("head_dim", None),
    ("d_ff", "model"),
    ("experts", "model"),
    ("vocab", "model"),
    ("layers", None),
    ("ssm_heads", "model"),
    ("ssm_state", None),
    ("enc_seq", None),
    ("kv_seq", None),
))

REPLICATED_RULES = Rules((
    ("batch", ("pod", "data")),
))


@dataclass
class ShardingPlan:
    """Resolved plan: mesh + rules (+ per-annotation overrides).

    Single-device only: ``mesh`` must be None (LM meshes are slice
    G2)."""

    mesh: Optional[Any] = None
    rules: Rules = MEGATRON_RULES
    overrides: Dict[str, Tuple] = field(default_factory=dict)

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "mesh-sharded LM plans are not ported yet (ROADMAP slice "
                "G2); use ShardingPlan(mesh=None)")

    def constrain(self, x, *axes: Optional[str], name: str = ""):
        """Annotate an activation with logical axes: the identity on one
        device."""
        return x


# ----------------------------------------------------------------------
# parameter definitions: single source of truth for shapes, logical
# axes, initialisation, and shardings
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class PDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"   # normal | zeros | ones | scaled
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes)


def map_defs(fn, tree):
    """``fn`` on every :class:`PDef` leaf of a nested dict, in the
    reference's (sorted-key) leaf order."""
    if isinstance(tree, PDef):
        return fn(tree)
    return {k: map_defs(fn, tree[k]) for k in sorted(tree)}


def _init_leaf(gen: torch.Generator, d: PDef, dtype, device):
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    fan_in = d.shape[0]
    std = d.scale / math.sqrt(max(fan_in, 1))
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * std).to(device=device, dtype=dtype)


def init_from_defs(defs, seed: int, dtype=torch.bfloat16, device=None):
    """defs: nested dict of PDef -> same-structure dict of tensors on
    ``device`` (the card unless told otherwise), drawn from one
    generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return map_defs(lambda d: _init_leaf(gen, d, dtype, dev), defs)


def pspecs_from_defs(defs, rules: Rules):
    return map_defs(lambda d: rules.spec(d.axes), defs)
