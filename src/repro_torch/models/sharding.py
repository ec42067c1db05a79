"""Logical-axis sharding plans — the LM-side 'data layout' abstraction.

Port of the reference's ``models/sharding.py``.  Models annotate tensors
with *logical* axes; a :class:`Rules` mapping (logical axis -> mesh axis)
resolves annotations to concrete partition specs, here plain tuples (one
entry per dimension: a mesh axis, a tuple of them, or None).

The reference shards with GSPMD; the port's counterpart is DTensor
(``torch.distributed.tensor``).  A spec becomes one placement per mesh
dimension (``Shard(dim)`` where a tensor dimension names that mesh axis,
else ``Replicate()``; :meth:`ShardingPlan.placements`),
:meth:`~ShardingPlan.constrain` becomes ``redistribute`` to those
placements, and DTensor's sharding propagation inserts the collectives
in between.  Parameters are placed by :func:`place_params`: every rank
cuts its own shard from the same full values, so no weight crosses a
link.  The model code runs under :meth:`ShardingPlan.region`, where a
plain tensor meeting a DTensor (positions, masks) counts as replicated.
Without a mesh :meth:`~ShardingPlan.constrain` is the identity, as the
reference's is.

Two mesh axes on one tensor dimension (``("pod", "data")`` on the batch)
split it major to minor, as a JAX ``PartitionSpec`` does; DTensor splits
it in mesh-dimension order, so a spec must name its mesh axes in the
mesh's order (the rules' specs do), and :meth:`~ShardingPlan.placements`
refuses one that does not.

:func:`init_from_defs` draws the reference's distributions from a
``torch.Generator``: the values differ from those of the reference's
random keys, so parity tests carry the reference's parameters across
(``models.params_from_numpy``), never the seed.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels.common import resolve_device

MeshAxes = Union[None, str, Tuple[str, ...]]

__all__ = ["Rules", "ShardingPlan", "PDef", "init_from_defs",
           "pspecs_from_defs", "map_defs", "place_params",
           "shapestructs_from_defs", "MEGATRON_RULES", "REPLICATED_RULES"]


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

    def with_(self, **kw) -> "Rules":
        table = dict(self.table)
        table.update(kw)
        return Rules(tuple(table.items()))

    def restrict(self, mesh_axes) -> "Rules":
        """Drop mesh axes that don't exist on this mesh (e.g. 'pod' on
        the single-pod 16x16 mesh)."""
        mesh_axes = set(mesh_axes)

        def fix(v):
            if v is None:
                return None
            vs = (v,) if isinstance(v, str) else tuple(v)
            vs = tuple(x for x in vs if x in mesh_axes)
            if not vs:
                return None
            return vs[0] if len(vs) == 1 else vs

        return Rules(tuple((k, fix(v)) for k, v in self.table))

    def feasible(self, axes: Sequence[Optional[str]],
                 shape: Sequence[int], mesh_shape: Dict[str, int]) -> bool:
        """Divisibility check: each sharded dim must divide evenly."""
        for a, n in zip(axes, shape):
            m = self.get(a) if a else None
            if m is None:
                continue
            ms = (m,) if isinstance(m, str) else m
            total = int(np.prod([mesh_shape[x] for x in ms]))
            if n % total:
                return False
        return True


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

    ``mesh`` is a named ``DeviceMesh`` (``launch.mesh.make_mesh``) or
    None (one device)."""

    mesh: Optional[Any] = None
    rules: Rules = MEGATRON_RULES
    overrides: Dict[str, Tuple] = field(default_factory=dict)

    def __post_init__(self):
        if self.mesh is not None and not getattr(
                self.mesh, "mesh_dim_names", None):
            raise TypeError(
                f"ShardingPlan(mesh=) takes a DeviceMesh with named "
                f"dimensions (launch.mesh.make_mesh), not {self.mesh!r}")

    def placements(self, spec, shape=None) -> Optional[Tuple]:
        """The DTensor placements of ``spec`` on this mesh: one per mesh
        dimension, ``Shard(d)`` where tensor dimension ``d`` names it,
        else ``Replicate()``.  Given the tensor's ``shape``, a dimension
        that its mesh axes do not divide stays replicated (GSPMD pads an
        uneven shard; DTensor cannot carry one through a reshape).  None
        without a mesh."""
        if self.mesh is None:
            return None
        from torch.distributed.tensor import Replicate, Shard
        names = tuple(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for d, part in enumerate(spec):
            if part is None:
                continue
            ms = (part,) if isinstance(part, str) else tuple(part)
            idx = [names.index(a) for a in ms]
            if shape is not None and shape[d] % int(np.prod(
                    [self.mesh.size(i) for i in idx])):
                continue
            if idx != sorted(idx):
                raise ValueError(
                    f"spec {spec!r} names mesh axes {ms} out of the mesh's "
                    f"order {names}: DTensor splits a dimension in mesh "
                    f"order")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    def constrain(self, x, *axes: Optional[str], name: str = ""):
        """Annotate an activation with logical axes: redistribute a
        DTensor to the rules' placements (DTensor inserts the
        collective); the identity on one device or on a plain tensor."""
        if self.mesh is None or not _is_dtensor(x):
            return x
        spec = self.overrides.get(name) if name else None
        if spec is None:
            spec = self.rules.spec(axes)
        # contiguous: a shard cut from the last dimension is a strided
        # view, which the einsums' reshapes cannot take
        return x.redistribute(self.mesh, self.placements(
            spec, x.shape)).contiguous()

    def place(self, x, axes: Sequence[Optional[str]]):
        """A full tensor (the same values on every rank) as a DTensor
        sharded by the rules' spec of ``axes``; each rank keeps its own
        shard and nothing crosses a link.  ``x`` itself without a
        mesh."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import distribute_tensor
        if x.device.type not in ("meta", self.mesh.device_type):
            x = x.to(self.mesh.device_type)
        return distribute_tensor(x, self.mesh, self.placements(
            self.rules.spec(axes), x.shape), src_data_rank=None).contiguous()

    def zeros(self, shape, axes: Sequence[Optional[str]], dtype, device):
        """Zeros of ``shape`` placed by the rules' spec of ``axes``: each
        rank allocates only its own shard.  A plain tensor without a
        mesh."""
        if self.mesh is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        from torch.distributed.tensor import DTensor
        pl = self.placements(self.rules.spec(axes), shape)
        local = [hi - lo for lo, hi in _bounds(self.mesh, pl, shape)]
        z = torch.zeros(local, dtype=dtype, device=device)
        return DTensor.from_local(z, self.mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(
                                      shape, device="meta").stride())

    def region(self):
        """The context the model code runs in: on a mesh, a plain tensor
        that meets a DTensor (positions, masks, rope frequencies) counts
        as replicated."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicated_like(t, ref):
    """A plain tensor ``t`` as a replicated DTensor on ``ref``'s mesh
    when ``ref`` is a DTensor (else ``t``): for a plain operand that
    autograd saves beside a DTensor (rope's angles, the SSD masks), whose
    backward pass runs outside :meth:`ShardingPlan.region`."""
    if not _is_dtensor(ref) or _is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def _bounds(mesh, placements, shape):
    """[lo, hi) of this rank's shard along every dimension of a tensor of
    ``shape`` placed by ``placements``: the mesh dimensions that shard a
    dimension split it left to right, each into ``torch.chunk``-sized
    pieces, as DTensor does."""
    out = []
    for d, n in enumerate(shape):
        lo, hi = 0, int(n)
        for i, p in enumerate(placements):
            if p.is_shard(d):
                size, me = mesh.size(i), mesh.get_local_rank(i)
                piece = -(-(hi - lo) // size)
                lo, hi = (min(lo + me * piece, hi),
                          min(lo + (me + 1) * piece, hi))
        out.append((lo, hi))
    return out


def local_bounds(x):
    """[lo, hi) of this rank's shard of a DTensor ``x`` along every
    dimension (the whole range of a plain tensor)."""
    if not _is_dtensor(x):
        return [(0, int(n)) for n in x.shape]
    return _bounds(x.device_mesh, x.placements, x.shape)


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


def init_from_defs(defs, seed: int, dtype=torch.bfloat16, device=None,
                   plan: Optional[ShardingPlan] = None):
    """defs: nested dict of PDef -> same-structure dict of tensors on
    ``device`` (the card unless told otherwise), drawn from one
    generator seeded with ``seed``.  With a mesh ``plan`` each leaf is
    drawn whole and placed at once (:meth:`ShardingPlan.place`), so one
    full leaf at a time lives on the rank: the same values as without a
    mesh, as DTensors."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    if plan is None or plan.mesh is None:
        return map_defs(lambda d: _init_leaf(gen, d, dtype, dev), defs)
    return map_defs(lambda d: plan.place(_init_leaf(gen, d, dtype, dev),
                                         d.axes), defs)


def pspecs_from_defs(defs, rules: Rules):
    return map_defs(lambda d: rules.spec(d.axes), defs)


def place_params(params, defs, plan: ShardingPlan):
    """A parameter tree of full values (tensors, or numpy arrays as
    ``models.params_from_numpy`` takes them) placed by
    :func:`pspecs_from_defs` on ``plan``'s mesh: the counterpart of the
    reference callers' ``device_put`` with ``NamedSharding``.  Every
    rank cuts its own shard from the same values; no weight is
    scattered.  Without a mesh, the tree itself."""
    def walk(node, d):
        if isinstance(d, PDef):
            if isinstance(node, np.ndarray):
                node = torch.from_numpy(np.array(node, copy=True))
            return plan.place(node, d.axes)
        return {k: walk(node[k], d[k]) for k in sorted(d)}
    if plan.mesh is None:
        return params
    return walk(params, defs)


def as_placed(local, mesh, placements, shape):
    """Every rank's local tensor ``local`` as one DTensor of global
    ``shape`` placed by ``placements``: the way back from a region
    computed on local shards.  The DTensor claims a contiguous layout,
    so its local tensor is made one.  A ``Partial`` placement's gradient
    comes back replicated (DTensor keeps a replicated gradient as it is
    in the backward pass)."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    return DTensor.from_local(
        local.contiguous(), mesh, placements, run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def shapestructs_from_defs(defs, dtype):
    """Meta tensors of every leaf's shape and ``dtype``, in the leaf
    order of :func:`map_defs` (the reference's ``ShapeDtypeStruct``
    tree)."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=dtype,
                                          device="meta"), defs)
