"""GPipe-style pipeline parallelism over a mesh axis.

Port of the reference's ``runtime/pipeline_parallel.py``.  The model's
stages are split over the ``stage`` axis of a ``DeviceMesh``; every rank
runs this function on the same inputs (SPMD) and computes the stage its
coordinate names.  Microbatches stream through the classic GPipe
fill-drain loop of T = n_micro + S - 1 ticks: every tick each stage
computes one microbatch (or idles in the ramp) and the boundary
activations rotate by one stage.

The reference rotates with ``ppermute``.  Here the rotation is one
``all_to_all_single`` per tick over the stage group in which each rank
sends its whole activation to the next stage and receives the previous
stage's (uneven splits: every other pair exchanges zero rows).
Point-to-point ``batch_isend_irecv`` would say the same, but under gloo
it timed out in ``unbound_buffer.cc``.  At the end the last stage's
buffer is broadcast to every rank (the reference's ``psum`` of the
masked buffers, without the sum).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..tree import leaves, unflatten

__all__ = ["pipeline_apply", "pipeline_ticks"]


def pipeline_ticks(s: int, n_micro: int) -> int:
    """Fill-drain tick count of the GPipe schedule: ``n_micro + s - 1``
    (the bubble term the solver's pp node costs scale by — see
    ``selection.PlacementPricing``)."""
    if s < 1 or n_micro < 1:
        raise ValueError(f"need s >= 1 and n_micro >= 1, got "
                         f"s={s} n_micro={n_micro}")
    return n_micro + s - 1


def _rotate(out: torch.Tensor, stage: int, s: int, group) -> torch.Tensor:
    """``out`` of stage ``i`` arrives at stage ``i + 1`` (mod ``s``)."""
    rows = out.shape[0]
    send = [0] * s
    recv = [0] * s
    send[(stage + 1) % s] = rows
    recv[(stage - 1) % s] = rows
    nxt = torch.empty_like(out)
    dist.all_to_all_single(nxt, out.contiguous(), recv, send, group=group)
    return nxt


def pipeline_apply(mesh, stage_fn: Callable, stage_params: Any,
                   x: torch.Tensor, *, n_micro: int, axis: str = "stage"):
    """Run ``y = stage_S(...stage_1(x))`` pipelined over ``axis``.

    stage_fn(params_for_stage, x_micro) -> y_micro (same shape).
    stage_params: nested dicts/lists of tensors, each with a leading
    stage axis; this rank's stage takes entry ``[stage]`` of each.
    x: (n_micro, micro_b, ...) microbatched input, the same on every
    rank.  Returns the (n_micro, micro_b, ...) outputs on every rank.
    """
    names = list(mesh.mesh_dim_names)
    s = int(mesh.mesh.shape[names.index(axis)])
    t_total = pipeline_ticks(s, n_micro)
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    params = unflatten(stage_params,
                       [a[stage] for a in leaves(stage_params)])
    buf = torch.zeros_like(x)        # output accumulator (n_micro, ...)
    carry = torch.zeros_like(x[0])
    for t in range(t_total):
        m = t - stage                # microbatch index at this stage
        if 0 <= m < n_micro:
            out = stage_fn(params, x[m] if stage == 0 else carry)
            if stage == s - 1:       # the last stage banks its result
                buf[m] = out
        else:
            out = carry              # idle in the ramp: pass through
        if s > 1:
            carry = _rotate(out, stage, s, group)
    if s > 1:
        # only the last stage holds real outputs; send them to all
        dist.broadcast(buf, src=dist.get_global_rank(group, s - 1),
                       group=group)
    return buf
