"""Gradient compression for cross-pod synchronisation (port of the
reference's ``optim/compression.py``).

int8 quantisation with a per-tensor scale, optionally with stochastic
rounding: the pseudo-gradient exchanged between pods shrinks 4x.
:func:`compressed_psum_tree` is the reference's quantised all-reduce
over a named mesh axis, here over a ``torch.distributed`` process group
(``mesh.get_group("pod")``).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum_tree"]


def quantize_int8(x: torch.Tensor, key: Optional[torch.Generator] = None):
    """(q int8, scale f32 0-d): ``x / scale`` rounded half to even and
    clipped to [-127, 127], ``scale = max|x| / 127``.  ``key``: a
    ``torch.Generator`` on ``x``'s device (the reference's JAX key) for
    stochastic rounding, which is unbiased: uniform noise in [-0.5, 0.5)
    is added before rounding."""
    x32 = x.float()
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    scaled = x32 / scale
    if key is not None:  # stochastic rounding: unbiased compression
        noise = torch.rand(x.shape, generator=key, dtype=torch.float32,
                           device=x.device) - 0.5
        scaled = scaled + noise
    q = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_tree(tree, group=None,
                         generator: Optional[torch.Generator] = None):
    """Quantised all-reduce of a nested dict of tensors over ``group``
    (a process group; the default one if None): returns the mean over
    its ranks, in each leaf's dtype.

    A shared scale is agreed first with a scalar ``all_reduce(MAX)`` of
    each leaf's largest magnitude, so the int8 payload (the only large
    message) dequantises exactly: it is summed as int32 with
    ``all_reduce(SUM)`` (no overflow below 2^23 participants).
    ``generator`` (a ``torch.Generator`` on the leaves' device, the
    reference's key) adds uniform noise in [-0.5, 0.5) before rounding:
    stochastic rounding, unbiased.  Rounding is half to even, as the
    reference's ``jnp.round``."""
    import torch.distributed as dist
    n = dist.get_world_size(group)

    def one(leaf):
        x32 = leaf.float()
        m = torch.max(torch.abs(x32)).reshape(1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(m[0], min=1e-12) / 127.0
        scaled = x32 / scale
        if generator is not None:  # stochastic rounding: unbiased
            scaled = scaled + (torch.rand(
                leaf.shape, generator=generator, dtype=torch.float32,
                device=leaf.device) - 0.5)
        acc = torch.clamp(torch.round(scaled), -127, 127).to(
            torch.int8).to(torch.int32)
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
        return (acc.float() * scale / n).to(leaf.dtype)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in node}
        return one(node)
    return walk(tree)
