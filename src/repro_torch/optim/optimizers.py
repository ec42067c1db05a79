"""Optimizers over nested dicts of tensors (port of the reference's
``optim/optimizers.py``, its functional API kept).

``Optimizer.init(params) -> state`` and ``Optimizer.update(grads, state,
params) -> (new_params, new_state)``: nothing is updated in place, so a
step that raises leaves the caller's params and state as they were.  The
state's structure is the reference's, and so is what a checkpoint stores:
``{"m", "v", "count"}`` for AdamW, ``{"f": {"r", "c"} | {"v"},
"count"}`` for Adafactor, ``count`` an int32 scalar on the parameters'
device.  The formulas are the reference's, not ``torch.optim``'s: eps
outside the square root of the bias-corrected second moment, weight decay
added to the step of every leaf (norms included), the learning rate and
the bias corrections computed in f32 from ``count`` on the device (no
read to the host).

AdamW for <=100B models; Adafactor (factored second moment) for the
300B-1T archs where Adam state would not fit device memory.  Both
compose with global-norm clipping and the warmup+cosine schedule.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from ..tree import flatten_up_to
from ..tree import leaves as _leaves
from ..tree import unflatten as _unflatten

__all__ = ["adamw", "adafactor", "clip_by_global_norm", "global_norm",
           "warmup_cosine", "for_config", "Optimizer"]


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1):
    """lr(step) in f32: linear warmup to ``peak_lr``, then a cosine down
    to ``floor * peak_lr`` at ``total``.  ``step`` may be an int or a
    tensor (the optimizer's ``count``, on its device)."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in _leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, the norm
    before)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    leaves = [(g.float() * scale).to(g.dtype) for g in _leaves(tree)]
    return _unflatten(tree, leaves), norm


def adamw(lr_fn, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float = 1.0) -> Optimizer:
    def init(params):
        ps = _leaves(params)
        # zeros_like: a DTensor parameter's state is sharded alike
        zeros = [torch.zeros_like(p, dtype=torch.float32,
                                  memory_format=torch.contiguous_format)
                 for p in ps]
        return {"m": _unflatten(params, zeros),
                "v": _unflatten(params, [torch.zeros_like(z)
                                         for z in zeros]),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=ps[0].device)}

    @torch.no_grad()
    def update(grads, state, params):
        grads, _ = clip_by_global_norm(grads, clip_norm)
        count = state["count"] + 1
        lr = lr_fn(count)
        c32 = count.float()
        bc1 = 1 - torch.pow(b1, c32)
        bc2 = 1 - torch.pow(b2, c32)
        new_p, new_m, new_v = [], [], []
        for p, g, m, v in zip(_leaves(params), _leaves(grads),
                              _leaves(state["m"]), _leaves(state["v"])):
            g32 = g.float()
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * g32 * g32
            # the step's temporaries are updated in place: the largest
            # leaf (TinyLlama's stacked w1) is 1 GiB
            step = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            step.add_(weight_decay * p.float())
            new_p.append((p.float() - lr * step).to(p.dtype))
            new_m.append(m)
            new_v.append(v)
        return _unflatten(params, new_p), {
            "m": _unflatten(params, new_m), "v": _unflatten(params, new_v),
            "count": count}

    return Optimizer(init, update)


def _zeros_without(p, dim):
    """f32 zeros of ``p``'s shape without dimension ``dim`` (all of it
    for None).  A DTensor ``p`` gives a DTensor whose other dimensions
    keep ``p``'s sharding (the reference's factored-state specs)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if dim is None:
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
    dim = dim % p.dim()
    shape = p.shape[:dim] + p.shape[dim + 1:]
    if not isinstance(p, DTensor):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    local = p.to_local().shape
    pl = tuple(Replicate() if q.is_shard(dim) else
               Shard(q.dim - 1) if isinstance(q, Shard) and q.dim > dim
               else q for q in p.placements)
    z = torch.zeros(local[:dim] + local[dim + 1:], dtype=torch.float32,
                    device=p.to_local().device)
    return DTensor.from_local(z, p.device_mesh, pl, run_check=False,
                              shape=shape, stride=torch.empty(
                                  shape, device="meta").stride())


def adafactor(lr_fn, *, eps: float = 1e-30, clip_norm: float = 1.0,
              weight_decay: float = 0.0, min_dim: int = 128) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern 2018): matrices
    keep only row/col statistics — O(n+m) state instead of O(nm)."""
    def factored(p):
        return p.dim() >= 2 and p.shape[-1] >= min_dim and \
            p.shape[-2] >= min_dim

    def one(p):
        if factored(p):
            return {"r": _zeros_without(p, -1), "c": _zeros_without(p, -2)}
        return {"v": _zeros_without(p, None)}

    def init(params):
        ps = _leaves(params)
        return {"f": _unflatten(params, [one(p) for p in ps]),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=ps[0].device)}

    @torch.no_grad()
    def update(grads, state, params):
        grads, _ = clip_by_global_norm(grads, clip_norm)
        count = state["count"] + 1
        lr = lr_fn(count)
        beta = 1.0 - count.float() ** -0.8
        new_p, new_f = [], []
        for p, g, f in zip(_leaves(params), _leaves(grads),
                           flatten_up_to(params, state["f"])):
            g32 = g.float()
            g2 = g32 * g32 + eps
            if factored(p):
                r = beta * f["r"] + (1 - beta) * torch.mean(g2, dim=-1)
                c = beta * f["c"] + (1 - beta) * torch.mean(g2, dim=-2)
                rc = r / torch.clamp(torch.mean(r, dim=-1, keepdim=True),
                                     min=eps)
                vhat = rc[..., None] * c[..., None, :]
                nf = {"r": r, "c": c}
            else:
                v = beta * f["v"] + (1 - beta) * g2
                vhat = v
                nf = {"v": v}
            step = g32 * torch.rsqrt(vhat + eps)
            step = step + weight_decay * p.float()
            new_p.append((p.float() - lr * step).to(p.dtype))
            new_f.append(nf)
        return _unflatten(params, new_p), {"f": _unflatten(params, new_f),
                                           "count": count}

    return Optimizer(init, update)


def for_config(cfg, *, peak_lr=3e-4, warmup=100, total=10000) -> Optimizer:
    """Memory-aware default: Adafactor for >=200B-parameter archs."""
    from ..models.model import param_count
    lr = warmup_cosine(peak_lr, warmup, total)
    if param_count(cfg) >= 2e11:
        return adafactor(lr)
    return adamw(lr)
