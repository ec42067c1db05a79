"""Mixture-of-Experts FFN with sort-based token dispatch.

Port of the reference's ``models/moe.py``.  Tokens are sorted by
destination expert and gathered into a capacity-bounded (E, C, D)
buffer; every expert's gated FFN runs on its C rows (one batched matmul
per weight), and the outputs are scattered back weighted by the gates.
Overflow pairs beyond capacity are dropped (standard capacity-factor
semantics); the gates are renormalised over the kept top-k before any
drop, as in the reference.

The reference's ``.at[dest].set(..., mode="drop")`` becomes a buffer
with one spare row that takes every dropped pair and is sliced off;
``.at[src_token].add`` becomes ``index_add_``.  The router runs in f32,
its top-k through ``torch.topk`` (ties may be ordered otherwise than
``jax.lax.top_k`` orders them: the chosen set is the same).

Dispatch, the expert FFNs and the combine are framework ops here as in
the reference: no kernel of the port is on this path.

On a mesh (DTensor parameters and activations) :func:`moe_ffn` routes
the whole batch as the reference's GSPMD program does: the token slab is
gathered, every rank dispatches it alike, the expert FFNs run on the
rules' shards of the expert weights (``experts`` or ``d_ff`` on
``model``) and the combined output takes the batch's sharding again.
:func:`moe_ffn_alltoall` is the reference's expert-parallel GShard
schedule: routing on each rank's (batch x seq)-local slab and two
``all_to_all_single`` calls on the ``model`` group.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .sharding import PDef, ShardingPlan, _is_dtensor, as_placed

__all__ = ["moe_defs", "capacity", "moe_ffn", "moe_ffn_alltoall",
           "aux_load_balance_loss"]


def moe_defs(cfg) -> Dict[str, PDef]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": PDef((d, e), ("d_model", "experts")),
        "w1": PDef((e, d, f), ("experts", "d_model", "d_ff")),
        "w3": PDef((e, d, f), ("experts", "d_model", "d_ff")),
        "w2": PDef((e, f, d), ("experts", "d_ff", "d_model")),
    }


def capacity(cfg, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to 8, as the reference


def _local_dispatch(cfg, p, xf, c):
    """Sort-based dispatch of a token slab ``xf`` (N, D) into C rows per
    expert.  Returns (buf (E, C, D), combine metadata (keep, dest,
    src_token, src_gate), one entry per (token, choice) pair in sorted
    order)."""
    n, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = torch.einsum("nd,de->ne", xf.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)      # (N, K)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    pair_expert = expert_idx.reshape(-1)                      # (N*K,)
    order = torch.argsort(pair_expert, stable=True)
    sorted_e = pair_expert[order]
    # rank of each pair within its expert segment
    seg_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(n * k, device=xf.device) - seg_start
    keep = rank < c
    dest = torch.where(keep, sorted_e * c + rank, e * c)      # spare row
    src_token = order // k
    src_gate = gate_vals.reshape(-1)[order]
    buf = torch.zeros((e * c + 1, d), dtype=xf.dtype, device=xf.device)
    buf[dest] = xf[src_token]
    return buf[:e * c].reshape(e, c, d), (keep, dest, src_token, src_gate)


def _local_combine(cfg, out_flat, meta, n, d, dtype):
    e, c = cfg.n_experts, out_flat.shape[0] // cfg.n_experts
    keep, dest, src_token, src_gate = meta
    contrib = torch.where(keep[:, None],
                          out_flat[torch.clamp(dest, max=e * c - 1)], 0.0)
    y = torch.zeros((n, d), dtype=dtype, device=out_flat.device)
    return y.index_add_(0, src_token, contrib * src_gate[:, None].to(dtype))


def moe_ffn(cfg, p, x, plan: ShardingPlan, *, drop_free: bool = False):
    """x: (B, T, D) -> (B, T, D).

    ``drop_free``: a capacity of at least the token count, so no expert
    overflows (the serving loop's batched decode asks for it: the
    reference's loop decodes one slot at a time, where the capacity
    floor of 8 rows never drops a pair, and a batch of slots must not
    drop any either)."""
    b, t, d = x.shape
    n = b * t
    c = capacity(cfg, n)
    if drop_free:
        c = max(c, n)
    mesh = x.device_mesh if _is_dtensor(x) else None
    if mesh is not None:
        # every rank routes the whole (gathered) batch, as GSPMD does
        from torch.distributed.tensor import Replicate
        rep = (Replicate(),) * mesh.ndim
        xf = x.redistribute(mesh, rep).to_local().reshape(n, d)
        router = p["router"].redistribute(mesh, rep).to_local()
        buf, meta = _local_dispatch(cfg, {"router": router}, xf, c)
        buf = as_placed(buf, mesh, rep, buf.shape)
    else:
        buf, meta = _local_dispatch(cfg, p, x.reshape(n, d), c)
    buf = plan.constrain(buf, "experts", None, "d_model")

    # ---- expert computation (per-expert gated FFN) ----
    h = torch.einsum("ecd,edf->ecf", buf, p["w1"])
    h = F.silu(h) * torch.einsum("ecd,edf->ecf", buf, p["w3"])
    h = plan.constrain(h, "experts", None, "d_ff")
    out_buf = torch.einsum("ecf,efd->ecd", h, p["w2"])
    out_buf = plan.constrain(out_buf, "experts", None, "d_model")

    if mesh is not None:
        out_flat = out_buf.redistribute(mesh, rep).to_local().reshape(-1, d)
        y = _local_combine(cfg, out_flat, meta, n, d, x.dtype)
        y = as_placed(y.reshape(b, t, d), mesh, rep, (b, t, d))
    else:
        y = _local_combine(cfg, out_buf.reshape(-1, d), meta, n, d,
                           x.dtype).reshape(b, t, d)
    return plan.constrain(y, "batch", "seq", "d_model")


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal chunks over ``group``, and the same
    exchange of the gradient back (an even all-to-all is its own
    transpose)."""

    @staticmethod
    def _exchange(x, group):
        import torch.distributed as dist
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _AllToAll._exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _AllToAll._exchange(g, ctx.group), None


def moe_ffn_alltoall(cfg, p, x, plan: ShardingPlan):
    """Expert-parallel MoE with explicit all-to-alls (the reference's
    ``shard_map`` GShard schedule).

    Routing runs on each rank's (batch x seq)-local slab (batch over the
    data axes, seq over ``model``) with the capacity of its
    ``n_local`` tokens; each rank holds ``E / |model|`` experts whole.
    The only cross-rank traffic is two ``all_to_all_single`` calls on
    the ``model`` group, of (|model|, e_local * C, d) each (autograd
    passes through them).  Drops follow the local slab's capacity, so
    they differ from :func:`moe_ffn`'s.  Requires a mesh with a "model"
    axis, and seq and the expert count divisible by |model|."""
    mesh = plan.mesh
    b, t, d = x.shape
    e = cfg.n_experts
    names = tuple(mesh.mesh_dim_names)
    tp = mesh.size(names.index("model"))
    e_local = e // tp
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    x_pl = plan.placements((data_axes or None, "model", None))
    rep = plan.placements((None, None))
    w_pl = plan.placements(("model", None, None))
    xl = x.redistribute(mesh, x_pl).to_local()
    n_local = xl.shape[0] * xl.shape[1]
    c = capacity(cfg, n_local)
    # per (dest-shard, local-expert) capacity such that E*C splits evenly
    assert (e * c) % tp == 0
    # each rank routes its own slab and feeds its experts the tokens of
    # its data rows only: their gradients are partial sums there
    from torch.distributed.tensor import Partial
    router = p["router"].redistribute(mesh, rep).to_local(
        grad_placements=(Partial(),) * mesh.ndim)
    w_grad = tuple(q if q.is_shard() else Partial() for q in w_pl)
    w1, w3, w2 = (p[k].redistribute(mesh, w_pl).to_local(
        grad_placements=w_grad) for k in ("w1", "w3", "w2"))
    group = mesh.get_group("model")

    def exchange(t_):
        return _AllToAll.apply(t_, group)

    xf = xl.reshape(-1, d)
    buf, meta = _local_dispatch(cfg, {"router": router}, xf, c)
    # group by destination shard and exchange
    buf = exchange(buf.reshape(tp, e_local * c, d))
    # buf: (tp source shards, e_local * c, d)
    buf = buf.reshape(tp, e_local, c, d)
    h = torch.einsum("secd,edf->secf", buf, w1)
    h = F.silu(h) * torch.einsum("secd,edf->secf", buf, w3)
    out = torch.einsum("secf,efd->secd", h, w2)      # (tp, e_local, c, d)
    out = exchange(out.reshape(tp, e_local * c, d))
    y = _local_combine(cfg, out.reshape(e * c, d), meta, xf.shape[0], d,
                       xl.dtype)
    return as_placed(y.reshape(xl.shape), mesh, x_pl, x.shape)


def aux_load_balance_loss(cfg, logits):
    """Switch-style load-balance auxiliary (returned by train paths)."""
    probs = torch.softmax(logits.float(), dim=-1)
    e = cfg.n_experts
    lead = tuple(range(probs.dim() - 1))
    frac = torch.mean(probs, dim=lead)
    top1 = torch.argmax(probs, dim=-1)
    hard = torch.mean(F.one_hot(top1, e).float(), dim=lead)
    return e * torch.sum(frac * hard)
