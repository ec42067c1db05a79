"""Full language-model assembly: embeddings -> stacked superblocks ->
head; train / prefill / decode entry points.

Port of the reference's ``models/model.py`` for every family (dense,
MoE, SSM, hybrid, encoder-decoder, VLM).  The parameters and the decode
cache keep the reference's nested dicts, keys and stacked shapes (a
leading ``layers`` axis over the superblocks); the reference's
``lax.scan`` over that axis is a Python loop here.

:func:`init_params` and :func:`params_from_numpy` put the parameters on
the card unless told otherwise (``device="cpu"``), and raise without
one.  The other entry points run where the parameters lie.

Training differentiates :func:`loss_fn` with autograd; flash attention
(K6) has no backward, as the reference's kernel has none, so a model
trained here takes ``attn_impl="xla"`` or ``"xla_chunked"``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils import checkpoint as _ckpt

from ..kernels.common import resolve_device
from .blocks import (
    apply_superblock, block_defs, empty_cache, n_super, stack_defs,
)
from .common import attention, ffn, rms_norm
from .sharding import (
    PDef, Rules, ShardingPlan, _is_dtensor, as_placed, init_from_defs,
    local_bounds, replicated_like,
    map_defs, pspecs_from_defs, shapestructs_from_defs,
)

__all__ = ["ModelRuntime", "param_defs", "init_params", "param_pspecs",
           "param_count", "active_param_count", "params_from_numpy",
           "param_shapestructs", "forward_train", "loss_fn", "prefill",
           "decode_step", "init_cache", "cache_axes", "encode"]


@dataclass(frozen=True)
class ModelRuntime:
    """Execution knobs (the LM-side primitive/variant choices).

    ``attn_impl`` picks prefill's attention: "xla" (the plain einsum
    path), "xla_chunked" (its causal chunked form at T >= 1024) or
    "flash" (the flash kernel, K6, which refuses autograd).  ``remat``
    recomputes each superblock's activations in the backward pass
    instead of keeping them (``torch.utils.checkpoint``): under
    ``remat_policy`` "full" every one, under "dots" all but the outputs
    of the products without batch dimensions (the projections and the
    head; the reference's ``dots_with_no_batch_dims_saveable``).  The
    encoder's layers take "full" under either policy, as the
    reference's do.  Remat changes what autograd keeps, not what is
    computed.  ``chunk`` is the SSD chunk size.  ``moe_impl`` picks the
    MoE route: "gather" (the sort-based dispatch of ``moe.moe_ffn``) or
    "alltoall" (the expert-parallel ``moe.moe_ffn_alltoall``, taken on a
    mesh whose ``model`` axis divides the experts and the sequence, as in
    the reference).  The reference's ``unroll`` and ``unroll_chunks``
    have no counterpart: the port's loops over the superblocks and the
    SSD chunks are Python loops, so there is nothing to unroll."""
    attn_impl: str = "xla"        # "xla" | "xla_chunked" | "flash"
    remat: bool = False           # activation checkpointing per block
    remat_policy: str = "full"    # "full" | "dots" (save matmul outputs)
    chunk: int = 256              # SSD chunk size
    moe_impl: str = "gather"      # "gather" | "alltoall" (expert parallel)


# ----------------------------------------------------------------------
def param_defs(cfg) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab
    defs: Dict[str, Any] = {
        "embed": PDef((v, d), ("vocab", "d_model")),
        "blocks": stack_defs(block_defs(cfg), n_super(cfg)),
        "final_norm": PDef((d,), ("d_model",), init="ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = PDef((d, v), ("d_model", "vocab"))
    if cfg.family == "encdec":
        enc_cfg = replace(cfg, family="dense", n_layers=cfg.enc_layers,
                          local_global_period=0)
        defs["enc_blocks"] = stack_defs(block_defs(enc_cfg),
                                        n_super(enc_cfg))
        defs["enc_norm"] = PDef((d,), ("d_model",), init="ones")
        defs["enc_pos"] = PDef((cfg.enc_seq, d), ("enc_seq", "d_model"),
                               scale=0.02)
    if cfg.family == "vlm":
        defs["patch_proj"] = PDef((d, d), ("d_model", "d_model"))
    return defs


def init_params(cfg, seed: int = 0, dtype=torch.bfloat16, device=None,
                plan: Optional[ShardingPlan] = None):
    """Parameters drawn from the reference's distributions by a
    ``torch.Generator`` seeded with ``seed``, on ``device`` (the card by
    default); with a mesh ``plan``, the same values as DTensors placed
    by the plan's rules (each rank keeps its shards).  Not the
    reference's values: carry those across with
    :func:`params_from_numpy` (and ``sharding.place_params``)."""
    return init_from_defs(param_defs(cfg), seed, dtype, device, plan)


def params_from_numpy(tree, device=None):
    """The reference's ``init_params`` tree, each leaf converted to a
    numpy array, as the same nested dict of tensors on ``device`` (the
    card unless told otherwise)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(node[k]) for k in node}
        return torch.from_numpy(np.array(node, copy=True)).to(dev)
    return conv(tree)


def param_pspecs(cfg, rules: Rules):
    return pspecs_from_defs(param_defs(cfg), rules)


def param_shapestructs(cfg, dtype=torch.bfloat16):
    """The parameter tree as meta tensors (shapes and dtype, no
    storage): the reference's ``ShapeDtypeStruct`` tree."""
    return shapestructs_from_defs(param_defs(cfg), dtype)


def _leaves(defs):
    out = []
    map_defs(out.append, defs)
    return out


def param_count(cfg) -> int:
    return int(sum(np.prod(p.shape) for p in _leaves(param_defs(cfg))))


def active_param_count(cfg) -> int:
    """Parameters touched per token (MoE: top_k of n_experts)."""
    total = param_count(cfg)
    if not cfg.n_experts:
        return total
    expert = int(sum(np.prod(p.shape)
                     for p in _leaves(param_defs(cfg)["blocks"])
                     if "experts" in p.axes))
    inactive = expert * (1 - cfg.top_k / cfg.n_experts)
    return int(total - inactive)


# ----------------------------------------------------------------------
def _lookup(table, tokens):
    """``table[tokens]``.  On a mesh, from each rank's own shard of the
    table (Megatron's vocab-parallel lookup): the rows of a vocab shard
    are looked up locally (zero for a token another rank holds) and the
    result is a partial sum over the vocab's mesh dimensions; a sharded
    ``d_model`` stays sharded.  The table is never gathered."""
    if not _is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    tokens = replicated_like(tokens, table)
    tab = tuple(p if isinstance(p, Shard) else Replicate()
                for p in table.placements)
    table = table.redistribute(mesh, tab)
    tpl = tuple(Replicate() if isinstance(t, Shard) else p
                for t, p in zip(tab, tokens.placements))
    tl = tokens.redistribute(mesh, tpl).to_local()
    lo, hi = local_bounds(table)[0]
    idx = tl - lo
    inside = (idx >= 0) & (idx < hi - lo)
    # a rank that looks up only its own tokens holds a partial sum of a
    # replicated table's gradient
    grad = tuple(Partial() if isinstance(p, Shard) and not t.is_shard()
                 else t for t, p in zip(tab, tpl))
    rows = table.to_local(grad_placements=grad)[
        idx.clamp(0, max(hi - lo - 1, 0))]
    rows = torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    out = tuple(Partial() if t.is_shard(0) else
                Shard(tokens.dim()) if t.is_shard(1) else p
                for t, p in zip(tab, tpl))
    return as_placed(rows, mesh, out, tuple(tokens.shape) + (
        table.shape[1],))


def _embed(cfg, params, tokens, plan: ShardingPlan):
    h = _lookup(params["embed"], tokens.long())
    if cfg.post_norms:  # gemma2 embedding scaling, rounded to h's dtype
        # (a host scalar: no copy to the device)
        h = h * torch.tensor(np.sqrt(cfg.d_model), dtype=h.dtype)
    return plan.constrain(h, "batch", "seq", "d_model")


def _head(cfg, params, h, plan: ShardingPlan):
    """Logits in f32 whatever the parameters' dtype."""
    h = h.float()
    w = (params["embed"].T if cfg.tie_embeddings else
         params["lm_head"]).float()
    logits = torch.einsum("btd,dv->btv", h, w)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return plan.constrain(logits, "batch", "seq", "vocab")


def _unbind(tree):
    """The superblocks of a stacked tree, one view each, split in one
    op: the backward pass of ``unbind`` stacks the layers' gradients
    once, where indexing layer by layer would add a zero-filled full
    stack per layer.  The views write through: a decode step's in-place
    cache writes land in the stacked cache."""
    if isinstance(tree, dict):
        per = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return torch.unbind(tree, 0)


def _run_blocks(cfg, blocks_params, h, *, positions, plan, rt: ModelRuntime,
                cache=None, cache_index=None, decode=False, cross_kv=None,
                drop_free=False):
    """The superblocks in order over the stacked ``layers`` axis, each
    under ``rt``'s remat (which acts only where autograd records: the
    training forward).  Returns (h, per-superblock caches, or None
    without a cache); with ``decode`` every superblock's new state is
    also written into ``cache`` in place."""
    def block(x, p, c):
        return apply_superblock(
            cfg, p, x, positions=positions, plan=plan, cache=c,
            cache_index=cache_index, decode=decode, attn_impl=rt.attn_impl,
            chunk=rt.chunk, cross_kv=cross_kv, drop_free=drop_free,
            moe_impl=rt.moe_impl)
    per_cache = _unbind(cache) if cache is not None else \
        [None] * n_super(cfg)
    caches = []
    for p, c in zip(_unbind(blocks_params), per_cache):
        h, ncache = _remat(rt, rt.remat_policy, block, h, p, c)
        caches.append(ncache)
    return h, (caches if cache is not None else None)


def _dots_saveable(ctx, op, *args, **kwargs):
    """Remat policy "dots": keep the outputs of the products that have no
    batch dimension, recompute everything else (the reference's
    ``dots_with_no_batch_dims_saveable``).  ``torch.einsum`` lowers a
    projection such as "btd,dhk->bthk" to ``bmm`` over one batch entry
    (b and t folded into the rows) and attention's "bqkgd,bskd->bkgqs"
    to ``bmm`` over B x Hkv entries, so a ``bmm`` of batch 1 counts as
    a product without batch dimensions (as does a single-sequence,
    single-KV-head attention, which the reference would recompute)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) \
            or (op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(rt: ModelRuntime, policy: str, fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    when ``rt.remat`` is set and autograd records (elsewhere remat has
    nothing to drop)."""
    if not (rt.remat and torch.is_grad_enabled()):
        return fn(*args)
    if policy == "dots":
        return _ckpt.checkpoint(
            fn, *args, use_reentrant=False, context_fn=lambda:
            _ckpt.create_selective_checkpoint_contexts(_dots_saveable))
    return _ckpt.checkpoint(fn, *args, use_reentrant=False)


# ----------------------------------------------------------------------
def encode(cfg, params, frames, plan: ShardingPlan, rt: ModelRuntime):
    """Whisper encoder over precomputed frame embeddings (the reference's
    conv stub): bidirectional self-attention (K6, non-causal, with
    ``attn_impl="flash"``) and a dense FFN per layer."""
    enc_cfg = replace(cfg, family="dense", n_layers=cfg.enc_layers,
                      local_global_period=0)
    h = frames + params["enc_pos"][None, :frames.shape[1], :].to(
        frames.dtype)
    h = plan.constrain(h, "batch", "enc_seq", "d_model")
    positions = torch.arange(frames.shape[1], device=h.device)[None]

    def layer(h, p):
        x = rms_norm(h, p["norm1"], cfg.norm_eps)
        a, _ = attention(enc_cfg, p["attn"], x, positions=positions,
                         plan=plan, causal=False, attn_impl=rt.attn_impl)
        h = h + a
        x = rms_norm(h, p["norm2"], cfg.norm_eps)
        return h + ffn(p["ffn"], x, plan)
    for p in _unbind(params["enc_blocks"]):
        h = _remat(rt, "full", layer, h, p["layer0"])
    return rms_norm(h, params["enc_norm"], cfg.norm_eps)


def _prepare_inputs(cfg, params, batch, plan, rt):
    """Returns (h, positions, cross_kv, label_offset): the token
    embedding; the encoder's output as the cross-attention source
    (encoder-decoder); the projected patches ahead of the text, whose
    count is the offset of the text's logits (VLM)."""
    cross_kv = None
    if cfg.family == "encdec":
        cross_kv = encode(cfg, params, batch["frames"], plan, rt)
    if cfg.family == "vlm":
        patches = torch.einsum("bpd,de->bpe", batch["patches"],
                               params["patch_proj"])
        text = _embed(cfg, params, batch["tokens"], plan)
        h = torch.cat([patches.to(text.dtype), text], dim=1)
        positions = torch.arange(h.shape[1], device=h.device)[None]
        return h, positions, None, patches.shape[1]
    tokens = batch["tokens"]
    h = _embed(cfg, params, tokens, plan)
    positions = torch.arange(tokens.shape[1], device=h.device)[None]
    return h, positions, cross_kv, 0


def forward_train(cfg, params, batch, plan: ShardingPlan,
                  rt: ModelRuntime = ModelRuntime()):
    """Full forward -> logits over the label positions (the text's, for
    a VLM), differentiable (``attn_impl`` "xla" or "xla_chunked" under
    autograd)."""
    with plan.region():
        h, positions, cross_kv, off = _prepare_inputs(cfg, params, batch,
                                                      plan, rt)
        h, _ = _run_blocks(cfg, params["blocks"], h, positions=positions,
                           plan=plan, rt=rt, cross_kv=cross_kv)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        if off:
            h = h[:, off:, :]   # VLM: logits over text positions only
        return _head(cfg, params, h, plan)


def _gold(logits, labels):
    """``logits[..., labels]``.  On a mesh each rank gathers from its own
    vocab shard (zero where the label lies in another's) and the result
    is a partial sum over the vocab's mesh dimensions: the logits are
    never gathered."""
    if not _is_dtensor(logits):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, v = logits.device_mesh, logits.dim() - 1
    pl = tuple(p if isinstance(p, Shard) else Replicate()
               for p in logits.placements)
    logits = logits.redistribute(mesh, pl)
    lo, hi = local_bounds(logits)[v]
    lpl = tuple(Replicate() if p.is_shard(v) else p for p in pl)
    il = labels.redistribute(mesh, lpl).to_local()
    inside = (il >= lo) & (il < hi)
    g = torch.gather(logits.to_local(), -1, (il - lo).clamp(
        0, max(hi - lo - 1, 0))[..., None])[..., 0]
    g = torch.where(inside, g, torch.zeros((), dtype=g.dtype,
                                           device=g.device))
    return as_placed(g, mesh, tuple(Partial() if p.is_shard(v) else p
                                    for p in pl), labels.shape)


def loss_fn(cfg, params, batch, plan: ShardingPlan,
            rt: ModelRuntime = ModelRuntime()):
    """Mean next-token cross-entropy over the labels >= 0 (f32): the
    reference's ``logsumexp - gold``, masked, over ``max(count, 1)``."""
    logits = forward_train(cfg, params, batch, plan, rt)
    with plan.region():
        labels = batch["labels"].long()
        logz = torch.logsumexp(logits, dim=-1)
        # a masked label (< 0) gathers column 0, which the mask zeroes
        gold = _gold(logits, labels.clamp(min=0))
        mask = (labels >= 0).float()
        nll = (logz - gold) * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)


# ----------------------------------------------------------------------
def cache_axes(name: str):
    """The logical axes of a stacked cache leaf (the reference's
    ``launch.inputs`` cache axes): k/v (L, B, S, Hkv, hd), the SSM
    state (L, B, H, N, P), the conv window (L, B, K-1, C)."""
    if name in ("k", "v"):
        return ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    if name == "ssm":
        return ("layers", "batch", "ssm_heads", None, None)
    return ("layers", "batch", None, None)


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None, plan: Optional[ShardingPlan] = None):
    """Stacked decode cache: every leaf gets the n_super leading axis.
    On ``device`` (the card by default); with a mesh ``plan``, DTensors
    placed by :func:`cache_axes` (each rank allocates its shard)."""
    dev = resolve_device(device)
    plan = plan or ShardingPlan()
    one = empty_cache(cfg, batch, max_seq, dtype, device="meta")
    n = n_super(cfg)
    return {lk: {name: plan.zeros((n,) + t.shape, cache_axes(name),
                                  t.dtype, dev)
                 for name, t in leaf.items()}
            for lk, leaf in one.items()}


def _write_prefix(dst, i: int, new):
    """``dst[i, :, :len] = new`` along every dimension (the prompt's
    k/v at the head of the cache's ``kv_seq``; the SSM states whole).
    On a mesh each rank writes its own shard of ``dst``: ``new`` keeps
    ``dst``'s sharding where it spans the whole dimension and is
    gathered where it covers only a prefix of it."""
    if not _is_dtensor(dst):
        dst[(i,) + tuple(slice(0, n) for n in new.shape)] = new.to(
            dst.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = dst.device_mesh
    pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) and p.dim >= 1
               and new.shape[p.dim - 1] == dst.shape[p.dim] else
               Replicate() for p in dst.placements)
    nl = new.redistribute(mesh, pl).to_local()
    (l_lo, l_hi), *rest = local_bounds(dst)
    if not l_lo <= i < l_hi:
        return
    dsl, nsl = [i - l_lo], []
    for (lo, hi), n, p_shard in zip(rest, new.shape,
                                    (any(p.is_shard(d - 1) for p in pl)
                                     for d in range(1, dst.dim()))):
        if p_shard or (lo, hi) == (0, n):
            dsl.append(slice(0, hi - lo))
            nsl.append(slice(None))
        else:   # new covers [0, n) of a dimension dst shards
            m = max(min(hi, n) - lo, 0)
            dsl.append(slice(0, m))
            nsl.append(slice(lo, lo + m))
    dst.to_local()[tuple(dsl)] = nl[tuple(nsl)].to(dst.dtype)


def prefill(cfg, params, batch, plan: ShardingPlan,
            rt: ModelRuntime = ModelRuntime(), max_seq: Optional[int] = None):
    """Process a prompt, returning (last-position logits, filled cache).

    The cache is ``max(max_seq, T)`` long (T counts a VLM's patches),
    zero beyond the prompt, on the parameters' device.  An
    encoder-decoder's decode steps take the encoder's output as
    ``cross_kv`` (:func:`encode`), as in the reference."""
    with plan.region():
        h, positions, cross_kv, _ = _prepare_inputs(cfg, params, batch,
                                                    plan, rt)
        max_seq = max(max_seq or 0, h.shape[1])
        cache = init_cache(cfg, h.shape[0], max_seq, h.dtype, h.device,
                           plan)
        h2, caches = _run_blocks(cfg, params["blocks"], h,
                                 positions=positions, plan=plan, rt=rt,
                                 cache=cache, cross_kv=cross_kv)
        h2 = rms_norm(h2, params["final_norm"], cfg.norm_eps)
        logits = _head(cfg, params, h2[:, -1:, :], plan)
        # the prompt's k/v (length t) at the head of the max_seq cache;
        # the SSM states whole
        for i, blk in enumerate(caches):
            for lk, leaf in blk.items():
                for name, new in leaf.items():
                    _write_prefix(cache[lk][name], i, new)
    return logits, cache


def decode_step(cfg, params, cache, tokens, pos, plan: ShardingPlan,
                rt: ModelRuntime = ModelRuntime(), cross_kv=None,
                drop_free: bool = False):
    """One decode step.  tokens: (B, 1); pos: the current length, an int
    for every row or a (B,) tensor of one per row (continuous batching's
    slots).  Writes every layer's new state (k/v, the SSM and conv
    states) into ``cache`` in place and returns (logits (B, 1, V),
    cache).

    The MoE layers get the reference's capacity for B tokens, so a
    skewed router drops pairs as the reference's ``decode_step`` does.
    ``drop_free`` raises it to at least B (``moe.moe_ffn``): the serving
    loop's step over independent slots, which the reference decodes one
    at a time and so never drops."""
    with plan.region():
        h = _embed(cfg, params, tokens, plan)
        pos_t = torch.as_tensor(pos, dtype=torch.long,
                                device=h.device).reshape(-1)
        h, _ = _run_blocks(cfg, params["blocks"], h,
                           positions=pos_t[:, None], plan=plan, rt=rt,
                           cache=cache, cache_index=pos_t, decode=True,
                           cross_kv=cross_kv, drop_free=drop_free)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        return _head(cfg, params, h, plan), cache
