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
    PDef, Rules, ShardingPlan, init_from_defs, map_defs, pspecs_from_defs,
)

__all__ = ["ModelRuntime", "param_defs", "init_params", "param_pspecs",
           "param_count", "active_param_count", "params_from_numpy",
           "forward_train", "loss_fn", "prefill", "decode_step",
           "init_cache", "encode"]


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
    computed.  ``chunk`` is the SSD chunk size.  The reference's
    ``moe_impl`` comes with the expert-parallel route on a mesh (slice
    G2); its ``unroll`` and ``unroll_chunks`` have no counterpart: the
    port's loops over the superblocks and the SSD chunks are Python
    loops, so there is nothing to unroll."""
    attn_impl: str = "xla"        # "xla" | "xla_chunked" | "flash"
    remat: bool = False           # activation checkpointing per block
    remat_policy: str = "full"    # "full" | "dots" (save matmul outputs)
    chunk: int = 256              # SSD chunk size


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


def init_params(cfg, seed: int = 0, dtype=torch.bfloat16, device=None):
    """Parameters drawn from the reference's distributions by a
    ``torch.Generator`` seeded with ``seed``, on ``device`` (the card by
    default).  Not the reference's values: carry those across with
    :func:`params_from_numpy`."""
    return init_from_defs(param_defs(cfg), seed, dtype, device)


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
def _embed(cfg, params, tokens, plan: ShardingPlan):
    h = params["embed"][tokens.long()]
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
            chunk=rt.chunk, cross_kv=cross_kv, drop_free=drop_free)
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
    h, positions, cross_kv, off = _prepare_inputs(cfg, params, batch,
                                                  plan, rt)
    h, _ = _run_blocks(cfg, params["blocks"], h, positions=positions,
                       plan=plan, rt=rt, cross_kv=cross_kv)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if off:
        h = h[:, off:, :]   # VLM: logits over text positions only
    return _head(cfg, params, h, plan)


def loss_fn(cfg, params, batch, plan: ShardingPlan,
            rt: ModelRuntime = ModelRuntime()):
    """Mean next-token cross-entropy over the labels >= 0 (f32): the
    reference's ``logsumexp - gold``, masked, over ``max(count, 1)``."""
    logits = forward_train(cfg, params, batch, plan, rt)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    # a masked label (< 0) gathers column 0, which the mask zeroes
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)


# ----------------------------------------------------------------------
def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None):
    """Stacked decode cache: every leaf gets the n_super leading axis.
    On ``device`` (the card by default)."""
    dev = resolve_device(device)
    one = empty_cache(cfg, batch, max_seq, dtype, device="meta")
    n = n_super(cfg)
    return {lk: {name: torch.zeros((n,) + t.shape, dtype=t.dtype,
                                   device=dev)
                 for name, t in leaf.items()}
            for lk, leaf in one.items()}


def prefill(cfg, params, batch, plan: ShardingPlan,
            rt: ModelRuntime = ModelRuntime(), max_seq: Optional[int] = None):
    """Process a prompt, returning (last-position logits, filled cache).

    The cache is ``max(max_seq, T)`` long (T counts a VLM's patches),
    zero beyond the prompt, on the parameters' device.  An
    encoder-decoder's decode steps take the encoder's output as
    ``cross_kv`` (:func:`encode`), as in the reference."""
    h, positions, cross_kv, _ = _prepare_inputs(cfg, params, batch, plan,
                                                rt)
    max_seq = max(max_seq or 0, h.shape[1])
    cache = init_cache(cfg, h.shape[0], max_seq, h.dtype, h.device)
    h2, caches = _run_blocks(cfg, params["blocks"], h,
                             positions=positions, plan=plan, rt=rt,
                             cache=cache, cross_kv=cross_kv)
    h2 = rms_norm(h2, params["final_norm"], cfg.norm_eps)
    logits = _head(cfg, params, h2[:, -1:, :], plan)
    # the prompt's k/v (length t) at the head of the max_seq cache; the
    # SSM states whole
    for i, blk in enumerate(caches):
        for lk, leaf in blk.items():
            for name, new in leaf.items():
                cache[lk][name][i, :, :new.shape[1]] = new.to(
                    cache[lk][name].dtype)
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
    h = _embed(cfg, params, tokens, plan)
    pos_t = torch.as_tensor(pos, dtype=torch.long,
                            device=h.device).reshape(-1)
    h, _ = _run_blocks(cfg, params["blocks"], h,
                       positions=pos_t[:, None], plan=plan, rt=rt,
                       cache=cache, cache_index=pos_t, decode=True,
                       cross_kv=cross_kv, drop_free=drop_free)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head(cfg, params, h, plan), cache
