"""Full language-model assembly: embeddings -> stacked superblocks ->
head; forward / prefill / decode entry points.

Port of the reference's ``models/model.py`` for every family (dense,
MoE, SSM, hybrid, encoder-decoder, VLM).  The parameters and the decode
cache keep the reference's nested dicts, keys and stacked shapes (a
leading ``layers`` axis over the superblocks); the reference's
``lax.scan`` over that axis is a Python loop here.  Training
(``loss_fn``, gradients) comes with the ROADMAP's slice F3.

:func:`init_params` and :func:`params_from_numpy` put the parameters on
the card unless told otherwise (``device="cpu"``), and raise without
one.  The other entry points run where the parameters lie.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import numpy as np
import torch

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
           "forward_train", "prefill", "decode_step", "init_cache",
           "encode"]


@dataclass(frozen=True)
class ModelRuntime:
    """Execution knobs (the LM-side primitive/variant choices).

    ``attn_impl`` picks prefill's attention: "xla" (the plain einsum
    path), "xla_chunked" (its causal chunked form at T >= 1024) or
    "flash" (the flash kernel, K6).  ``chunk`` is the SSD chunk size.
    The reference's other fields come with the slices that read them:
    remat and scan unrolling with training (F3), ``moe_impl`` with the
    expert-parallel route on a mesh (G).  The reference's
    ``unroll_chunks`` has no counterpart: the port loops over the SSD
    chunks in Python, so there is nothing to unroll."""
    attn_impl: str = "xla"        # "xla" | "xla_chunked" | "flash"
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


def _layer(tree, i: int):
    """Superblock ``i`` of a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _run_blocks(cfg, blocks_params, h, *, positions, plan, rt: ModelRuntime,
                cache=None, cache_index=None, decode=False, cross_kv=None,
                drop_free=False):
    """The superblocks in order over the stacked ``layers`` axis.
    Returns (h, per-superblock caches or None); with ``decode`` every
    superblock's new state is also written into ``cache`` in place."""
    caches = []
    for i in range(n_super(cfg)):
        h, ncache = apply_superblock(
            cfg, _layer(blocks_params, i), h, positions=positions,
            plan=plan, cache=None if cache is None else _layer(cache, i),
            cache_index=cache_index, decode=decode,
            attn_impl=rt.attn_impl, chunk=rt.chunk, cross_kv=cross_kv,
            drop_free=drop_free)
        caches.append(ncache)
    return h, (None if cache is None else caches)


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
    for i in range(n_super(enc_cfg)):
        p = _layer(params["enc_blocks"], i)["layer0"]
        x = rms_norm(h, p["norm1"], cfg.norm_eps)
        a, _ = attention(enc_cfg, p["attn"], x, positions=positions,
                         plan=plan, causal=False, attn_impl=rt.attn_impl)
        h = h + a
        x = rms_norm(h, p["norm2"], cfg.norm_eps)
        h = h + ffn(p["ffn"], x, plan)
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
    a VLM; no gradients: training is slice F3)."""
    h, positions, cross_kv, off = _prepare_inputs(cfg, params, batch,
                                                  plan, rt)
    h, _ = _run_blocks(cfg, params["blocks"], h, positions=positions,
                       plan=plan, rt=rt, cross_kv=cross_kv)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if off:
        h = h[:, off:, :]   # VLM: logits over text positions only
    return _head(cfg, params, h, plan)


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
