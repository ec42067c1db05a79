"""Per-family superblock definitions.

Port of the reference's ``models/blocks.py`` for the ``dense`` family
(and the dense decoders of ``encdec`` and ``vlm``): every architecture is
a *superblock* of ``period`` layers repeated ``n_layers / period`` times
over parameters stacked on a leading ``layers`` axis.  The reference
scans over that axis; the port loops over it (``models.model``).

Layer kinds within a superblock:
  dense:   [attn+ffn]                       (gemma2: [local, global])

The ``moe``, ``ssm`` and ``hybrid`` families (mixture-of-experts FFNs and
Mamba mixers) come with the ROADMAP's slice F2; until then
:func:`layer_kinds` refuses them.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from .common import attention, attention_defs, ffn, ffn_defs, rms_norm
from .sharding import PDef, ShardingPlan, map_defs

#: families whose blocks the port has
PORTED_FAMILIES = ("dense", "encdec", "vlm")


def require_ported(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family (MoE FFNs, Mamba "
            f"mixers) is not ported yet: ROADMAP slice F2")


def layer_kinds(cfg) -> List[Dict[str, Any]]:
    """The layer pattern of one superblock; len == period."""
    require_ported(cfg)
    # dense / encdec / vlm decoders
    period = max(1, cfg.local_global_period)
    out = []
    for i in range(period):
        local = cfg.local_global_period > 0 and i % 2 == 0
        out.append({"mixer": "attn", "ffn": "dense",
                    "window": cfg.sliding_window if local else 0})
    return out


def n_super(cfg) -> int:
    period = len(layer_kinds(cfg))
    assert cfg.n_layers % period == 0, (cfg.name, cfg.n_layers, period)
    return cfg.n_layers // period


# ----------------------------------------------------------------------
def block_defs(cfg) -> Dict[str, Dict[str, PDef]]:
    """PDefs for ONE superblock (unstacked)."""
    d = cfg.d_model
    defs: Dict[str, Dict[str, PDef]] = {}
    for i, kind in enumerate(layer_kinds(cfg)):
        b: Dict[str, Any] = {"norm1": PDef((d,), ("d_model",), init="ones")}
        b["attn"] = attention_defs(cfg)
        if cfg.family == "encdec":
            b["norm_x"] = PDef((d,), ("d_model",), init="ones")
            b["cross"] = attention_defs(cfg)
        if not cfg.parallel_block:
            b["norm2"] = PDef((d,), ("d_model",), init="ones")
        b["ffn"] = ffn_defs(cfg)
        if cfg.post_norms:
            b["post_norm1"] = PDef((d,), ("d_model",), init="ones")
            b["post_norm2"] = PDef((d,), ("d_model",), init="ones")
        defs[f"layer{i}"] = b
    return defs


def stack_defs(defs, n: int):
    """Add the stacked 'layers' leading axis to every PDef."""
    return map_defs(
        lambda p: PDef((n,) + p.shape, ("layers",) + p.axes, p.init,
                       p.scale), defs)


# ----------------------------------------------------------------------
def empty_cache(cfg, batch: int, max_seq: int, dtype,
                device=None) -> Dict[str, Any]:
    """Per-superblock decode cache (unstacked shapes; stacked by model)."""
    cache: Dict[str, Any] = {}
    hd = cfg.resolved_head_dim
    for i, _ in enumerate(layer_kinds(cfg)):
        # sliding-window layers also keep a full-length linear cache
        # (window masking handles semantics), as in the reference
        shape = (batch, max_seq, cfg.n_kv_heads, hd)
        cache[f"layer{i}"] = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
    return cache


def apply_superblock(cfg, params, h, *, positions, plan: ShardingPlan,
                     cache=None, cache_index=None, attn_impl: str = "xla"):
    """Run one superblock.  Returns (h, new_cache).  (The reference's
    SSM, MoE and cross-attention arguments come with slice F2.)"""
    new_cache: Dict[str, Any] = {}
    for i, kind in enumerate(layer_kinds(cfg)):
        p = params[f"layer{i}"]
        c = cache.get(f"layer{i}") if cache else None
        resid = h
        x = rms_norm(h, p["norm1"], cfg.norm_eps)
        kv = (c["k"], c["v"]) if c else None
        mix_out, nkv = attention(
            cfg, p["attn"], x, positions=positions, plan=plan,
            causal=True, window=kind.get("window", 0), kv_cache=kv,
            cache_index=cache_index, attn_impl=attn_impl)
        if nkv is not None:
            new_cache[f"layer{i}"] = {"k": nkv[0], "v": nkv[1]}
        if cfg.post_norms:
            mix_out = rms_norm(mix_out, p["post_norm1"], cfg.norm_eps)

        if cfg.parallel_block:
            ff_out = ffn(p["ffn"], x, plan)
            h = resid + mix_out + ff_out
            continue

        h = resid + mix_out
        resid = h
        x = rms_norm(h, p["norm2"], cfg.norm_eps)
        ff_out = ffn(p["ffn"], x, plan)
        if cfg.post_norms:
            ff_out = rms_norm(ff_out, p["post_norm2"], cfg.norm_eps)
        h = resid + ff_out
    return h, (new_cache if cache is not None else None)
