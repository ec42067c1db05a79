"""Per-family superblock definitions.

Port of the reference's ``models/blocks.py``: every architecture is a
*superblock* of ``period`` layers repeated ``n_layers / period`` times
over parameters stacked on a leading ``layers`` axis.  The reference
scans over that axis; the port loops over it (``models.model``).

Layer kinds within a superblock:
  dense:   [attn+ffn]                       (gemma2: [local, global])
  moe:     [attn+moe_ffn]
  hybrid:  jamba 8-block period, attention at index 4, MoE every 2nd
  ssm:     [mamba]

Decode writes every layer's new state into the cache it is given, in
place: attention its new key and value (``common.attention``), a Mamba
mixer its new ``ssm`` and ``conv`` states.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from .common import attention, attention_defs, ffn, ffn_defs, rms_norm
from .mamba import mamba_block, mamba_defs, mamba_dims
from .moe import moe_defs, moe_ffn
from .sharding import PDef, ShardingPlan, _is_dtensor, map_defs


def layer_kinds(cfg) -> List[Dict[str, Any]]:
    """The layer pattern of one superblock; len == period."""
    fam = cfg.family
    if fam == "ssm":
        return [{"mixer": "mamba", "ffn": "none"}]
    if fam == "hybrid":
        out = []
        for i in range(cfg.attn_every):
            out.append({
                "mixer": "attn" if i == cfg.attn_every // 2 else "mamba",
                "ffn": "moe" if (i % cfg.moe_every == 1) else "dense",
                "window": 0,
            })
        return out
    if fam == "moe":
        return [{"mixer": "attn", "ffn": "moe", "window": 0}
                for _ in range(cfg.moe_every)]
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
        if kind["mixer"] == "attn":
            b["attn"] = attention_defs(cfg)
        else:
            b["mamba"] = mamba_defs(cfg)
        if cfg.family == "encdec":
            b["norm_x"] = PDef((d,), ("d_model",), init="ones")
            b["cross"] = attention_defs(cfg)
        if kind["ffn"] != "none" and not cfg.parallel_block:
            b["norm2"] = PDef((d,), ("d_model",), init="ones")
        if kind["ffn"] == "dense":
            b["ffn"] = ffn_defs(cfg)
        elif kind["ffn"] == "moe":
            b["moe"] = moe_defs(cfg)
        if cfg.post_norms:
            b["post_norm1"] = PDef((d,), ("d_model",), init="ones")
            if kind["ffn"] != "none":
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
    """Per-superblock decode cache (unstacked shapes; stacked by model):
    k/v for attention layers, the f32 ``ssm`` state and the ``conv``
    window (in the model dtype) for Mamba layers."""
    cache: Dict[str, Any] = {}
    for i, kind in enumerate(layer_kinds(cfg)):
        if kind["mixer"] == "attn":
            # sliding-window layers also keep a full-length linear cache
            # (window masking handles semantics), as in the reference
            shape = (batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
            cache[f"layer{i}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
            }
        else:
            d_inner, h, p_, n = mamba_dims(cfg)
            cache[f"layer{i}"] = {
                "ssm": torch.zeros((batch, h, n, p_), dtype=torch.float32,
                                   device=device),
                "conv": torch.zeros((batch, cfg.ssm_conv - 1,
                                     d_inner + 2 * n), dtype=dtype,
                                    device=device),
            }
    return cache


def _alltoall_fits(cfg, plan: ShardingPlan, x) -> bool:
    """The reference's condition for the all-to-all MoE: a mesh with a
    ``model`` axis dividing the expert count and the sequence."""
    if plan.mesh is None or "model" not in plan.mesh.mesh_dim_names:
        return False
    tp = plan.mesh.size(plan.mesh.mesh_dim_names.index("model"))
    return cfg.n_experts % tp == 0 and x.shape[1] % tp == 0


def _assign(dst, src):
    """``dst.copy_(src)`` in place; on a mesh into ``dst``'s own shard,
    ``src`` redistributed to ``dst``'s placements first."""
    if _is_dtensor(dst):
        src = src.redistribute(dst.device_mesh, dst.placements).to_local()
        dst = dst.to_local()
    dst.copy_(src)


def apply_superblock(cfg, params, h, *, positions, plan: ShardingPlan,
                     cache=None, cache_index=None, decode: bool = False,
                     attn_impl: str = "xla", chunk: int = 256,
                     cross_kv=None, drop_free: bool = False,
                     moe_impl: str = "gather"):
    """Run one superblock.  Returns (h, new_cache).

    With ``decode``, every layer's new state goes into ``cache`` in place.
    Cross-attention (the encoder-decoder family, given ``cross_kv``)
    takes the plain path, as in the reference.  ``drop_free`` gives the
    MoE FFNs a capacity of at least their token count (``moe_ffn``).
    ``moe_impl="alltoall"`` takes the expert-parallel all-to-all MoE
    (``moe.moe_ffn_alltoall``) where the reference does: on a mesh with
    a ``model`` axis that divides the expert count and the sequence."""
    new_cache: Dict[str, Any] = {}
    for i, kind in enumerate(layer_kinds(cfg)):
        p = params[f"layer{i}"]
        c = cache.get(f"layer{i}") if cache else None
        resid = h
        x = rms_norm(h, p["norm1"], cfg.norm_eps)
        if kind["mixer"] == "attn":
            kv = (c["k"], c["v"]) if c else None
            mix_out, nkv = attention(
                cfg, p["attn"], x, positions=positions, plan=plan,
                causal=True, window=kind.get("window", 0), kv_cache=kv,
                cache_index=cache_index, attn_impl=attn_impl)
            if nkv is not None:
                new_cache[f"layer{i}"] = {"k": nkv[0], "v": nkv[1]}
        else:
            mix_out, (nssm, nconv) = mamba_block(
                cfg, p["mamba"], x, plan, chunk=chunk,
                ssm_state=c["ssm"] if (c and decode) else None,
                conv_state=c["conv"] if (c and decode) else None,
                decode=decode)
            if c is not None:
                if decode:
                    _assign(c["ssm"], nssm)
                    _assign(c["conv"], nconv)
                new_cache[f"layer{i}"] = {"ssm": nssm, "conv": nconv}
        if cfg.post_norms:
            mix_out = rms_norm(mix_out, p["post_norm1"], cfg.norm_eps)

        if cfg.family == "encdec" and cross_kv is not None:
            h = resid + mix_out
            resid = h
            x = rms_norm(h, p["norm_x"], cfg.norm_eps)
            mix_out, _ = attention(cfg, p["cross"], x, positions=positions,
                                   plan=plan, causal=False, xk=cross_kv,
                                   attn_impl="xla")

        if cfg.parallel_block and kind["ffn"] == "dense":
            ff_out = ffn(p["ffn"], x, plan)
            h = resid + mix_out + ff_out
            continue

        h = resid + mix_out
        if kind["ffn"] == "none":
            continue
        resid = h
        x = rms_norm(h, p["norm2"], cfg.norm_eps)
        if kind["ffn"] == "dense":
            ff_out = ffn(p["ffn"], x, plan)
        elif moe_impl == "alltoall" and _alltoall_fits(cfg, plan, x):
            from .moe import moe_ffn_alltoall
            ff_out = moe_ffn_alltoall(cfg, p["moe"], x, plan)
        else:
            ff_out = moe_ffn(cfg, p["moe"], x, plan, drop_free=drop_free)
        if cfg.post_norms:
            ff_out = rms_norm(ff_out, p["post_norm2"], cfg.norm_eps)
        h = resid + ff_out
    return h, (new_cache if cache is not None else None)
