"""Shared model components: norms, rotary embeddings, GQA attention
(train/prefill/decode paths, sliding window, softcap).

Port of the reference's ``models/common.py``.  Attention is itself a
*primitive choice* at this level: ``attn_impl`` selects between the
plain einsum path ("xla", named after the reference's) and the flash
kernel (K6, ``kernels.flash_attention``, the hand-written CUDA kernel on
a card), which every prefill takes with ``attn_impl="flash"``.  Decode
keeps the plain path, as the reference does.

Decode here is batched over slots that sit at different positions:
``cache_index`` holds one position per batch row (or one for all), and
each row writes its new key and value at its own index and attends to
the keys up to it.  The reference decodes one slot at a time under
``vmap``; row for row the arithmetic is the same.  The new key and value
are written into the cache tensors in place.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .sharding import (
    PDef, ShardingPlan, _bounds, _is_dtensor, as_placed, local_bounds,
    replicated_like,
)

NEG_INF = -1e30


def rms_norm(x, w, eps: float = 1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def layer_norm(x, w, b, eps: float = 1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


@functools.lru_cache(maxsize=32)
def _rope_freqs(half: int, theta: float, device: torch.device):
    """The rotary frequencies, computed in f64 by numpy and rounded to
    f32, as the reference's meet its f32 positions; one copy per device
    (read-only; no caller writes them)."""
    return torch.from_numpy(1.0 / (theta ** (np.arange(0, half) / half))).to(
        device=device, dtype=torch.float32)


def rope(x, positions, theta: float):
    """x: (..., T, H, D even); positions: (..., T).  The angles are f32
    products of f32 positions and f32 frequencies, as in the reference."""
    d = x.shape[-1]
    half = d // 2
    freqs = _rope_freqs(half, float(theta), x.device)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., T, half)
    cos = replicated_like(torch.cos(ang)[..., None, :], x)
    sin = replicated_like(torch.sin(ang)[..., None, :], x)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
def attention_defs(cfg, d_model: Optional[int] = None) -> Dict[str, PDef]:
    d = d_model or cfg.d_model
    hd = cfg.resolved_head_dim
    return {
        "wq": PDef((d, cfg.n_heads, hd), ("d_model", "heads", "head_dim")),
        "wk": PDef((d, cfg.n_kv_heads, hd),
                   ("d_model", "kv_heads", "head_dim")),
        "wv": PDef((d, cfg.n_kv_heads, hd),
                   ("d_model", "kv_heads", "head_dim")),
        "wo": PDef((cfg.n_heads, hd, d), ("heads", "head_dim", "d_model")),
    }


def _mask(lq, lk, *, causal: bool, window: int, q_offset=0,
          device=None):
    """(lq, lk) mask, or (B, 1, 1, lq, lk) when ``q_offset`` is a
    tensor of one query offset per batch row."""
    qpos = torch.arange(lq, device=device)[:, None]
    kpos = torch.arange(lk, device=device)[None, :]
    if torch.is_tensor(q_offset) and q_offset.dim() > 0:
        qpos = q_offset.reshape(-1, 1, 1, 1, 1) + qpos
    else:
        qpos = qpos + q_offset
    m = torch.ones(torch.broadcast_shapes(qpos.shape, kpos.shape),
                   dtype=torch.bool, device=device)
    if causal:
        m = m & (qpos >= kpos)
    if window > 0:
        m = m & (qpos - kpos < window)
    return m


def dot_attention(q, k, v, *, scale, causal, window, softcap, q_offset=0,
                  kv_valid=None):
    """q: (B, Tq, H, D); k, v: (B, Tk, Hkv, D) — the plain einsum path.

    ``q_offset`` and ``kv_valid`` are ints or (B,) tensors (one per
    batch row: the decode slots' positions)."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, tq, hkv, g, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    m = _mask(tq, tk, causal=causal, window=window, q_offset=q_offset,
              device=q.device)
    if kv_valid is not None:
        kpos = torch.arange(tk, device=q.device)
        if torch.is_tensor(kv_valid) and kv_valid.dim() > 0:
            valid = kpos < kv_valid.reshape(-1, 1, 1, 1, 1)
        else:
            valid = kpos < kv_valid
        m = m & valid
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, tq, h, d).to(q.dtype)


def chunked_causal_attention(q, k, v, *, scale, softcap, chunk: int = 0):
    """Causal attention computing only the lower-triangular chunk pairs.

    The plain-path analogue of flash attention's fully-masked-block skip:
    query chunk i attends to KV [0, (i+1)*chunk) only, so score FLOPs
    drop from T^2 to T^2/2 (+ diagonal overhead).
    """
    b, t, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    if chunk <= 0:
        # 4 chunks, as the reference picks
        chunk = max(512, t // 4)
    nc = max(t // chunk, 1)
    chunk = t // nc
    outs = []
    for i in range(nc):
        qi = q[:, i * chunk:(i + 1) * chunk]
        kv_len = (i + 1) * chunk
        ki = k[:, :kv_len]
        vi = v[:, :kv_len]
        qg = qi.reshape(b, chunk, hkv, g, d)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                         ki.float()) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        qpos = i * chunk + torch.arange(chunk, device=q.device)[:, None]
        kpos = torch.arange(kv_len, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, NEG_INF)
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", pr, vi.float())
        outs.append(o.reshape(b, chunk, h, d).to(q.dtype))
    return torch.cat(outs, dim=1)


def _on_shards(fn, q, k, v, *per_row):
    """``fn(q, k, v, *per_row)``, the attention core, on this rank's
    shards: a counterpart of ``shard_map`` for attention on a mesh.

    q keeps its batch and heads sharding (every other dimension is
    gathered); k and v take q's batch sharding, and its heads sharding
    where the kv heads divide as evenly (then local q head j meets local
    kv head ``j // g``, as on one device).  Where they do not (kv heads
    replicated while q's heads are sharded, e.g. 4 heads on 2 kv heads
    over ``model: 4``), each rank takes the kv heads of its own q heads:
    a block of them when its q heads split evenly over that block, else
    one per q head.  ``per_row``: ints or (B,) tensors of one entry per
    batch row (decode's offsets), cut to this rank's rows.  Plain
    tensors go straight to ``fn``."""
    if not _is_dtensor(q):
        return fn(q, k, v, *per_row)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    qp = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else
               Replicate() for p in q.placements)
    tp = int(np.prod([mesh.size(i) for i, p in enumerate(qp)
                      if p.is_shard(2)]))
    h, hkv = q.shape[2], k.shape[2]
    aligned = hkv % tp == 0
    kp = tuple(p if p.is_shard(0) or (p.is_shard(2) and aligned) else
               Replicate() for p in qp)
    # kv replicated where q's heads are sharded: each rank's gradient of
    # them is a partial sum (its own heads' share)
    kg = tuple(Partial() if q_.is_shard(2) and not k_.is_shard() else k_
               for q_, k_ in zip(qp, kp))
    ql = q.redistribute(mesh, qp).to_local()
    kl = k.redistribute(mesh, kp).to_local(grad_placements=kg)
    vl = v.redistribute(mesh, kp).to_local(grad_placements=kg)
    (b_lo, b_hi), _, (h_lo, h_hi), _ = _bounds(mesh, qp, q.shape)
    if not aligned:
        idx = torch.arange(h_lo, h_hi) // (h // hkv)
        lo, n, hl = int(idx[0]), int(idx[-1] - idx[0]) + 1, h_hi - h_lo
        if hl % n == 0 and bool(torch.equal(
                idx, lo + torch.arange(hl) // (hl // n))):
            kl, vl = kl[:, :, lo:lo + n], vl[:, :, lo:lo + n]
        else:
            sel = idx.to(kl.device)
            kl, vl = kl[:, :, sel], vl[:, :, sel]
        kl, vl = kl.contiguous(), vl.contiguous()
    rows = [r[b_lo:b_hi] if torch.is_tensor(r) and r.dim() > 0
            and r.shape[0] == q.shape[0] > 1 else r for r in per_row]
    o = fn(ql, kl, vl, *rows)
    return as_placed(o, mesh, qp, q.shape)


def _write_rows(cache, new, idx):
    """``cache[b, idx[b]] = new[b]`` for every row b, in place: the
    decode step's new key or value.  cache: (B, S, Hkv, D); new: (B,
    Hkv, D); idx: (B,) long.  On a mesh each rank writes the rows and
    positions of its own shard of the cache (a row whose position lies
    in another rank's share of ``kv_seq`` writes its old value back)."""
    if not _is_dtensor(cache):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, idx] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    npl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) and p.dim >= 2
                else p if p.is_shard(0) else Replicate()
                for p in cache.placements)
    nl = new.redistribute(mesh, npl).to_local()
    cl = cache.to_local()
    (b_lo, b_hi), (s_lo, s_hi), _, _ = local_bounds(cache)
    il = (idx[b_lo:b_hi] if idx.shape[0] > 1 else
          idx.expand(b_hi - b_lo)).to(cl.device) - s_lo
    inside = (il >= 0) & (il < s_hi - s_lo)
    il = il.clamp(0, max(s_hi - s_lo - 1, 0))
    rows = torch.arange(b_hi - b_lo, device=cl.device)
    cl[rows, il] = torch.where(inside[:, None, None], nl.to(cl.dtype),
                               cl[rows, il])


def attention(cfg, p, x, *, positions, plan: ShardingPlan,
              causal: bool = True, window: int = 0,
              kv_cache: Optional[Tuple] = None,
              cache_index=None,
              xk: Optional[torch.Tensor] = None,
              attn_impl: str = "xla"):
    """Full attention layer: projections + rope + attention + out proj.

    kv_cache: (k_cache, v_cache) of (B, S, Hkv, D); with ``cache_index``
    given (a (B,) or (1,) integer tensor: each row's position), the new
    k/v are written in place at each row's index (decode) and attention
    runs against the cache.  ``xk``: cross-attention source (B, S, D)
    (the whisper decoder): keys and values come from it, without rope.
    Returns (out, new_cache).
    """
    hd = cfg.resolved_head_dim
    scale = hd ** -0.5
    src = x if xk is None else xk
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"])
    if xk is None:  # rope only for self-attention
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions if cache_index is None else
                 cache_index[..., None], cfg.rope_theta)
    q = plan.constrain(q, "batch", "seq", "heads", "head_dim")
    k = plan.constrain(k, "batch", "seq", "kv_heads", "head_dim")
    v = plan.constrain(v, "batch", "seq", "kv_heads", "head_dim")

    new_cache = None
    kv_valid = None
    q_offset = 0
    if kv_cache is not None:
        ck, cv = kv_cache
        if cache_index is not None:
            # decode: write each row's new kv at its own index
            idx = cache_index.reshape(-1).to(torch.long).expand(
                ck.shape[0])
            _write_rows(ck, k[:, 0], idx)
            _write_rows(cv, v[:, 0], idx)
            k, v = ck, cv
            kv_valid = idx + 1
            q_offset = idx
            causal = False  # masking handled via kv_valid
            new_cache = (ck, cv)
        else:
            # prefill: the freshly-computed prompt k/v ARE the cache
            new_cache = (k, v)

    if attn_impl == "flash" and cache_index is None:
        from ..kernels.flash_attention import flash_attention
        # sequence-major, as the projections leave q, k and v
        o = _on_shards(functools.partial(
            flash_attention, scale=scale, causal=causal, window=window,
            softcap=cfg.attn_softcap, layout="LHD"), q, k, v)
    elif (attn_impl == "xla_chunked" and cache_index is None and causal
          and window == 0 and xk is None and q.shape[1] >= 1024):
        o = _on_shards(functools.partial(
            chunked_causal_attention, scale=scale,
            softcap=cfg.attn_softcap), q, k, v)
    else:
        o = _on_shards(lambda q_, k_, v_, off, valid: dot_attention(
            q_, k_, v_, scale=scale, causal=causal, window=window,
            softcap=cfg.attn_softcap, q_offset=off, kv_valid=valid),
            q, k, v, q_offset, kv_valid)
    o = plan.constrain(o, "batch", "seq", "heads", "head_dim")
    out = torch.einsum("bthk,hkd->btd", o, p["wo"])
    return plan.constrain(out, "batch", "seq", "d_model"), new_cache


# ----------------------------------------------------------------------
def ffn_defs(cfg, d_model: Optional[int] = None, gated: bool = True):
    d = d_model or cfg.d_model
    f = cfg.d_ff
    defs = {
        "w1": PDef((d, f), ("d_model", "d_ff")),
        "w2": PDef((f, d), ("d_ff", "d_model")),
    }
    if gated:
        defs["w3"] = PDef((d, f), ("d_model", "d_ff"))
    return defs


def ffn(p, x, plan: ShardingPlan, act=F.silu):
    h = torch.einsum("btd,df->btf", x, p["w1"])
    if "w3" in p:
        h = act(h) * torch.einsum("btd,df->btf", x, p["w3"])
    else:
        h = act(h)
    h = plan.constrain(h, "batch", "seq", "d_ff")
    out = torch.einsum("btf,fd->btd", h, p["w2"])
    return plan.constrain(out, "batch", "seq", "d_model")
