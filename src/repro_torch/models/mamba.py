"""Mamba2 (SSD — state-space duality) block, chunked formulation.

Port of the reference's ``models/mamba.py``.  The SSD recurrence per
head h (scalar decay a_t = exp(A * dt_t)):

    S_t = a_t * S_{t-1} + dt_t * B_t (x) x_t         (N x P state)
    y_t = C_t . S_t + D * x_t

computed chunk-parallel (arXiv 2405.21060 §6): within a chunk of Q
tokens the output is an attention-like (Q x Q) masked matmul
("duality"); across chunks a loop carries the (B, H, N, P) state in
f32.  The reference's ``lax.scan`` over the chunks is a Python loop
here, so the reference's ``unroll`` switch has no counterpart.

Decode is the O(1) recurrence on the carried state.  The scan, the
causal depthwise conv and the gated norm are framework ops, as in the
reference: no kernel of the port is on this path.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .sharding import PDef, ShardingPlan, replicated_like

__all__ = ["mamba_dims", "mamba_defs", "ssd_chunked", "mamba_block"]


def mamba_dims(cfg) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_headdim
    return d_inner, heads, cfg.ssm_headdim, cfg.ssm_state


def mamba_defs(cfg) -> Dict[str, PDef]:
    d = cfg.d_model
    d_inner, h, p_, n = mamba_dims(cfg)
    conv_dim = d_inner + 2 * n
    return {
        # packed projection: [z (d_inner), x (d_inner), B (N), C (N), dt (H)]
        "in_proj": PDef((d, 2 * d_inner + 2 * n + h), ("d_model", "ssm_heads")),
        "conv_w": PDef((cfg.ssm_conv, conv_dim), (None, "ssm_heads")),
        "conv_b": PDef((conv_dim,), ("ssm_heads",), init="zeros"),
        "a_log": PDef((h,), ("ssm_heads",), init="ones"),
        "d_skip": PDef((h,), ("ssm_heads",), init="ones"),
        "dt_bias": PDef((h,), ("ssm_heads",), init="zeros"),
        "norm_w": PDef((d_inner,), ("ssm_heads",), init="ones"),
        "out_proj": PDef((d_inner, d), ("ssm_heads", "d_model")),
    }


def _split(cfg, proj):
    d_inner, h, p_, n = mamba_dims(cfg)
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:2 * d_inner + 2 * n]
    dt = proj[..., 2 * d_inner + 2 * n:]
    return z, xbc, dt


def _causal_conv(xbc, w, b, *, state=None):
    """Depthwise causal conv over time.  xbc: (B, T, C); w: (K, C).

    With ``state`` (B, K-1, C) given (decode), returns (y, new_state)."""
    k = w.shape[0]
    t = xbc.shape[1]
    if state is not None:
        window = torch.cat([state, xbc], dim=1)     # (B, K-1+T, C)
        new_state = window[:, -(k - 1):, :]
        y = sum(window[:, i:i + t, :] * w[i] for i in range(k))
        return F.silu(y + b), new_state
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    y = sum(pad[:, i:i + t, :] * w[i] for i in range(k))
    return F.silu(y + b), None


def _gated_rmsnorm(y, z, w, eps=1e-5):
    y = y * F.silu(z)
    y32 = y.float()
    var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    return (y32 * torch.rsqrt(var + eps)).to(y.dtype) * w


def ssd_chunked(xh, dt, a_neg, B_, C_, *, chunk: int, init_state=None):
    """Chunk-parallel SSD.

    xh: (B, T, H, P); dt: (B, T, H); a_neg: (H,) (negative decay rates);
    B_, C_: (B, T, N).  Returns (y (B,T,H,P), final_state (B,H,N,P) in
    f32)."""
    b, t, h, p_ = xh.shape
    n = B_.shape[-1]
    q = min(chunk, t)
    t_orig = t
    if t % q:
        # zero-pad: dt=0 => decay exp(0)=1 and zero increment, so padded
        # positions are exactly neutral for the state
        pad = q - t % q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
        t = t + pad
    nc = t // q

    # per-token log decay  l_t = a_neg * dt_t  (<= 0), in f32
    ldec = a_neg[None, None, :] * dt                     # (B, T, H)
    xc = xh.reshape(b, nc, q, h, p_).float()
    dtc = dt.reshape(b, nc, q, h).float()
    lc = ldec.reshape(b, nc, q, h)
    Bc = B_.reshape(b, nc, q, n).float()
    Cc = C_.reshape(b, nc, q, n).float()
    cum = torch.cumsum(lc, dim=2)                        # (B, nc, Q, H)
    tri = replicated_like(torch.tril(torch.ones(
        (q, q), dtype=torch.bool, device=xh.device))[None, :, :, None], xh)
    strict = replicated_like(torch.tril(torch.ones(
        (q, q), dtype=torch.bool, device=xh.device), -1)[None, :, :, None],
        xh)

    state = init_state if init_state is not None else replicated_like(
        torch.zeros((b, h, n, p_), dtype=torch.float32, device=xh.device),
        xh)
    ys = []
    for ci in range(nc):
        cumi = cum[:, ci]                                # (B, Q, H)
        # intra-chunk duality: M[t,s] = (C_t.B_s) exp(cum_t - cum_s) dt_s,
        # each segment sum cum_t - cum_s = sum_{s<r<=t} l_r summed directly
        seg = torch.cumsum(torch.where(strict, lc[:, ci][:, :, None, :],
                                       0.0), dim=1)      # (B, Q, Q, H)
        # mask BEFORE exp: exp of the (positive) upper triangle overflows
        gamma = torch.exp(torch.where(tri, seg, -1e30))
        cb = torch.einsum("bqn,bsn->bqs", Cc[:, ci], Bc[:, ci])
        m = cb[:, :, :, None] * gamma * dtc[:, ci][:, None, :, :]
        y_intra = torch.einsum("bqsh,bshp->bqhp", m, xc[:, ci])
        # inter-chunk: contribution of the entering state
        y_inter = torch.einsum("bqn,bhnp,bqh->bqhp", Cc[:, ci], state,
                               torch.exp(cumi))
        # chunk state update
        decay_to_end = torch.exp(seg[:, -1])             # (B, Q, H)
        s_new = torch.einsum("bsn,bshp,bsh,bsh->bhnp", Bc[:, ci], xc[:, ci],
                             dtc[:, ci], decay_to_end)
        state = state * torch.exp(cumi[:, -1])[..., None, None] + s_new
        ys.append((y_intra + y_inter).to(xh.dtype))
    y = torch.stack(ys, dim=1)
    return y.reshape(b, t, h, p_)[:, :t_orig], state


def mamba_block(cfg, p, x, plan: ShardingPlan, *, chunk: int = 256,
                ssm_state=None, conv_state=None, decode: bool = False):
    """x: (B, T, D) -> (out (B, T, D), (ssm state, conv state)).

    ``decode=True`` (T == 1) runs the recurrence from the carried
    ``ssm_state`` (B, H, N, P) and ``conv_state`` (B, K-1, C) and returns
    new tensors for both (the caller writes them back); otherwise the
    chunked scan (from ``ssm_state`` if given), and the conv state is the
    last K-1 raw conv inputs, left-padded with zeros when T < K-1."""
    d_inner, h, p_, n = mamba_dims(cfg)
    proj = torch.einsum("btd,de->bte", x, p["in_proj"])
    z, xbc, dt = _split(cfg, proj)
    dt = F.softplus(dt + p["dt_bias"])                   # (B, T, H)
    raw_xbc = xbc
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 state=conv_state if decode else None)
    if not decode:
        # prefill/train: the conv state is the last K-1 raw inputs
        kc = cfg.ssm_conv - 1
        if raw_xbc.shape[1] >= kc:
            new_conv = raw_xbc[:, raw_xbc.shape[1] - kc:, :]
        else:
            new_conv = F.pad(raw_xbc, (0, 0, kc - raw_xbc.shape[1], 0))
    xin = xbc[..., :d_inner]
    B_ = xbc[..., d_inner:d_inner + n]
    C_ = xbc[..., d_inner + n:]
    xh = xin.reshape(*xin.shape[:-1], h, p_)
    xh = plan.constrain(xh, "batch", "seq", "ssm_heads", None)
    a_neg = -torch.exp(p["a_log"].float())

    if decode:
        # single-token recurrence (T == 1)
        dt1 = dt[:, 0].float()                           # (B, H)
        decay = torch.exp(a_neg[None] * dt1)             # (B, H)
        upd = torch.einsum("bn,bhp,bh->bhnp", B_[:, 0].float(),
                           xh[:, 0].float(), dt1)
        new_state = ssm_state * decay[..., None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", C_[:, 0].float(),
                         new_state)[:, None].to(x.dtype)
        y = y.reshape(x.shape[0], 1, h, p_)
    else:
        y, new_state = ssd_chunked(xh, dt, a_neg, B_, C_, chunk=chunk,
                                   init_state=ssm_state)
    y = y + xh * p["d_skip"][None, None, :, None]
    y = y.reshape(*x.shape[:-1], d_inner)
    y = _gated_rmsnorm(y, z, p["norm_w"])
    out = torch.einsum("bte,ed->btd", y, p["out_proj"])
    out = plan.constrain(out, "batch", "seq", "d_model")
    return out, (new_state, new_conv)
