"""Plain PyTorch version of the flash-attention kernel.

It follows the reference's Pallas kernel (``_flash_kernel``), not its
dense oracle ``attention_ref``: masked logits are NEG_INF, the
probabilities are ``where(mask, exp(s - max), 0)``, and a row whose every
key is masked outputs 0 (``attention_ref`` gives such a row the uniform
average of V).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, scale: float, causal: bool = False,
                        window: int = 0, softcap: float = 0.0,
                        lk_valid=None, seq_major: bool = False):
    """q: (..., Hq, Lq, D); k, v: (..., Hkv, Lk, D) -> (..., Hq, Lq, D),
    or all sequence-major (..., L, H, D) with ``seq_major``.  f32
    arithmetic, the output in q's dtype; GQA reads kv head h // group;
    keys at or beyond ``lk_valid`` (default Lk) are masked."""
    if seq_major:
        q, k, v = (t.transpose(-3, -2) for t in (q, k, v))
    hq, lq = q.shape[-3], q.shape[-2]
    hkv, lk = k.shape[-3], k.shape[-2]
    group = hq // hkv
    kr = k.float().repeat_interleave(group, dim=-3)
    vr = v.float().repeat_interleave(group, dim=-3)
    s = (q.float() * scale) @ kr.transpose(-1, -2)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(lq, device=q.device)[:, None]
    kp = torch.arange(lk, device=q.device)[None, :]
    mask = kp < (lk if lk_valid is None else lk_valid)
    if causal:
        mask = mask & (qp >= kp)
    if window > 0:
        mask = mask & (qp - kp < window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    out = ((p @ vr) / torch.where(l == 0, 1.0, l)).to(q.dtype)
    if seq_major:
        out = out.transpose(-3, -2)
    return out.contiguous()
