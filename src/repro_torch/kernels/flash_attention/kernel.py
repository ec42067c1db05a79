"""Binding of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

Replaces the reference's ``flash_attention_pallas``: online-softmax
attention with causal and sliding-window masks, logit softcap, GQA, a
``lk_valid`` key mask and the sequence-major entry.  The TPU kernel's
sequential KV grid axis becomes a loop inside each block; its padding of
Lq and Lk to block multiples becomes in-kernel masking, so any length
runs without a padding copy.  The batch axis runs on the grid.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import KernelLib, ptr, require_cuda, stream_ptr

_I, _L, _F, _P = ctypes.c_int, ctypes.c_int64, ctypes.c_float, \
    ctypes.c_void_p
LIB = KernelLib("flash_attention.cu", {"repro_flash_attention": (
    _P, _P, _P, _P, _I, _I, _I, _I, _I, _I) + (_L,) * 12 +
    (_F, _I, _I, _F, _I, _P)})
#: head dims the kernel is instantiated for
HEAD_DIMS = (64, 128, 256)
_MAX_GRID_YZ = 65535


def flash_attention_cuda(q, k, v, *, scale: float, causal: bool = False,
                         window: int = 0, softcap: float = 0.0,
                         lk_valid=None, seq_major: bool = False):
    """q: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D), or all (B, L, H, D) with
    ``seq_major``; the batch axis may be left out.  f32 or bf16, one
    dtype for all, the head dim contiguous.  Returns q's shape and
    dtype."""
    require_cuda(q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention takes f32 or bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    single = q.dim() == 3
    q4, k4, v4 = ((t.unsqueeze(0) if single else t) for t in (q, k, v))
    if {q4.dim(), k4.dim(), v4.dim()} != {4}:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}: expected 3-D or 4-D")
    # strides as (batch, head, position); the head dim has stride 1
    order = (0, 2, 1) if seq_major else (0, 1, 2)

    def axes(t):
        return [t.shape[i] for i in order], [t.stride(i) for i in order]

    (b, hq, lq), sq = axes(q4)
    (bk, hkv, lk), sk = axes(k4)
    (bv, hv, lv), sv = axes(v4)
    d = q4.shape[3]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if (bk, bv) != (b, b) or hv != hkv or lv != lk or \
            k4.shape[3] != d or v4.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} disagree")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads over {hkv} kv heads")
    if any(t.stride(3) != 1 for t in (q4, k4, v4)):
        raise ValueError("the head dim must be contiguous")
    lk_valid = lk if lk_valid is None else int(lk_valid)
    if not 0 <= lk_valid <= lk:
        raise ValueError(f"lk_valid {lk_valid} outside [0, {lk}]")
    if hq > _MAX_GRID_YZ or b > _MAX_GRID_YZ:
        raise ValueError(f"{b} x {hq} heads outside the kernel grid")
    o4 = torch.empty_like(q4, memory_format=torch.contiguous_format)
    so = [o4.stride(i) for i in order]
    if o4.numel():
        LIB.call("repro_flash_attention", ptr(q4), ptr(k4), ptr(v4),
                 ptr(o4), b, hq, hkv, lq, lk_valid, d, *sq, *sk, *sv, *so,
                 float(scale), int(causal), int(window), float(softcap),
                 int(q.dtype == torch.bfloat16), stream_ptr(q.device))
    return o4[0] if single else o4
