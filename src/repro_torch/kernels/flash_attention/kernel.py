"""Binding of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

Replaces the reference's ``flash_attention_pallas``: online-softmax
attention with causal and sliding-window masks, logit softcap, GQA, a
``lk_valid`` key mask and the sequence-major entry, at any head dim.
The TPU kernel's sequential KV grid axis becomes a loop inside each
block, split across the blocks of a thread-block cluster whose partial
softmax statistics are merged in shared memory (:mod:`.plan` picks the
query tile and the split); its padding of Lq and Lk to block multiples
becomes in-kernel masking, and its head dim is padded to an instantiated
width by zero-filled copies, so any length and head dim run without a
padding copy.  The batch axis runs on the grid.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import KernelLib, ptr, require_cuda, stream_ptr
from .plan import AttnPlan, pin_attention, plan_attention

_I, _L, _F, _P = ctypes.c_int, ctypes.c_int64, ctypes.c_float, \
    ctypes.c_void_p
LIB = KernelLib("flash_attention.cu", {"repro_flash_attention": (
    _P, _P, _P, _P, _I, _I, _I, _I, _I, _I) + (_L,) * 12 +
    (_F, _I, _I, _F, _I, _I, _I, _I, _P)})
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_GRID_YZ = 65535


def _operands(q, k, v, lk_valid, seq_major):
    """(q, k, v) as 4-D views, their (batch, head, position) shapes and
    strides, D and lk_valid, after the checks."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention takes f32, bf16 or f16, got "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    q4, k4, v4 = ((t.unsqueeze(0) if q.dim() == 3 else t)
                  for t in (q, k, v))
    if {q4.dim(), k4.dim(), v4.dim()} != {4}:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}: expected 3-D or 4-D")
    # strides as (batch, head, position); the head dim has stride 1
    order = (0, 2, 1) if seq_major else (0, 1, 2)
    shape = [[t.shape[i] for i in order] for t in (q4, k4, v4)]
    (b, hq, lq), (bk, hkv, lk), (bv, hv, lv) = shape
    d = q4.shape[3]
    if (bk, bv) != (b, b) or hv != hkv or lv != lk or \
            k4.shape[3] != d or v4.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} disagree")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads over {hkv} kv heads")
    if any(t.stride(3) != 1 for t in (q4, k4, v4)) and d > 1:
        raise ValueError("the head dim must be contiguous")
    lk_valid = lk if lk_valid is None else int(lk_valid)
    if not 0 <= lk_valid <= lk:
        raise ValueError(f"lk_valid {lk_valid} outside [0, {lk}]")
    if b > _MAX_GRID_YZ:
        raise ValueError(f"batch {b} outside the kernel grid")
    strides = [[t.stride(i) for i in order] for t in (q4, k4, v4)]
    return (q4, k4, v4), order, (b, hq, hkv, lq, d), lk_valid, strides


def attention_plan(q, k, v, *, lk_valid=None,
                   seq_major: bool = False) -> AttnPlan:
    """The launch :func:`flash_attention_cuda` makes for these operands."""
    _, _, (b, hq, _, lq, d), lk_valid, _ = _operands(q, k, v, lk_valid,
                                                      seq_major)
    return plan_attention(b, hq, lq, lk_valid, d, q.dtype)


def flash_attention_cuda(q, k, v, *, scale: float, causal: bool = False,
                         window: int = 0, softcap: float = 0.0,
                         lk_valid=None, seq_major: bool = False,
                         plan: AttnPlan = None, pin=None):
    """q: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D), or all (B, L, H, D) with
    ``seq_major``; the batch axis may be left out.  f32, bf16 or f16, one
    dtype for all, the head dim contiguous, any D >= 1.  Computes in f32
    (q scaled in f32, f32 logits, softmax and accumulator) and returns
    q's shape in q's dtype, as the reference kernel does.  ``plan``
    overrides :func:`attention_plan`'s launch (for sweeps); ``pin = (bq,
    splits)`` launches that query tile and KV split (a tuned variant's)."""
    require_cuda(q, k, v)
    (q4, k4, v4), order, (b, hq, hkv, lq, d), lk_valid, strides = \
        _operands(q, k, v, lk_valid, seq_major)
    o4 = torch.empty_like(q4, memory_format=torch.contiguous_format)
    so = [o4.stride(i) for i in order]
    if o4.numel():
        if plan is None and pin is not None:
            plan = pin_attention(b, hq, lq, d, bq=pin[0], splits=pin[1])
        elif plan is None:
            plan = plan_attention(b, hq, lq, lk_valid, d, q.dtype)
        if hq * plan.slices > _MAX_GRID_YZ:
            raise ValueError(f"{hq} heads x {plan.slices} slices outside "
                             "the kernel grid")
        LIB.call("repro_flash_attention", ptr(q4), ptr(k4), ptr(v4),
                 ptr(o4), b, hq, hkv, lq, lk_valid, d,
                 *strides[0], *strides[1], *strides[2], *so, float(scale),
                 int(causal), int(window), float(softcap), _DTYPES[q.dtype],
                 plan.dp, plan.bq, plan.splits, stream_ptr(q.device))
    return o4[0] if q.dim() == 3 else o4
