"""Binding of the Winograd batched-GEMM CUDA kernel
(``csrc/winograd_gemm.cu``).

Replaces the reference's ``winograd_bgemm_pallas``: Q[p] = U[p] @ V[p]
for each of the alpha^2 transform points p, (P, M, C) x (P, C, N) ->
(P, M, N), in f32, bf16 or f16 with f32 accumulation and Q in the
operands' dtype (as the reference kernel writes ``o_ref.dtype``).  The
kernel runs on the GEMM's Hopper mainloop, launched as
:func:`~..matmul.plan.plan_gemm` plans it, with the points on the grid;
a batch of images is folded into N by the caller
(``ops.conv_winograd``).  The reference's padding of C and N to block
multiples becomes zero-filled copies.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import KernelLib, ptr, require_cuda, stream_ptr
from ..matmul.plan import GemmPlan, pin_gemm, plan_gemm, vector_width

_I, _L, _P = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
_ARGS = (_P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _I, _I, _I, _I,
         _I, _P)
_ENTRY = {torch.float32: "repro_wino_bgemm",
          torch.bfloat16: "repro_wino_bgemm_bf16",
          torch.float16: "repro_wino_bgemm_f16"}
LIB = KernelLib("winograd_gemm.cu", {e: _ARGS for e in _ENTRY.values()})
_MAX_GRID_Z = 65535


def _check(u, v):
    if u.dtype not in _ENTRY or v.dtype != u.dtype:
        raise TypeError(f"Winograd GEMM takes f32, bf16 or f16, one dtype "
                        f"for both; got {u.dtype}, {v.dtype}")
    if u.dim() != 3 or v.dim() != 3:
        raise ValueError(f"shapes {tuple(u.shape)}, {tuple(v.shape)}: "
                         "expected (P, M, C) and (P, C, N)")
    if u.shape[0] != v.shape[0] or u.shape[2] != v.shape[1]:
        raise ValueError(f"U {tuple(u.shape)} and V {tuple(v.shape)} "
                         "disagree on points or channels")
    if not 0 < u.shape[0] <= _MAX_GRID_Z:
        raise ValueError(f"{u.shape[0]} points outside the grid")


def bgemm_plan(u, v, pin=None) -> GemmPlan:
    """The launch :func:`winograd_bgemm_cuda` makes for these operands:
    U's copies are 16 bytes where M is its contiguous axis, V's where N
    is.  ``pin = (tile, splits)`` launches that tile and split count
    instead of the planner's (a tuned variant's)."""
    _check(u, v)
    p, m, c = u.shape
    args = (m, v.shape[2], c, p, u.dtype, vector_width(u, 1),
            vector_width(v, 2))
    if pin is None:
        return plan_gemm(*args)
    return pin_gemm(*args, tile=pin[0], splits=pin[1])


def winograd_bgemm_cuda(u, v, plan: GemmPlan = None, pin=None):
    """u: (P, M, C), v: (P, C, N), f32, bf16 or f16 (one dtype), any
    strides -> a contiguous (P, M, N) in their dtype, accumulated in f32.
    ``plan`` overrides the planner's launch (for sweeps); ``pin = (tile,
    splits)`` launches that tile and split count (a tuned variant's)."""
    require_cuda(u, v)
    plan = bgemm_plan(u, v, pin) if plan is None else plan
    p, m, c = u.shape
    n = v.shape[2]
    q = torch.empty((p, m, n), dtype=u.dtype, device=u.device)
    if m and n:
        LIB.call(_ENTRY[u.dtype], ptr(u), ptr(v), ptr(q), p, m, n, c,
                 *u.stride()[1:], u.stride(0), *v.stride()[1:], v.stride(0),
                 plan.tile, plan.splits, plan.kslice, plan.vec_a, plan.vec_b,
                 stream_ptr(u.device))
    return q
