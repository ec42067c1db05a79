"""Binding of the Winograd batched-GEMM CUDA kernel
(``csrc/winograd_gemm.cu``).

Replaces the reference's ``winograd_bgemm_pallas``: Q[p] = U[p] @ V[p]
for each of the alpha^2 transform points p, f32 accumulation.  The
images of a batch run on the kernel's grid beside the points, sharing
U; the reference's padding of C and N to block multiples becomes
in-kernel masking.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import KernelLib, ptr, require_cuda, stream_ptr

_I, _P = ctypes.c_int, ctypes.c_void_p
LIB = KernelLib("winograd_gemm.cu",
                {"repro_wino_bgemm": (_P, _P, _P, _I, _I, _I, _I, _I, _P)})
_MAX_GRID_Z = 65535


def winograd_bgemm_cuda(u, v):
    """u: (P, M, C), v: (N, P, C, T) -> (N, P, M, T); contiguous f32."""
    require_cuda(u, v)
    if u.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"Winograd GEMM takes f32, got {u.dtype}, {v.dtype}")
    if not (u.is_contiguous() and v.is_contiguous()):
        raise ValueError("Winograd GEMM operands must be contiguous")
    if u.dim() != 3 or v.dim() != 4:
        raise ValueError(f"shapes {tuple(u.shape)}, {tuple(v.shape)}: "
                         "expected (P, M, C) and (N, P, C, T)")
    p, m, c = u.shape
    n, p2, c2, t = v.shape
    if (p2, c2) != (p, c):
        raise ValueError(f"U {tuple(u.shape)} and V {tuple(v.shape)} "
                         "disagree on points or channels")
    if not 0 < n * p <= _MAX_GRID_Z:
        raise ValueError(f"{n} images x {p} points outside the grid")
    q = torch.empty((n, p, m, t), dtype=u.dtype, device=u.device)
    if m and t:
        LIB.call("repro_wino_bgemm", ptr(u), ptr(v), ptr(q), p, m, c, t, n,
                 stream_ptr(u.device))
    return q
