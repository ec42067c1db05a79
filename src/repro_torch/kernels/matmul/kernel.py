"""Binding of the tiled GEMM CUDA kernel (``csrc/matmul.cu``).

Replaces the reference's ``matmul_pallas``: a (M, N, K) product with an
f32 accumulator and an optional fused bias + ReLU epilogue.  The Pallas
kernel's layout options (a "km" LHS, an "nm" output) and its padded
block grid become strides and in-kernel masks: any strided operand is
read where it lies, and a leading batch axis runs on the grid.  The tile,
the cluster split-K and the copy widths come from :mod:`.plan`.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import KernelLib, ptr, require_cuda, stream_ptr
from .plan import GemmPlan, pin_gemm, plan_gemm, vector_width

_I, _L, _P = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _L, _L, _I, _L, _L,
         _L, _I, _I, _I, _I, _I, _I, _P)
LIB = KernelLib("matmul.cu", {"repro_matmul_f32": _ARGS,
                              "repro_matmul_bf16": _ARGS,
                              "repro_matmul_f16": _ARGS})
_ENTRY = {torch.float32: "repro_matmul_f32",
          torch.bfloat16: "repro_matmul_bf16",
          torch.float16: "repro_matmul_f16"}
_MAX_GRID_Z = 65535


def _as_batch(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.dim() == 2:
        return t.unsqueeze(0)
    if t.dim() != 3:
        raise ValueError(f"{what} must be 2-D or 3-D, got {tuple(t.shape)}")
    return t


def matmul_cuda(x, y, bias=None, *, fuse_relu: bool = False,
                lhs_layout: str = "mk", out_layout: str = "mn",
                plan: GemmPlan = None, pin=None):
    """Launch the GEMM kernel; same contract as ``ops.matmul``.

    x (M, K) — or (K, M) with ``lhs_layout="km"`` — and y (K, N), each
    with an optional leading batch axis (size 1 or B broadcasts); bias
    (N,).  f32, bf16 or f16, one dtype for all; any strides.  Accumulates
    in f32 and returns (B?, M, N), or (B?, N, M) with
    ``out_layout="nm"``, in x's dtype, as the reference kernel does.
    ``plan`` overrides :func:`matmul_plan`'s launch (for sweeps); ``pin
    = (tile, splits)`` launches that tile and split count instead of the
    planner's (a tuned variant's).
    """
    require_cuda(x, y, bias)
    if x.dtype not in _ENTRY:
        raise TypeError(f"GEMM kernel takes f32, bf16 or f16, got "
                        f"{x.dtype}")
    for t, what in ((y, "y"), (bias, "bias")):
        if t is not None and t.dtype != x.dtype:
            raise TypeError(f"{what} is {t.dtype}, x is {x.dtype}")
    a3, b3 = _operands(x, y, lhs_layout)
    nb, m, k = a3.shape
    n = b3.shape[2]
    if bias is not None and (bias.shape != (n,) or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous ({n},) vector")
    trans_out = out_layout == "nm"
    out = torch.empty((nb, n, m) if trans_out else (nb, m, n),
                      dtype=x.dtype, device=x.device)
    c3 = out.transpose(1, 2) if trans_out else out
    if m and n:
        launch(_plan(a3, b3, pin) if plan is None else plan, a3, b3, bias,
               c3, fuse_relu)
    return out if x.dim() == 3 or y.dim() == 3 else out[0]


def _operands(x, y, lhs_layout):
    """x and y as (B, M, K) and (B, K, N) views, the batch broadcast."""
    a = x.transpose(-1, -2) if lhs_layout == "km" else x
    a3, b3 = _as_batch(a, "x"), _as_batch(y, "y")
    nb = max(a3.shape[0], b3.shape[0])
    if {a3.shape[0], b3.shape[0]} - {1, nb}:
        raise ValueError(f"batch sizes {a3.shape[0]} and {b3.shape[0]} "
                         "do not broadcast")
    if not 0 < nb <= _MAX_GRID_Z:
        raise ValueError(f"batch {nb} outside the kernel grid")
    a3, b3 = a3.expand(nb, -1, -1), b3.expand(nb, -1, -1)
    if a3.shape[2] != b3.shape[1]:
        raise ValueError(f"inner dims differ: {a3.shape[2]} vs "
                         f"{b3.shape[1]}")
    return a3, b3


def _plan(a3, b3, pin=None) -> GemmPlan:
    nb, m, k = a3.shape
    args = (m, b3.shape[2], k, nb, a3.dtype, vector_width(a3, 1),
            vector_width(b3, 2))
    if pin is None:
        return plan_gemm(*args)
    tile, splits = pin
    return pin_gemm(*args, tile=tile, splits=splits)


def matmul_plan(x, y, *, lhs_layout: str = "mk") -> GemmPlan:
    """The launch :func:`matmul_cuda` makes for these operands."""
    return _plan(*_operands(x, y, lhs_layout))


def launch(plan: GemmPlan, a3, b3, bias, c3, fuse_relu: bool) -> None:
    """One launch of ``c3 = a3 @ b3 (+ bias) (ReLU)`` on ``plan``; the
    three operands are (B, M, K), (B, K, N) and (B, M, N) views."""
    nb, m, k = a3.shape
    n = b3.shape[2]
    LIB.call(_ENTRY[a3.dtype], ptr(a3), ptr(b3), ptr(bias), ptr(c3),
             m, n, k, *a3.stride()[1:], *b3.stride()[1:], *c3.stride()[1:],
             nb, a3.stride(0), b3.stride(0), c3.stride(0), int(fuse_relu),
             plan.tile, plan.splits, plan.kslice, plan.vec_a, plan.vec_b,
             stream_ptr(a3.device))
