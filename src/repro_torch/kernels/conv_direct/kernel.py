"""Binding of the direct-convolution CUDA kernel (``csrc/conv_direct.cu``).

Replaces the reference's ``conv_direct_pallas``.  The Pallas kernel keeps
the whole padded input strip in VMEM; a Hopper block has 227 KB of shared
memory, less than AlexNet's conv1 strip, so the CUDA kernel is an
implicit GEMM on the GEMM's mainloop: it tiles the output (pixels by
channels), stages only each tile's input window, and reads the padding
as zeros instead of padding the input in memory.  The launch (tile,
cluster split-K, copy widths) comes from the GEMM's planner.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import KernelLib, ptr, require_cuda, stream_ptr
from ..matmul.plan import GemmPlan, plan_gemm, vector_width

_I, _P = ctypes.c_int, ctypes.c_void_p
_ENTRY = {torch.float32: "repro_conv_direct",
          torch.bfloat16: "repro_conv_direct_bf16",
          torch.float16: "repro_conv_direct_f16"}
LIB = KernelLib("conv_direct.cu", {e: (_P, _P, _P, _P) + (_I,) * 16 + (_P,)
                                   for e in _ENTRY.values()})
_MAX_GRID_Z = 65535
#: the tiles the kernel is built for: 128 x 128 and 64 x 64 (the narrow
#: ones spend too long gathering their 128-row operand; the planner's
#: sweep put conv2 at 87 us on 128 x 32 against 50 us on 128 x 128)
CONV_TILES = (0, 1)


def conv_direct_cuda(x, w, b, *, stride: int = 1, pad: int = 0,
                     in_layout: str = "HWC", out_layout: str = "HWC",
                     plan: GemmPlan = None):
    """x: (N, H, W, C), or (N, C, H, W) with ``in_layout="CHW"``;
    w: (K, K, C, M); b: (M,); contiguous, f32, bf16 or f16 (one dtype
    for all).  Accumulates in f32 and returns (N, OH, OW, M), or
    (N, M, OH, OW) with ``out_layout="CHW"``, in x's dtype.  ``plan``
    overrides :func:`conv_plan`'s launch (for sweeps)."""
    require_cuda(x, w, b)
    if x.dtype not in _ENTRY:
        raise TypeError(f"direct conv takes f32, bf16 or f16; x is "
                        f"{x.dtype}")
    for t, what in ((x, "x"), (w, "w"), (b, "b")):
        if t.dtype != x.dtype:
            raise TypeError(f"direct conv: {what} is {t.dtype}, x is "
                            f"{x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"direct conv: {what} must be contiguous")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"shapes {tuple(x.shape)}, {tuple(w.shape)}: "
                         "expected a batched image and (K, K, C, M)")
    chw_in = in_layout == "CHW"
    if chw_in:
        n, c, h, wd = x.shape
    else:
        n, h, wd, c = x.shape
    k, k2, c2, m = w.shape
    if k != k2 or c2 != c or b.shape != (m,):
        raise ValueError(f"x {tuple(x.shape)} ({in_layout}), "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)} disagree")
    if stride < 1 or pad < 0:
        raise ValueError(f"stride {stride}, pad {pad}")
    oh = (h + 2 * pad - k) // stride + 1
    ow = (wd + 2 * pad - k) // stride + 1
    if oh < 1 or ow < 1 or not 0 < n <= _MAX_GRID_Z:
        raise ValueError(f"output {oh}x{ow} for {n} images")
    chw_out = out_layout == "CHW"
    y = torch.empty((n, m, oh, ow) if chw_out else (n, oh, ow, m),
                    dtype=x.dtype, device=x.device)
    if plan is None:
        plan = conv_plan(n, c, m, k, oh, ow, chw_out,
                         vector_width(w.view(-1, m), 1))
    LIB.call(_ENTRY[x.dtype], ptr(x), ptr(w), ptr(b), ptr(y), n, c, h,
             wd, m, k, stride, pad, oh, ow, int(chw_in), int(chw_out),
             plan.tile, plan.splits, plan.kslice,
             plan.vec_a if chw_out else plan.vec_b, stream_ptr(x.device))
    return y


def conv_plan(n: int, c: int, m: int, k: int, oh: int, ow: int,
              chw_out: bool, vec_w: int = 1) -> GemmPlan:
    """The launch of the implicit GEMM: (OH*OW x K*K*C) @ (K*K*C x M) per
    image, or its transpose (M x K*K*C) @ (K*K*C x OH*OW) for a CHW
    output; ``vec_w`` is the weights' copy width (the gathered input's
    is 1)."""
    p, r = oh * ow, k * k * c
    if chw_out:
        return plan_gemm(m, p, r, n, vec_a=vec_w, tiles=CONV_TILES)
    return plan_gemm(p, m, r, n, vec_b=vec_w, tiles=CONV_TILES)
