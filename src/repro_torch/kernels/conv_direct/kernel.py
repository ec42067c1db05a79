"""Binding of the direct-convolution CUDA kernel (``csrc/conv_direct.cu``).

Replaces the reference's ``conv_direct_pallas``.  The Pallas kernel keeps
the whole padded input strip in VMEM; a Hopper block has 227 KB of shared
memory, less than AlexNet's conv1 strip, so the CUDA kernel tiles the
output (pixels by channels) and stages only each tile's input window,
reading the padding as zeros instead of padding the input in memory.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import KernelLib, ptr, require_cuda, stream_ptr

_I, _P = ctypes.c_int, ctypes.c_void_p
LIB = KernelLib("conv_direct.cu",
                {"repro_conv_direct": (_P, _P, _P, _P) + (_I,) * 12 + (_P,)})
_MAX_GRID_Z = 65535


def conv_direct_cuda(x, w, b, *, stride: int = 1, pad: int = 0,
                     in_layout: str = "HWC", out_layout: str = "HWC"):
    """x: (N, H, W, C), or (N, C, H, W) with ``in_layout="CHW"``;
    w: (K, K, C, M); b: (M,); contiguous f32.  Returns (N, OH, OW, M), or
    (N, M, OH, OW) with ``out_layout="CHW"``."""
    require_cuda(x, w, b)
    for t, what in ((x, "x"), (w, "w"), (b, "b")):
        if t.dtype != torch.float32:
            raise TypeError(f"direct conv takes f32; {what} is {t.dtype}")
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
    LIB.call("repro_conv_direct", ptr(x), ptr(w), ptr(b), ptr(y), n, c, h,
             wd, m, k, stride, pad, oh, ow, int(chw_in), int(chw_out),
             stream_ptr(x.device))
    return y
