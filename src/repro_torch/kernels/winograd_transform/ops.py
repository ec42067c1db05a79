"""Winograd transform wrappers: the CUDA kernels for CUDA tensors, the
plain einsums for CPU tensors.  Each launch counts as
``winograd_transform``: two per 2-D Winograd convolution (input and output
transform), whichever GEMM runs between them."""
from __future__ import annotations

import torch

from ..common import count_launch, on_cpu
from .kernel import PAIRS, input_transform_cuda, output_transform_cuda
from .ref import input_transform_ref, output_transform_ref

#: the launch counter of both transforms
COUNTER = "winograd_transform"


def _check(t, m_: int, k: int, stride: int) -> None:
    if (m_, k) not in PAIRS:
        raise ValueError(f"no Winograd transform F({m_},{k}); the kernels "
                         f"take {PAIRS}")
    if stride != 1:
        raise ValueError("Winograd convolution needs stride 1")
    if t.dtype != torch.float32:
        raise TypeError(f"the Winograd transforms take f32, got {t.dtype}")


def input_transform(x, *, m_: int, k: int, pad: int, stride: int = 1):
    """x: (N, C, H, W), any strides (an HWC input as its permuted view)
    -> V = B^T d B of every F(m_, k) tile, a contiguous (alpha^2, C,
    N * T): the batched GEMM's right operand."""
    _check(x, m_, k, stride)
    if on_cpu(x):
        return input_transform_ref(x, m_, k, pad)
    v = input_transform_cuda(x, m_, k, pad)
    count_launch(COUNTER)
    return v


def output_transform(q, b, *, m_: int, k: int, n: int, oh: int, ow: int,
                     out_layout: str = "CHW"):
    """q: the GEMM's (alpha^2, M, N * T) -> y = A^T Q A + b, cropped to
    OH x OW: a contiguous (N, M, OH, OW), or (N, OH, OW, M) for
    ``out_layout="HWC"``."""
    _check(q, m_, k, 1)
    if out_layout not in ("CHW", "HWC"):
        raise ValueError(f"bad output layout {out_layout!r}")
    if on_cpu(q):
        return output_transform_ref(q, b, m_, k, n, oh, ow, out_layout)
    y = output_transform_cuda(q, b, m_, k, n, oh, ow, out_layout)
    count_launch(COUNTER)
    return y


def winograd_conv(x, gemm, b, *, m_: int, k: int, pad: int,
                  out_layout: str = "CHW"):
    """A stride-1 F(m_, k) convolution around ``gemm``: the input transform
    of x (N, C, H, W), any strides, ``gemm(V)`` -> Q (alpha^2, M, N * T),
    then the output transform with bias ``b``: (N, M, OH, OW), or (N, OH,
    OW, M) for ``out_layout="HWC"``."""
    n, _, h, w = x.shape
    v = input_transform(x, m_=m_, k=k, pad=pad)
    return output_transform(gemm(v), b, m_=m_, k=k, n=n,
                            oh=h + 2 * pad - k + 1, ow=w + 2 * pad - k + 1,
                            out_layout=out_layout)
