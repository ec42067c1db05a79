"""Convolutional scenarios — the paper's 6-tuple {C, H, W, delta, K, M}.

A *scenario* captures everything a convolution primitive's runtime
depends on (Section 3 of the paper): input channels C, spatial size
H x W, stride delta, kernel radix K, output channels M.  We add the
padding (the paper's benchmark networks all use explicit pads), the
dtype, and — beyond the paper — the minibatch ``n``.  The paper fixes
minibatch at 1 for its latency-sensitive deployment context, but the
optimal primitive *flips* with batch size (GEMM-based methods amortize
per-invocation packing/planning over N; direct methods do not), so a
batched server must price and select per (scenario, N).  ``n`` defaults
to 1 and a scenario's :meth:`key` is unchanged for ``n == 1``, so
single-image cost caches, calibration profiles and persisted plans stay
valid.  All costs are for the *whole batched invocation*, not per
image.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np

__all__ = ["Scenario", "ref_conv"]


@dataclass(frozen=True, order=True)
class Scenario:
    c: int          # input feature maps
    h: int          # input height
    w: int          # input width
    stride: int     # convolution stride (delta)
    k: int          # kernel radix (K x K)
    m: int          # output feature maps
    pad: int = -1   # -1 => "same"-style default k // 2
    dtype: str = "float32"
    n: int = 1      # minibatch (1 = the paper's setting)

    def __post_init__(self):
        if self.pad < 0:
            object.__setattr__(self, "pad", self.k // 2)
        if self.n < 1:
            raise ValueError(f"minibatch must be >= 1, got {self.n}")

    @property
    def out_h(self) -> int:
        return (self.h + 2 * self.pad - self.k) // self.stride + 1

    @property
    def out_w(self) -> int:
        return (self.w + 2 * self.pad - self.k) // self.stride + 1

    @property
    def in_shape_chw(self) -> Tuple[int, int, int]:
        return (self.c, self.h, self.w)

    @property
    def out_shape_chw(self) -> Tuple[int, int, int]:
        return (self.m, self.out_h, self.out_w)

    @property
    def weight_shape(self) -> Tuple[int, int, int, int]:
        return (self.m, self.c, self.k, self.k)

    @property
    def in_shape_nchw(self) -> Tuple[int, int, int, int]:
        return (self.n, self.c, self.h, self.w)

    @property
    def out_shape_nchw(self) -> Tuple[int, int, int, int]:
        return (self.n, self.m, self.out_h, self.out_w)

    @property
    def macs(self) -> int:
        """Multiply-accumulates of the direct algorithm (whole batch)."""
        return (self.n * self.m * self.c * self.k * self.k
                * self.out_h * self.out_w)

    @property
    def flops(self) -> int:
        return 2 * self.macs

    def with_(self, **kw) -> "Scenario":
        return replace(self, **kw)

    def key(self) -> str:
        # n is appended only for n > 1: single-image keys predate the
        # batch axis, and cost caches / calibration profiles keyed on
        # them must stay valid.
        base = (f"c{self.c}h{self.h}w{self.w}s{self.stride}"
                f"k{self.k}m{self.m}p{self.pad}{self.dtype}")
        return base if self.n == 1 else f"{base}n{self.n}"


def ref_conv(x: np.ndarray, w: np.ndarray, b: np.ndarray,
             stride: int, pad: int) -> np.ndarray:
    """Reference multi-channel multi-kernel DNN convolution (correlation).

    Pure numpy oracle.  x: (C, H, W); w: (M, C, K, K); b: (M,).
    Returns (M, H', W').  All primitives in the library are validated
    against this function.
    """
    c, h, wdt = x.shape
    m, c2, k, k2 = w.shape
    assert c == c2 and k == k2
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad)))
    win = np.lib.stride_tricks.sliding_window_view(xp, (k, k), axis=(1, 2))
    win = win[:, ::stride, ::stride]  # (C, H', W', K, K)
    out = np.einsum("chwij,mcij->mhw", win, w, optimize=True)
    return out + b[:, None, None]
