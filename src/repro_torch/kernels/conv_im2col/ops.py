"""im2col convolution with the GEMM kernel as its core.

Patch extraction (the Toeplitz build) is bandwidth-bound gather work left
to the framework (``F.unfold``, rows in (C, kh, kw) order like
``lax.conv_general_dilated_patches``); the O(M * CKK * OHOW) product is
the hot spot and runs on the GEMM kernel (``csrc/matmul.cu``), which
replaces the reference's ``im2col_gemm_pallas``.  The bias is added after
the GEMM, as in the reference.
"""
from __future__ import annotations

import torch.nn.functional as F

from ..common import count_launch, on_cpu
from ..matmul.kernel import matmul_cuda
from ..matmul.ref import matmul_ref


def im2col_gemm(wmat, pmat, *, out_layout: str = "mn", pin=None):
    """(M, CKK) @ (N, CKK, OHOW): the GEMM kernel on CUDA tensors (one
    launch for the batch; ``pin = (tile, splits)`` in place of the
    planner's launch), the plain version on CPU tensors."""
    if on_cpu(pmat):
        return matmul_ref(wmat, pmat, out_layout=out_layout)
    out = matmul_cuda(wmat, pmat, out_layout=out_layout, pin=pin)
    count_launch("conv_im2col")
    return out


def conv_im2col(x, w, b, *, stride: int = 1, pad: int = 0,
                in_layout: str = "CHW", out_layout: str = "CHW", pin=None):
    """im2col conv, layout-parameterized (transform fusion entry point).

    x: (C, H, W), or (H, W, C) with ``in_layout="HWC"``, with an optional
    leading batch axis.  ``out_layout="HWC"`` returns (OH, OW, M) by
    running the GEMM with the kernel's transposed-output store instead
    of transposing the product.  w: (M, C, K, K); b: (M,).  ``pin``:
    the GEMM's (tile, splits), a tuned variant's.
    """
    if in_layout not in ("CHW", "HWC") or out_layout not in ("CHW", "HWC"):
        raise ValueError(f"bad layouts {in_layout!r}, {out_layout!r}")
    single = x.dim() == 3
    xb = x.unsqueeze(0) if single else x
    if in_layout == "HWC":
        xb = xb.permute(0, 3, 1, 2)
    n, c, h, wd = xb.shape
    m, _, k, _ = w.shape
    oh = (h + 2 * pad - k) // stride + 1
    ow = (wd + 2 * pad - k) // stride + 1
    pmat = F.unfold(xb, (k, k), padding=pad, stride=stride)  # (N, CKK, L)
    wmat = w.reshape(m, c * k * k)
    if out_layout == "HWC":
        y = im2col_gemm(wmat, pmat, out_layout="nm", pin=pin) + b  # (N, L, M)
        y = y.reshape(n, oh, ow, m)
    else:
        y = im2col_gemm(wmat, pmat, pin=pin) + b[:, None]  # (N, M, L)
        y = y.reshape(n, m, oh, ow)
    return y[0] if single else y
