"""Plain PyTorch version of the GEMM kernel (counterpart of the
reference's jnp oracle ``repro.kernels.matmul.ref``)."""
from __future__ import annotations

import torch


def matmul_ref(x, y, bias=None, fuse_relu: bool = False,
               lhs_layout: str = "mk", out_layout: str = "mn"):
    """``x @ y (+ bias) (ReLU)`` accumulated in f32, returned in
    ``x.dtype``.  ``lhs_layout="km"``: x is stored (..., K, M);
    ``out_layout="nm"``: the product is returned as (..., N, M).
    Leading batch axes broadcast."""
    a = x.transpose(-1, -2) if lhs_layout == "km" else x
    out = torch.matmul(a.float(), y.float())
    if bias is not None:
        out = out + bias.float()
    if fuse_relu:
        out = torch.clamp_min(out, 0.0)
    if out_layout == "nm":
        out = out.transpose(-1, -2)
    return out.to(x.dtype).contiguous()
