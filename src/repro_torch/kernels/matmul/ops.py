"""GEMM wrapper: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors."""
from __future__ import annotations

from ..common import count_launch, on_cpu
from .kernel import matmul_cuda
from .ref import matmul_ref


def matmul(x, y, bias=None, *, fuse_relu: bool = False,
           lhs_layout: str = "mk", out_layout: str = "mn"):
    """General ``x @ y (+ bias) (ReLU)``, any shapes.

    ``lhs_layout="km"`` consumes a transposed (K, M) LHS and
    ``out_layout="nm"`` emits the transposed (N, M) product, both inside
    the kernel (strides; no separate transpose pass).  A leading batch
    axis on either operand runs as one launch.
    """
    if lhs_layout not in ("mk", "km") or out_layout not in ("mn", "nm"):
        raise ValueError(f"bad layouts {lhs_layout!r}, {out_layout!r}")
    kw = dict(fuse_relu=fuse_relu, lhs_layout=lhs_layout,
              out_layout=out_layout)
    if on_cpu(x):
        return matmul_ref(x, y, bias, **kw)
    out = matmul_cuda(x, y, bias, **kw)
    count_launch("matmul")
    return out
