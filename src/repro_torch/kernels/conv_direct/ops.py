"""Direct convolution wrapper: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors."""
from __future__ import annotations

from ..common import count_launch, on_cpu
from .kernel import conv_direct_cuda
from .ref import conv_direct_ref


def conv_direct(x, w, b, *, stride: int = 1, pad: int = 0,
                in_layout: str = "HWC", out_layout: str = "HWC"):
    """Direct conv, layout-parameterized (transform fusion entry point).

    ``in_layout="HWC"``: x is (H, W, C); ``"CHW"``: x is (C, H, W) and
    the kernel reads it where it lies.  ``out_layout`` selects
    (OH, OW, M) vs (M, OH, OW).  An optional leading batch axis runs as
    one launch.  w: (K, K, C, M); b: (M,).
    """
    if in_layout not in ("CHW", "HWC") or out_layout not in ("CHW", "HWC"):
        raise ValueError(f"bad layouts {in_layout!r}, {out_layout!r}")
    kw = dict(stride=stride, pad=pad, in_layout=in_layout,
              out_layout=out_layout)
    if on_cpu(x):
        return conv_direct_ref(x, w, b, **kw)
    single = x.dim() == 3
    y = conv_direct_cuda(x.unsqueeze(0) if single else x, w, b, **kw)
    count_launch("conv_direct")
    return y[0] if single else y
