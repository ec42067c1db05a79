"""Plain PyTorch version of the im2col convolution (counterpart of the
reference's jnp oracle ``repro.kernels.conv_im2col.ref``)."""
from __future__ import annotations

import torch.nn.functional as F

from ..matmul.ref import matmul_ref


def conv_im2col_ref(x, w, b, *, stride: int = 1, pad: int = 0):
    """x: (C, H, W) or (N, C, H, W); w: (M, C, K, K); b: (M,) ->
    (M, OH, OW) or (N, M, OH, OW): the patch matrix times the weight
    matrix, accumulated in f32."""
    single = x.dim() == 3
    xb = x.unsqueeze(0) if single else x
    n, c, h, wd = xb.shape
    m, _, k, _ = w.shape
    oh = (h + 2 * pad - k) // stride + 1
    ow = (wd + 2 * pad - k) // stride + 1
    pmat = F.unfold(xb, (k, k), padding=pad, stride=stride)
    y = matmul_ref(w.reshape(m, -1), pmat) + b[:, None]
    y = y.reshape(n, m, oh, ow)
    return y[0] if single else y
