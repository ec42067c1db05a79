"""Plain PyTorch version of the direct convolution kernel (counterpart of
the reference's jnp oracle ``repro.kernels.conv_direct.ref``).

It does the Pallas kernel's arithmetic: one (OH*OW, C) @ (C, M) product
per K x K tap on the strided window of the padded input, accumulated in
f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv_direct_ref(x, w, b, *, stride: int = 1, pad: int = 0,
                    in_layout: str = "HWC", out_layout: str = "HWC"):
    """x: (H, W, C) or (C, H, W) per ``in_layout``, optionally batched;
    w: (K, K, C, M); b: (M,) -> (OH, OW, M) or (M, OH, OW)."""
    single = x.dim() == 3
    xb = x.unsqueeze(0) if single else x
    if in_layout == "CHW":
        xb = xb.permute(0, 2, 3, 1)
    xp = F.pad(xb, (0, 0, pad, pad, pad, pad)).float()
    n, hp, wp, c = xp.shape
    k, _, _, m = w.shape
    oh = (hp - k) // stride + 1
    ow = (wp - k) // stride + 1
    acc = torch.zeros((n, oh * ow, m), dtype=torch.float32, device=x.device)
    for i in range(k):
        for j in range(k):
            win = xp[:, i:i + (oh - 1) * stride + 1:stride,
                     j:j + (ow - 1) * stride + 1:stride]
            acc = acc + win.reshape(n, oh * ow, c) @ w[i, j].float()
    y = (acc + b.float()).reshape(n, oh, ow, m).to(x.dtype)
    if out_layout == "CHW":
        y = y.permute(0, 3, 1, 2)
    y = y.contiguous()
    return y[0] if single else y
