"""Plain PyTorch versions of the 2-D Winograd transforms: the einsums the
reference computes around its batched GEMM (``repro.core.primitives``'
``_wino2d`` and ``repro.kernels.winograd_gemm.ops.conv_winograd``), in the
folded form the GEMM takes: V (alpha^2, C, N * T) and Q (alpha^2, M, N * T),
images outer, each image's T tiles row-major."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ...core.winograd_transforms import winograd_matrices


@functools.lru_cache(maxsize=64)
def winograd_tensors(m_: int, k: int, device: torch.device):
    """The F(m_, k) transform matrices (A, G, Bt) as f32 tensors on
    ``device``, built once per device."""
    return tuple(torch.as_tensor(np.asarray(t, np.float32), device=device)
                 for t in winograd_matrices(m_, k))


def tiles(h: int, w: int, m_: int, k: int, pad: int):
    """(OH, OW, tiles along H, tiles along W) of a stride-1 F(m_, k)
    convolution of an H x W plane padded by ``pad``."""
    oh, ow = h + 2 * pad - k + 1, w + 2 * pad - k + 1
    return oh, ow, -(-oh // m_), -(-ow // m_)


def input_transform_ref(x, m_: int, k: int, pad: int):
    """x: (N, C, H, W), any strides -> V = B^T d B of every tile d, a
    contiguous (alpha^2, C, N * T)."""
    n, c, h, w = x.shape
    a = m_ + k - 1
    _, _, Bt = winograd_tensors(m_, k, x.device)
    _, _, nth, ntw = tiles(h, w, m_, k, pad)
    # pad so that tiles of alpha with stride m_ cover all outputs
    ph = (nth - 1) * m_ + a - (h + 2 * pad)
    pw = (ntw - 1) * m_ + a - (w + 2 * pad)
    xp = F.pad(x, (pad, pad + max(pw, 0), pad, pad + max(ph, 0)))
    d = F.unfold(xp, (a, a), stride=m_).reshape(n, c, a, a, nth * ntw)
    return torch.einsum("ai,ncijt,bj->abcnt", Bt, d, Bt).reshape(
        a * a, c, n * nth * ntw)


def output_transform_ref(q, b, m_: int, k: int, n: int, oh: int, ow: int,
                         out_layout: str = "CHW"):
    """q: (alpha^2, M, N * T) -> y = A^T Q A + b of every tile, cropped to
    OH x OW: a contiguous (N, M, OH, OW), or (N, OH, OW, M) for
    ``out_layout="HWC"``."""
    a = m_ + k - 1
    mo = q.shape[1]
    A, _, _ = winograd_tensors(m_, k, q.device)
    nth, ntw = -(-oh // m_), -(-ow // m_)
    Q = q.reshape(a, a, mo, n, nth, ntw)
    if out_layout == "HWC":
        Y = torch.einsum("ap,abmntu,bq->ntpuqm", A, Q, A)
        return Y.reshape(n, nth * m_, ntw * m_, mo)[:, :oh, :ow, :] + b
    Y = torch.einsum("ap,abmntu,bq->nmtpuq", A, Q, A)
    return Y.reshape(n, mo, nth * m_, ntw * m_)[:, :, :oh, :ow] + \
        b[:, None, None]
