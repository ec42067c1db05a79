"""Full Winograd F(m, 3) convolution with the batched-GEMM kernel core.

The input transform V = B^T d B and the output transform y = A^T Q A
stay framework einsums outside the kernel, as the reference keeps them
outside Pallas; the batched GEMM over the transform points (most of the
operations) is the kernel.  A batch of images is folded into the GEMM's
N: the input transform writes V as (P, C, images * T), so one launch
reads U once for the whole batch.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ...core.winograd_transforms import winograd_matrices
from ..common import count_launch, on_cpu
from .kernel import winograd_bgemm_cuda
from .ref import bgemm_ref


def prepare_kernel(w, m_: int = 2) -> torch.Tensor:
    """Offline kernel transform: (M, C, K, K) -> (alpha^2, M, C), f32.

    The values are the reference's; the memory is (alpha^2, C, M), M
    contiguous, seen as an (alpha^2, M, C) view, so that the kernel copies
    U 16 bytes at a time.  Packing is deployment-time, so the layout costs
    nothing per call."""
    mm, c, k, _ = w.shape
    A, G, Bt = winograd_matrices(m_, k)
    U = np.einsum("ar,mcrs,bs->abmc", G, np.asarray(w), G)
    U = U.reshape((m_ + k - 1) ** 2, mm, c).transpose(0, 2, 1)
    return torch.from_numpy(np.ascontiguousarray(U, np.float32)).transpose(
        1, 2)


def winograd_bgemm(u, v):
    """u: (P, M, C) x v: (P, C, N) -> (P, M, N), the reference's form; or
    v: (N, P, C, T) -> (N, P, M, T), one product per image, folded into
    the first form (a view at N = 1) and unfolded after.  The kernel on
    CUDA tensors (one launch for every point and image), the plain
    version on CPU tensors."""
    if on_cpu(v):
        return bgemm_ref(u, v)
    if v.dim() == 4:
        n, p, c, t = v.shape
        q = winograd_bgemm_cuda(u, v.permute(1, 2, 0, 3).reshape(p, c, n * t))
        q = q.reshape(p, -1, n, t).permute(2, 0, 1, 3)
    else:
        q = winograd_bgemm_cuda(u, v)
    count_launch("winograd_gemm")
    return q


@functools.lru_cache(maxsize=64)
def winograd_tensors(m_: int, k: int, device: torch.device):
    """The F(m_, k) transform matrices (A, G, Bt) as f32 tensors on
    ``device``, built once per device."""
    return tuple(torch.as_tensor(np.asarray(t, np.float32), device=device)
                 for t in winograd_matrices(m_, k))


def conv_winograd(x, u, b, *, m_: int = 2, k: int = 3, stride: int = 1,
                  pad: int = 1, in_layout: str = "CHW",
                  out_layout: str = "CHW"):
    """x: (C, H, W) or (H, W, C), optionally batched; u: prepared kernels
    (alpha^2, M, C); b: (M,).  Returns (M, OH, OW) or, with
    ``out_layout="HWC"``, (OH, OW, M): the output transform's einsum
    emits HWC itself.  stride must be 1 (Winograd restriction).
    """
    if stride != 1:
        raise ValueError("Winograd convolution needs stride 1")
    if in_layout not in ("CHW", "HWC") or out_layout not in ("CHW", "HWC"):
        raise ValueError(f"bad layouts {in_layout!r}, {out_layout!r}")
    single = x.dim() == 3
    xb = x.unsqueeze(0) if single else x
    if in_layout == "HWC":
        xb = xb.permute(0, 3, 1, 2)
    n, c, h, wd = xb.shape
    _, m, _ = u.shape
    a = m_ + k - 1
    A, _, Bt = winograd_tensors(m_, k, x.device)
    oh, ow = h + 2 * pad - k + 1, wd + 2 * pad - k + 1
    nth, ntw = -(-oh // m_), -(-ow // m_)
    ph = (nth - 1) * m_ + a - (h + 2 * pad)
    pw = (ntw - 1) * m_ + a - (wd + 2 * pad)
    xp = F.pad(xb, (pad, pad + max(pw, 0), pad, pad + max(ph, 0)))
    d = F.unfold(xp, (a, a), stride=m_).reshape(n, c, a, a, nth * ntw)
    # the images side by side in N: V (P, C, n * T), Q (P, M, n * T)
    V = torch.einsum("ai,ncijt,bj->abcnt", Bt, d, Bt).reshape(
        a * a, c, n * nth * ntw)
    Q = winograd_bgemm(u, V).reshape(a, a, m, n, nth, ntw)
    if out_layout == "HWC":
        Y = torch.einsum("ap,abmntu,bq->ntpuqm", A, Q, A)
        y = Y.reshape(n, nth * m_, ntw * m_, m)[:, :oh, :ow, :] + b
    else:
        Y = torch.einsum("ap,abmntu,bq->nmtpuq", A, Q, A)
        y = Y.reshape(n, m, nth * m_, ntw * m_)[:, :, :oh, :ow] + \
            b[:, None, None]
    return y[0] if single else y
