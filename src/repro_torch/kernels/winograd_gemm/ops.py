"""Full Winograd F(m, 3) convolution with the batched-GEMM kernel core.

The input transform V = B^T d B and the output transform y = A^T Q A + b
are the hand-written kernels of :mod:`..winograd_transform` (its plain
einsums on the CPU), which take the place of the fusion XLA gives the
reference's einsums on the TPU; the batched GEMM over the transform points
(most of the operations) is this package's kernel.  A batch of images is
folded into the GEMM's N: the input transform writes V as (P, C,
images * T), so one launch reads U once for the whole batch.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.winograd_transforms import winograd_matrices
from ..common import count_launch, on_cpu
from ..winograd_transform import ops as wt
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


def winograd_bgemm(u, v, pin=None):
    """u: (P, M, C) x v: (P, C, N) -> (P, M, N), the reference's form; or
    v: (N, P, C, T) -> (N, P, M, T), one product per image, folded into
    the first form (a view at N = 1) and unfolded after.  The kernel on
    CUDA tensors (one launch for every point and image; ``pin = (tile,
    splits)`` in place of the planner's launch), the plain version on CPU
    tensors."""
    if on_cpu(v):
        return bgemm_ref(u, v)

    def launch(vf):
        if pin is None:
            return winograd_bgemm_cuda(u, vf)
        return winograd_bgemm_cuda(u, vf, pin=pin)

    if v.dim() == 4:
        n, p, c, t = v.shape
        q = launch(v.permute(1, 2, 0, 3).reshape(p, c, n * t))
        q = q.reshape(p, -1, n, t).permute(2, 0, 1, 3)
    else:
        q = launch(v)
    count_launch("winograd_gemm")
    return q


def conv_winograd(x, u, b, *, m_: int = 2, k: int = 3, stride: int = 1,
                  pad: int = 1, in_layout: str = "CHW",
                  out_layout: str = "CHW", pin=None):
    """x: (C, H, W) or (H, W, C), optionally batched; u: prepared kernels
    (alpha^2, M, C); b: (M,).  Returns (M, OH, OW) or, with
    ``out_layout="HWC"``, (OH, OW, M): the output transform writes HWC
    itself.  stride must be 1 (Winograd restriction).
    ``pin``: the batched GEMM's (tile, splits), a tuned variant's.
    """
    if stride != 1:
        raise ValueError("Winograd convolution needs stride 1")
    if in_layout not in ("CHW", "HWC") or out_layout not in ("CHW", "HWC"):
        raise ValueError(f"bad layouts {in_layout!r}, {out_layout!r}")
    single = x.dim() == 3
    xb = x.unsqueeze(0) if single else x
    if in_layout == "HWC":
        xb = xb.permute(0, 3, 1, 2)
    # the images side by side in N: V (P, C, n * T), Q (P, M, n * T)
    y = wt.winograd_conv(xb, lambda v: winograd_bgemm(u, v, pin), b, m_=m_,
                         k=k, pad=pad, out_layout=out_layout)
    return y[0] if single else y
