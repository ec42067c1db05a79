"""Plain PyTorch version of the Winograd batched GEMM (counterpart of the
reference's jnp oracle ``repro.kernels.winograd_gemm.ref``)."""
from __future__ import annotations

import torch


def bgemm_ref(u, v):
    """u: (P, M, C), v: (P, C, T) or (N, P, C, T) -> (P, M, T) or
    (N, P, M, T), accumulated in f32."""
    return torch.matmul(u.float(), v.float()).to(u.dtype)
