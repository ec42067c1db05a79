"""Gradient compression for cross-pod synchronisation (port of the
reference's ``optim/compression.py``).

int8 quantisation with a per-tensor scale, optionally with stochastic
rounding: the pseudo-gradient exchanged between pods shrinks 4x.  The
reference's ``compressed_psum_tree`` is an all-reduce over a named mesh
axis; it comes with the ROADMAP's slice G2 (the LM mesh).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["quantize_int8", "dequantize_int8"]


def quantize_int8(x: torch.Tensor, key: Optional[torch.Generator] = None):
    """(q int8, scale f32 0-d): ``x / scale`` rounded half to even and
    clipped to [-127, 127], ``scale = max|x| / 127``.  ``key``: a
    ``torch.Generator`` on ``x``'s device (the reference's JAX key) for
    stochastic rounding, which is unbiased: uniform noise in [-0.5, 0.5)
    is added before rounding."""
    x32 = x.float()
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    scaled = x32 / scale
    if key is not None:  # stochastic rounding: unbiased compression
        noise = torch.rand(x.shape, generator=key, dtype=torch.float32,
                           device=x.device) - 0.5
        scaled = scaled + noise
    q = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
