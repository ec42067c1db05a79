"""Calibration benchmark entry for the flash-attention kernel.

A convolution scenario induces an attention problem over its output
pixels: sequence length ``OH*OW`` capped at 1024, 4 heads, head dim 64
(the reference's ``kernels/flash_attention/bench.py``).
"""
from __future__ import annotations

import numpy as np

from ...core.scenario import Scenario
from ..common import resolve_device

_HEADS = 4
_HEAD_DIM = 64
_MAX_SEQ = 1024


def benchmark_entry(scn: Scenario, device=None):
    """Zero-arg builder timing the scenario-induced attention, or None."""
    seq = min(scn.out_h * scn.out_w, _MAX_SEQ)
    if seq < 1:
        return None

    def build():
        import torch

        from .ops import flash_attention
        dev = resolve_device(device)
        rng = np.random.default_rng(0)
        shape = (1, _HEADS, seq, _HEAD_DIM)
        q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev) for _ in range(3))
        return flash_attention, (q, k, v)

    return build
