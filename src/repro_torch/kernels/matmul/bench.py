"""Calibration benchmark entry for the GEMM kernel.

A convolution scenario induces the GEMM the im2col lowering would run:
``(M, C*K*K) @ (C*K*K, OH*OW)``, timed on the raw kernel.
"""
from __future__ import annotations

import numpy as np

from ...core.scenario import Scenario
from ..common import resolve_device


def benchmark_entry(scn: Scenario, device=None):
    """Zero-arg builder timing the scenario-induced GEMM, or None."""
    mm, kk, nn = scn.m, scn.c * scn.k * scn.k, scn.out_h * scn.out_w
    if min(mm, kk, nn) < 1:
        return None

    def build():
        import torch

        from .ops import matmul
        dev = resolve_device(device)
        rng = np.random.default_rng(0)
        a, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                .to(dev) for s in ((mm, kk), (kk, nn)))
        return matmul, (a, b)

    return build
