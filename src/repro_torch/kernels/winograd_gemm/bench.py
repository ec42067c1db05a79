"""Calibration benchmark entry for the Winograd convolution on the
batched-GEMM kernel."""
from __future__ import annotations

import numpy as np

from ...core.scenario import Scenario
from ..common import resolve_device


def benchmark_entry(scn: Scenario, device=None):
    """Zero-arg builder timing ``conv_winograd`` (F(2,3)), or None.

    Winograd restrictions: K = 3, stride 1 (the same predicate as the
    ``pallas_wino_*`` primitives).
    """
    if scn.k != 3 or scn.stride != 1:
        return None
    if scn.h + 2 * scn.pad < scn.k or scn.w + 2 * scn.pad < scn.k:
        return None

    def build():
        import torch

        from .ops import conv_winograd, prepare_kernel
        dev = resolve_device(device)
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(size=scn.in_shape_chw).astype(
            np.float32)).to(dev)
        w = (rng.normal(size=scn.weight_shape) * 0.1).astype(np.float32)
        u = prepare_kernel(w, 2).to(dev)  # packing is deployment-time
        b = torch.from_numpy(rng.normal(size=(scn.m,)).astype(
            np.float32)).to(dev)
        fn = lambda x, u, b: conv_winograd(x, u, b, m_=2, k=scn.k,
                                           stride=1, pad=scn.pad)
        return fn, (x, u, b)

    return build
