"""Calibration benchmark entry for the direct-convolution kernel."""
from __future__ import annotations

import numpy as np

from ...core.scenario import Scenario
from ..common import resolve_device


def benchmark_entry(scn: Scenario, device=None):
    """Zero-arg builder timing ``conv_direct`` (HWC) at this scenario, or
    None.  The builder defers tensor allocation to measurement time so
    that sweep planning (and ``--dry-run``) stays free."""
    if scn.h + 2 * scn.pad < scn.k or scn.w + 2 * scn.pad < scn.k:
        return None

    def build():
        import torch

        from .ops import conv_direct
        dev = resolve_device(device)
        rng = np.random.default_rng(0)
        x = rng.normal(size=(scn.h, scn.w, scn.c))
        w = rng.normal(size=(scn.k, scn.k, scn.c, scn.m)) * 0.1
        b = rng.normal(size=(scn.m,))
        x, w, b = (torch.from_numpy(a.astype(np.float32)).to(dev)
                   for a in (x, w, b))
        fn = lambda x, w, b: conv_direct(x, w, b, stride=scn.stride,
                                         pad=scn.pad)
        return fn, (x, w, b)

    return build
