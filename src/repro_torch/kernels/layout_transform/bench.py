"""Calibration benchmark entry for the layout-transform kernel."""
from __future__ import annotations

import numpy as np

from ...core.scenario import Scenario
from ..common import resolve_device


def benchmark_entry(scn: Scenario, device=None):
    """Zero-arg builder timing the transform on the scenario's input
    tensor, via :func:`~repro_torch.kernels.layout_transform.ops.convert`:
    CHW -> HWC8 when the channel count allows blocking, CHW -> HWC
    otherwise.  The reference wraps the call in ``jax.jit``; here it is
    called as it is."""
    def build():
        import torch

        from .ops import convert
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(size=scn.in_shape_chw).astype(
            np.float32)).to(resolve_device(device))
        dst = "HWC8" if scn.c % 8 == 0 else "HWC"
        return (lambda a: convert(a, "CHW", dst)), (x,)

    return build
