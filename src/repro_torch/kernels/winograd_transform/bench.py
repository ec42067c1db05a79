"""Operands and least bytes of the Winograd transforms at one scenario.

No calibration entry: the transforms are no primitive of their own and
are timed inside the Winograd primitives that run them.  ``chip_smoke.py``
times each transform on the operands built here, beside its bound."""
from __future__ import annotations

import numpy as np
import torch

from ...core.scenario import Scenario
from ..common import resolve_device
from .ref import tiles


def transform_bytes(scn: Scenario, m_: int):
    """The least bytes each transform moves at ``scn`` (batch ``scn.n``):
    (input: read x, write V; output: read Q, write y), f32."""
    _, _, nth, ntw = tiles(scn.h, scn.w, m_, scn.k, scn.pad)
    vq = (m_ + scn.k - 1) ** 2 * scn.n * nth * ntw
    return (4 * (scn.n * scn.c * scn.h * scn.w + vq * scn.c),
            4 * (vq * scn.m + scn.n * scn.m * scn.out_h * scn.out_w))


def operands(scn: Scenario, m_: int, device=None):
    """The transforms' operands at ``scn`` (batch ``scn.n``) with
    F(m_, scn.k), drawn from a fixed seed: x (N, C, H, W), Q (alpha^2, M,
    N * T) and the bias (M,), f32 on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    _, _, nth, ntw = tiles(scn.h, scn.w, m_, scn.k, scn.pad)
    a = m_ + scn.k - 1
    shapes = ((scn.n, scn.c, scn.h, scn.w),
              (a * a, scn.m, scn.n * nth * ntw), (scn.m,))
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(dev) for s in shapes)
