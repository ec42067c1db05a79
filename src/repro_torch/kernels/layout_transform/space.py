"""Tunable space of the layout-transform kernel (autotune hook).

Kernel-only space: the axis is the transpose kernel's route
(:mod:`.kernel`: the 32 x 32 tile, or a short-axis route where one axis
has at most ``SHORT_MAX`` elements) in place of ``kernel.route``'s
choice; the winning route per bucket lands in the variant catalog as a
``kernel::`` entry.  The problem is the calibration sweep's (:mod:`.bench`):
the scenario's input, CHW -> HWC8 where the channels allow blocking,
CHW -> HWC otherwise, one (C, H*W) -> (H*W, C) transpose.  The reference's
(bh, bw) are TPU tile sizes.  The routes have no time model: every one
prices at its bytes over the bandwidth, and ties go to the first.
"""
from __future__ import annotations

import math

import numpy as np

from ...autotune.space import TunableSpace
from ..common import resolve_device
from .kernel import SHORT_COLS, SHORT_MAX, SHORT_ROWS, TILE, route

AXES = (("route", (TILE, SHORT_ROWS, SHORT_COLS)),)


def _valid(p) -> bool:
    return p["route"] in (TILE, SHORT_ROWS, SHORT_COLS)


def _runs(scn, rt: int) -> bool:
    """Whether the kernel takes route ``rt`` for the scenario's (C, H*W)
    transpose: a short route needs its short axis within SHORT_MAX."""
    c, h, w = scn.in_shape_chw
    return rt == TILE or (rt == SHORT_ROWS and c <= SHORT_MAX) or \
        (rt == SHORT_COLS and h * w <= SHORT_MAX)


def planner_params(scn):
    """``kernel.route``'s own choice for the scenario's transpose."""
    c, h, w = scn.in_shape_chw
    return {"route": route(c, h * w, 4)}


def _benchmark(scn, params, device=None):
    rt = params["route"]
    if not _runs(scn, rt):
        return None

    def build():
        import torch

        from .ops import chw_to_hwc, chw_to_hwc8
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(size=scn.in_shape_chw).astype(
            np.float32)).to(resolve_device(device))
        fn = chw_to_hwc8 if scn.c % 8 == 0 else chw_to_hwc
        return (lambda a: fn(a, rt)), (x,)

    return build


def _analytic(scn, params, spec) -> float:
    if not _runs(scn, params["route"]):
        return math.inf
    return 2.0 * 4 * float(np.prod(scn.in_shape_chw)) / spec.mem_bw


SPACE = TunableSpace(kernel="layout_transform", axes=AXES, valid=_valid,
                     benchmark=_benchmark, analytic=_analytic)
