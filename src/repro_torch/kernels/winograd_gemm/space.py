"""Tunable space of the Winograd batched-GEMM kernel (autotune hook).

Axes: ``m_`` — the F(m, 3) output tile (2 or 4; it changes the offline
kernel transform, so it is part of ``prepare``), as in the reference;
``tile`` and ``splits`` — the Hopper mainloop's tile and cluster split
count for the (alpha^2, M, C) x (alpha^2, C, images * tiles) product, in
place of the planner's choice (the reference's ``bn``/``bc`` are TPU
block sizes).  See :mod:`..matmul.space` for what is valid where.
"""
from __future__ import annotations

from typing import Dict

from ...autotune.space import TunableSpace, params_tuple
from ...core.primitives import Primitive
from ...core.scenario import Scenario
from .. import kernel_variant
from ..common import cdiv
from ..matmul.space import AXES as GEMM_AXES
from ..matmul.space import legal, pin_of, ratio, tile_fits

BASE_NAME = "pallas_wino_chw"

AXES = (("m_", (2, 4)),) + GEMM_AXES


def model_ratio(scn: Scenario, params: Dict[str, int]) -> float:
    """Planner model of the variant's launch over the entry's, at ``scn``:
    the transform points are the batch, a batch of images folds into N."""
    pin = pin_of(params, SPACE.axis_order)
    m_ = params["m_"]
    tiles = cdiv(scn.out_h, m_) * cdiv(scn.out_w, m_)
    return ratio((scn.m, scn.n * tiles, scn.c, (m_ + 2) ** 2), pin)


def _valid(p) -> bool:
    return tile_fits(p)


def _make_primitive(params) -> Primitive:
    tile, splits = pin_of(params, SPACE.axis_order)
    # keep the hand-written entries' name shape (pallas_wino_f{m}x3_…),
    # as the reference does, so the analytic model reads the F(m, 3)
    base = f"pallas_wino_f{params['m_']}x3_chw"
    return kernel_variant(
        base, SPACE.name_for(base, {k: v for k, v in params.items()
                                    if k != "m_"}),
        (tile, splits), legal(lambda scn: scn.c, tile, splits),
        params_tuple(params, SPACE.axis_order))


SPACE = TunableSpace(kernel="winograd_gemm", axes=AXES, valid=_valid,
                     make_primitive=_make_primitive)
