"""Tunable space of the im2col GEMM kernel (autotune hook).

The kernel is the (M, C*K*K) x (C*K*K, OH*OW) GEMM of the Hopper
mainloop (``csrc/matmul.cu``); a variant launches it on one tile and
one cluster split count in place of the planner's choice.  Variants
inherit ``pallas_im2col_chw``'s layouts, packing and fusable sets.  See
:mod:`..matmul.space` for the axes and what is valid where.
"""
from __future__ import annotations

from typing import Dict

from ...autotune.space import TunableSpace, params_tuple
from ...core.primitives import Primitive
from ...core.scenario import Scenario
from .. import kernel_variant
from ..matmul.space import AXES, legal, pin_of, ratio, tile_fits

BASE_NAME = "pallas_im2col_chw"


def _k(scn: Scenario) -> int:
    return scn.c * scn.k * scn.k


def model_ratio(scn: Scenario, params: Dict[str, int]) -> float:
    """Planner model of the variant's launch over the entry's, at ``scn``."""
    return ratio((scn.m, scn.out_h * scn.out_w, _k(scn), scn.n),
                 pin_of(params, SPACE.axis_order))


def _valid(p) -> bool:
    return tile_fits(p)


def _make_primitive(params) -> Primitive:
    tile, splits = pin_of(params, SPACE.axis_order)
    return kernel_variant(BASE_NAME, SPACE.name_for(BASE_NAME, params),
                          (tile, splits), legal(_k, tile, splits),
                          params_tuple(params, SPACE.axis_order))


SPACE = TunableSpace(kernel="conv_im2col", axes=AXES, valid=_valid,
                     make_primitive=_make_primitive)
