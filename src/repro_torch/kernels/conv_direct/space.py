"""Tunable space of the direct convolution kernel (autotune hook).

The CUDA kernel is an implicit GEMM, (OH*OW x K*K*C) @ (K*K*C x M) per
image, on the Hopper mainloop; a variant launches it on one of the tiles
it is built for (``kernel.CONV_TILES``) and one cluster split count in
place of the planner's choice.  The reference's ``bm`` is a TPU block
size; its ``unroll`` (the Pallas kernel's unrolled or rolled K x K tap
loop) has no counterpart: the implicit GEMM walks K x K x C as one
reduction axis, with no loop over taps of its own.  A configuration is
valid where the tile's ring and the kernel's tap table fit a block's
227 KB.  The reference's VMEM bound on the input strip stays in
``supports``, as the hand-written entry has it.
"""
from __future__ import annotations

from typing import Dict

from ...autotune.space import TunableSpace, params_tuple
from ...core.primitives import Primitive
from ...core.scenario import Scenario
from .. import kernel_variant
from ..matmul.space import SPLITS, legal, pin_of, ratio, tile_fits
from .kernel import CONV_TILES

BASE_NAME = "pallas_direct_hwc"

#: the tap table's most bytes (``csrc/conv_direct.cu``: TAP_CHUNK int2)
TAP_TABLE_BYTES = 4096 * 8

AXES = (("tile", CONV_TILES),
        ("splits", SPLITS))


def _k(scn: Scenario) -> int:
    return scn.k * scn.k * scn.c


def model_ratio(scn: Scenario, params: Dict[str, int]) -> float:
    """Planner model of the variant's launch over the entry's, at ``scn``
    (the native HWC output: pixels x M)."""
    return ratio((scn.out_h * scn.out_w, scn.m, _k(scn), scn.n),
                 pin_of(params, SPACE.axis_order), tiles=CONV_TILES)


def _valid(p) -> bool:
    return tile_fits(p, TAP_TABLE_BYTES)


def _make_primitive(params) -> Primitive:
    tile, splits = pin_of(params, SPACE.axis_order)
    return kernel_variant(BASE_NAME, SPACE.name_for(BASE_NAME, params),
                          (tile, splits), legal(_k, tile, splits),
                          params_tuple(params, SPACE.axis_order))


SPACE = TunableSpace(kernel="conv_direct", axes=AXES, valid=_valid,
                     make_primitive=_make_primitive)
