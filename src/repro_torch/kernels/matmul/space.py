"""Tunable space of the GEMM kernel (autotune hook).

Registered variants are pointwise (K=1) convolutions — the (M, C) x
(C, OHOW) GEMM the hand-written ``pallas_pw_gemm_chw`` entry runs —
each launched on one tile of the Hopper mainloop and one cluster split
count (:mod:`.plan`'s ``TILES`` and S) in place of the planner's choice.
The reference's axes (bm, bn, bk under a VMEM budget) are TPU block
sizes with no meaning for this kernel.  A configuration is valid where
its tile's shared memory fits a block's 227 KB; whether its split count
is a legal plan at a scenario's K (``plan.split_kslice``) lives in the
generated primitive's ``supports``.

The helpers below serve the four GEMM-based spaces (this one, im2col,
Winograd and the direct conv's implicit GEMM).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

from ...autotune.space import TunableSpace, params_tuple
from ...core.primitives import Primitive
from ...core.scenario import Scenario
from .. import kernel_variant
from .plan import (SMEM_PER_BLOCK, TILES, GemmPlan, model_us, pin_gemm,
                   plan_gemm, smem_bytes, split_kslice)

BASE_NAME = "pallas_pw_gemm_chw"

#: the cluster split counts tried (the planner may choose any of 1-8)
SPLITS = (1, 2, 4, 8)

AXES = (("tile", tuple(range(len(TILES)))),
        ("splits", SPLITS))

#: (M, N, K, batch) of a GEMM
Shape = Tuple[int, int, int, int]


def pin_of(params: Dict[str, int], axes: Sequence[str]) -> Tuple[int, int]:
    """The (tile, splits) of a configuration; raises on parameters that
    are not this space's axes (a catalog of another space or package)."""
    if set(params) != set(axes):
        raise ValueError(f"parameters {sorted(params)} are not the axes "
                         f"{sorted(axes)} of this space; re-run the tuner")
    return int(params["tile"]), int(params["splits"])


def tile_fits(params: Dict[str, int], extra: int = 0) -> bool:
    """The tile's shared memory (plus ``extra`` bytes) within a block's
    227 KB."""
    return smem_bytes(params["tile"]) + extra <= SMEM_PER_BLOCK


def legal(k_of: Callable[[Scenario], int], tile: int,
          splits: int) -> Callable[[Scenario], bool]:
    """Whether ``splits`` splits on ``tile`` are a plan the planner could
    choose at the scenario's reduction length ``k_of(scn)``."""
    return lambda scn: split_kslice(k_of(scn), tile, splits) is not None


def ratio(shape: Shape, pin: Tuple[int, int],
          tiles: Optional[Tuple[int, ...]] = None) -> float:
    """The planner's model of the pinned launch over its model of its own
    choice (among ``tiles``) on one GEMM: how much slower the variant
    is predicted to run than the hand-written entry."""
    m, n, k, b = shape
    own: GemmPlan = plan_gemm(m, n, k, b, tiles=tiles)
    pinned = pin_gemm(m, n, k, b, tile=pin[0], splits=pin[1])
    return model_us(pinned, m, n, b) / model_us(own, m, n, b)


def gemm_shape(scn: Scenario) -> Shape:
    """The entry's product: (M, C) @ (C, OH*OW) per image."""
    return scn.m, scn.out_h * scn.out_w, scn.c, scn.n


def model_ratio(scn: Scenario, params: Dict[str, int]) -> float:
    """Planner model of the variant's launch over the entry's, at ``scn``
    (the analytic measurer's price ratio)."""
    return ratio(gemm_shape(scn), pin_of(params, SPACE.axis_order))


def _valid(p) -> bool:
    return tile_fits(p)


def _make_primitive(params) -> Primitive:
    tile, splits = pin_of(params, SPACE.axis_order)
    return kernel_variant(BASE_NAME, SPACE.name_for(BASE_NAME, params),
                          (tile, splits),
                          legal(lambda scn: scn.c, tile, splits),
                          params_tuple(params, SPACE.axis_order))


SPACE = TunableSpace(kernel="matmul", axes=AXES, valid=_valid,
                     make_primitive=_make_primitive)
