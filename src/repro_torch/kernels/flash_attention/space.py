"""Tunable space of the flash-attention kernel (autotune hook).

Flash attention is not a convolution primitive, so this is a
*kernel-only* space: the winning launch per scenario bucket is recorded
in the variant catalog as a ``kernel::`` entry, not registered with
PBQP.  Its axes are the launch planner's (:mod:`.plan`): the query tile
BQ and the cluster KV split S, in place of the planner's choice (the
reference's ``bq``/``bk`` are TPU block sizes).  The scenario-induced
attention problem is the reference's (:mod:`.bench`: sequence = OH*OW
capped at 1024, 4 heads, head dim 64).
"""
from __future__ import annotations

import math

import numpy as np

from ...autotune.space import TunableSpace
from ..common import resolve_device
from .plan import (MAX_SPLITS, QUERY_TILES, SMEM_PER_SM, model_us,
                   padded_dim, pin_attention, plan_attention, smem_bytes)

_HEADS = 4
_HEAD_DIM = 64
_MAX_SEQ = 1024

AXES = (("bq", QUERY_TILES),
        ("splits", tuple(range(1, MAX_SPLITS + 1))))


def _valid(p) -> bool:
    # the block's ring and tiles within an SM's shared memory (228 KB,
    # of which 1 KB is reserved per block)
    return smem_bytes(padded_dim(_HEAD_DIM), p["bq"]) + 1024 <= SMEM_PER_SM


def _seq(scn) -> int:
    return min(scn.out_h * scn.out_w, _MAX_SEQ)


def planner_params(scn):
    """The planner's own (BQ, S) at the scenario's attention, or None
    where the scenario induces none."""
    seq = _seq(scn)
    if seq < 8:
        return None
    plan = plan_attention(1, _HEADS, seq, seq, _HEAD_DIM)
    return {"bq": plan.bq, "splits": plan.splits}


def _benchmark(scn, params, device=None):
    seq = _seq(scn)
    if seq < 8:
        return None
    pin = (params["bq"], params["splits"])

    def build():
        import functools

        import torch

        from .ops import flash_attention
        dev = resolve_device(device)
        rng = np.random.default_rng(0)
        shape = (1, _HEADS, seq, _HEAD_DIM)
        q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev) for _ in range(3))
        return functools.partial(flash_attention, pin=pin), (q, k, v)

    return build


def _analytic(scn, params, spec) -> float:
    """The roofline of the scenario-induced attention under ``spec``,
    times the planner's model of the pinned launch over its model of its
    own choice."""
    seq = _seq(scn)
    if seq < 8:
        return math.inf
    flops = 4.0 * _HEADS * seq * seq * _HEAD_DIM
    nbytes = 4.0 * 4 * _HEADS * seq * _HEAD_DIM
    eff = spec.family_eff.get("pallas", 0.5)
    roof = max(flops / (eff * spec.peak_flops), nbytes / spec.mem_bw)
    pinned = pin_attention(1, _HEADS, seq, _HEAD_DIM, bq=params["bq"],
                           splits=params["splits"])
    own = plan_attention(1, _HEADS, seq, seq, _HEAD_DIM)
    return roof * model_us(pinned, seq) / model_us(own, seq)


SPACE = TunableSpace(kernel="flash_attention", axes=AXES, valid=_valid,
                     benchmark=_benchmark, analytic=_analytic)
