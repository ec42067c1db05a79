"""Launch planner of the flash-attention kernel (``csrc/flash_attention.cu``).

A pure function of the problem's shape (batch, query heads, Lq, Lk, head
dim).  It picks the padded head dim DP (the smallest instantiated width
that holds D; D > 256 runs in slices of 256), the query tile BQ (32 or
64 rows) and the KV split S: the S blocks of one thread-block cluster
share a query tile, each reduces a contiguous run of its KV tiles, and
they merge their partial softmax statistics through distributed shared
memory.  ``bq``, ``splits`` and ``dp`` are passed to the C entry, which
refuses a plan it cannot run.

The choice minimises a small model of the kernel's time on an H100 SXM,

    KV tiles per rank * STEP_US[dp, bq] * (1 if rounds == 1 else
    rounds * SHARE) + FIXED_US (+ SPLIT_US if S > 1)

A round is as many blocks as the card runs without two blocks sharing an
SM's four schedulers: one per SM, or two where a block has two warps
(BQ 32 up to DP 128) and shared memory holds both.  Blocks beyond a
round run co-resident or after it, and the sweep found them slower than
that round's share of the work (SHARE > 1): on this kernel a block of
four warps keeps an SM busy, so the planner splits the KV range until
the blocks fill one round and no further.  The constants were fitted to
the kernel's times over every (BQ, S) at the calibration sweep's shapes
and at D = 128 and 256 (``tools/bench_torch_gemm.py --sweep``; PERF.md,
PR 16, gives the run).  Plans are cached: the function is pure.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from ..common import cdiv

__all__ = ["AttnPlan", "plan_attention", "make_plan", "pin_attention",
           "model_us", "padded_dim",
           "smem_bytes", "threads", "kv_tile", "HEAD_WIDTHS", "QUERY_TILES",
           "MAX_SPLITS"]

#: the padded head dims the kernel is instantiated for
HEAD_WIDTHS = (32, 64, 128, 256)
QUERY_TILES = (32, 64)
MAX_SPLITS = 8           # the portable cluster size
SMS = 132                # streaming multiprocessors of an H100 SXM
SMEM_PER_SM = 233472     # 228 KB, of which 1 KB is reserved per block
#: the model: device microseconds per KV tile of a block, by (DP, BQ);
#: per launch; per launch that splits the KV range (the merge); the cost
#: of a block beyond the first round, over its share of the work
STEP_US = {(32, 32): 3.3, (32, 64): 3.0, (64, 32): 5.1, (64, 64): 4.7,
           (128, 32): 5.2, (128, 64): 4.9, (256, 32): 6.5, (256, 64): 11.7}
FIXED_US = 7.0
SPLIT_US = 1.0
SHARE = 1.45


def padded_dim(d: int) -> int:
    """The instantiated width a head dim of ``d`` runs at (256 for any
    d > 256, which runs in slices of 256)."""
    if d < 1:
        raise ValueError(f"head dim {d}")
    return next((w for w in HEAD_WIDTHS if w >= d), HEAD_WIDTHS[-1])


def kv_tile(dp: int) -> int:
    """Keys per KV tile: 64 up to DP = 64, 32 beyond."""
    return 64 if dp <= 64 else 32


def _stages(dp: int) -> int:
    return 3 if dp <= 32 else 2


def threads(dp: int, bq: int) -> int:
    """Threads per block: a warp holds 16 query rows (8 at DP = 256)."""
    return bq // (16 if dp <= 128 else 8) * 32


def smem_bytes(dp: int, bq: int) -> int:
    """The block's dynamic shared memory, as ``Cfg::SMEM`` computes it:
    the Q tile, the ring of K and V tiles and the P tile, f32."""
    bkv = kv_tile(dp)
    floats = (bq * (dp + 4) + _stages(dp) * 2 * bkv * (dp + 4)
              + bq * (bkv + 8))
    return 4 * floats


def _per_sm(dp: int, bq: int) -> int:
    return SMEM_PER_SM // (smem_bytes(dp, bq) + 1024)


@dataclasses.dataclass(frozen=True)
class AttnPlan:
    """One launch: ``grid = (cdiv(Lq, bq) * splits, Hq * slices, B)``,
    clusters of ``(splits, 1, 1)``."""
    dp: int
    bq: int
    splits: int
    slices: int
    grid: Tuple[int, int, int]

    @property
    def bkv(self) -> int:
        return kv_tile(self.dp)

    @property
    def blocks(self) -> int:
        x, y, z = self.grid
        return x * y * z

    @property
    def smem(self) -> int:
        return smem_bytes(self.dp, self.bq)

    def describe(self) -> str:
        return (f"DP {self.dp}, BQ {self.bq}, S={self.splits}, "
                f"{self.slices} slice(s), {self.blocks} blocks")


def _model_us(dp: int, bq: int, blocks: int, splits: int,
              tiles: int) -> float:
    per_round = max(1, min(_per_sm(dp, bq), 4 // (threads(dp, bq) // 32)))
    rounds = cdiv(blocks, SMS * per_round)
    per_rank = cdiv(tiles, splits)
    return (per_rank * STEP_US[dp, bq] * (1 if rounds == 1 else
                                          rounds * SHARE)
            + FIXED_US + (SPLIT_US if splits > 1 else 0.0))


def make_plan(b: int, hq: int, lq: int, d: int, dp: int, bq: int,
              splits: int) -> AttnPlan:
    """The launch of a given (DP, BQ, S), for sweeps."""
    slices = cdiv(d, dp) if d > dp else 1
    return AttnPlan(dp, bq, splits, slices,
                    (cdiv(lq, bq) * splits, hq * slices, b))


@functools.lru_cache(maxsize=4096)
def pin_attention(b: int, hq: int, lq: int, d: int, *, bq: int,
                  splits: int) -> AttnPlan:
    """The launch of query tile ``bq`` and KV split ``splits`` (a tuned
    variant's) at the padded head dim the planner takes; raises
    ValueError where the kernel does not run them."""
    dp = padded_dim(d)
    if bq not in QUERY_TILES or not 1 <= splits <= MAX_SPLITS or \
            (d > dp and bq != 32):
        raise ValueError(f"no launch of BQ {bq}, S {splits} at head dim "
                         f"{d}")
    return make_plan(b, hq, lq, d, dp, bq, splits)


def model_us(plan: AttnPlan, lk: int) -> float:
    """The planner's model of ``plan``'s time (us) over ``lk`` keys."""
    tiles = max(1, cdiv(lk, kv_tile(plan.dp)))
    return _model_us(plan.dp, plan.bq, plan.blocks, plan.splits, tiles)


@functools.lru_cache(maxsize=4096)
def plan_attention(b: int, hq: int, lq: int, lk: int, d: int,
                   dtype: torch.dtype = torch.float32) -> AttnPlan:
    """The launch of attention over ``b`` x ``hq`` heads of ``lq``
    queries, ``lk`` keys (the valid ones) and head dim ``d``."""
    if min(b, hq, lq) < 1 or lk < 0:
        raise ValueError(f"no attention over {b}x{hq} heads, Lq {lq}, "
                         f"Lk {lk}")
    if dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"flash attention takes f32, bf16 or f16, not "
                        f"{dtype}")
    dp = padded_dim(d)
    bqs = (32,) if d > dp else QUERY_TILES  # slices run at BQ 32 only
    tiles = max(1, cdiv(lk, kv_tile(dp)))
    cands = []
    for bq in bqs:
        for s in range(1, MAX_SPLITS + 1):
            if s > tiles:
                break  # a rank with no tile does nothing
            plan = make_plan(b, hq, lq, d, dp, bq, s)
            cands.append((_model_us(dp, bq, plan.blocks, s, tiles), s, bq,
                          plan))
    return min(cands, key=lambda c: c[:3])[3]
