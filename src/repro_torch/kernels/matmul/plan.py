"""Launch planner of the Hopper GEMM mainloop (``csrc/sgemm_sm90.cuh``).

A pure function of the product's shape, its batch, its dtype and the
operands' copy widths.  It picks the output tile, the number of K splits
S (the blocks of one cluster, which share an output tile and sum their
partials through distributed shared memory) and the K slice of each
split, and passes them to the C entries as arguments.  Three bindings
use it: the GEMM (``matmul.kernel``), the Winograd batched GEMM
(``winograd_gemm.kernel``, the transform points as the batch) and the
direct convolution (``conv_direct.kernel``), whose implicit GEMM is
(pixels x K*K*C) @ (K*K*C x M), or its transpose for a CHW output.

The choice minimises a small model of the kernel's time on an H100 SXM,

    waves * K steps per split * STEP_US + FIXED_US (+ SPLIT_US if S > 1)

per tile.  A wave is as many blocks as the card holds at once, one per
SM: clusters of S blocks must share a GPC, so only GPCS * (GPC_SMS // S)
clusters fit in one (the card has 132 SMs in GPCs of 14 to 18).  The
128 x 128 tile holds one block per SM, so a second wave costs as much as
the first; the others hold two or three, and the blocks that share an
SM add only ``SHARE_GAIN - 1`` of the throughput.  The narrow tiles
(128 x 32, 128 x 16) are for a short N: the Winograd GEMM's 16 or 49
columns of an image.  The constants were fitted to this kernel's times
over every tile and split count at AlexNet's im2col GEMMs, GoogLeNet's
1x1 GEMMs and AlexNet's Winograd GEMMs, batch 1 and 8, and at the direct
conv's conv1 and conv2 (``tools/bench_torch_gemm.py --sweep``; PERF.md
gives the run).  Splits cut K into equal slices, a whole number of the
tile's K steps each, at least ``MIN_STEPS`` steps long; none is empty.
Plans are cached: the function is pure.  A tuned variant
(``kernels/*/space.py``) pins the tile and split count instead
(:func:`pin_gemm`), where they are a plan the planner could choose.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ..common import cdiv

__all__ = ["GemmPlan", "plan_gemm", "pin_gemm", "split_kslice", "model_us",
           "vector_width", "smem_bytes", "TILES", "SMS", "MAX_SPLITS",
           "MIN_STEPS", "SMEM_PER_BLOCK"]

#: (BM, BN, BK) of each tile instantiation, by the C entries' ``tile``
TILES = ((128, 128, 16), (64, 64, 32), (128, 32, 16), (128, 16, 32))
SMS = 132          # streaming multiprocessors of an H100 SXM
MAX_SPLITS = 8     # the portable cluster size
MIN_STEPS = 2      # K steps per split, at least (unless S = 1)
#: the model, per tile: device microseconds per K step of a block alone
#: on its SM, per launch, and per launch that splits K
STEP_US = (1.6, 1.1, 1.1, 1.1)
FIXED_US = (6.0, 3.0, 4.5, 3.1)
SPLIT_US = (0.0, 2.0, 4.4, 4.9)
#: per tile, the throughput of an SM's co-resident blocks over one block
#: alone (128 x 128 holds one, 64 x 64 two, 128 x 32 three, 128 x 16 two)
SHARE_GAIN = (1.0, 1.17, 2.6, 1.13)
GPCS, GPC_SMS = 7, 16  # the cluster packing that fits the timings
STAGES = 4         # the mainloop's ring of K slices (``sgemm_sm90.cuh``)
SMEM_PER_BLOCK = 232448  # Hopper's 227 KB of dynamic shared memory


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """One launch: ``grid = (cdiv(N, BN) * splits, cdiv(M, BM), batch)``,
    clusters of ``(splits, 1, 1)``; split s reduces K in
    ``[s * kslice, min(K, (s + 1) * kslice))``."""
    tile: int
    splits: int
    kslice: int
    vec_a: int
    vec_b: int
    grid: Tuple[int, int, int]

    @property
    def bm(self) -> int:
        return TILES[self.tile][0]

    @property
    def bn(self) -> int:
        return TILES[self.tile][1]

    @property
    def blocks(self) -> int:
        x, y, z = self.grid
        return x * y * z

    def k_range(self, split: int, k: int) -> Tuple[int, int]:
        lo = split * self.kslice
        return lo, min(k, lo + self.kslice)

    def describe(self) -> str:
        return (f"tile {self.bm}x{self.bn}, S={self.splits}, "
                f"kslice {self.kslice}, {self.blocks} blocks, "
                f"vec {self.vec_a}/{self.vec_b}")


def vector_width(t: torch.Tensor, staged_dim: int) -> int:
    """The copy width of an operand: 4 (16-byte copies) where it is f32,
    its staged axis ``staged_dim`` (M for A, N for B) is contiguous, and
    its base and every other stride are 16-byte aligned; else 1.  Axes of
    extent 1 are never stepped, so their strides do not count."""
    if t.dtype != torch.float32 or t.stride(staged_dim) != 1:
        return 1
    if t.data_ptr() % 16:
        return 1
    others = [s for d, (n, s) in enumerate(zip(t.shape, t.stride()))
              if d != staged_dim % t.dim() and n > 1]
    return 4 if all(s % 4 == 0 for s in others) else 1


def smem_bytes(tile: int) -> int:
    """A block's dynamic shared memory on ``tile``, as ``Tile::RING``
    counts it: the ring of K slices of A and B, f32, pitches padded by 4."""
    bm, bn, bk = TILES[tile]
    return 4 * STAGES * bk * (bm + 4 + bn + 4)


def _splits(k: int, bk: int, splits: int) -> Tuple[int, int]:
    """(S, kslice) for about ``splits`` equal slices of whole steps, with
    no empty slice."""
    steps = max(1, cdiv(k, bk))
    kslice = cdiv(steps, splits) * bk
    return max(1, cdiv(k, kslice)), kslice


def split_kslice(k: int, tile: int, splits: int) -> Optional[int]:
    """The K slice of ``splits`` equal splits on ``tile``, or None where
    the planner would not launch them: the slices come out fewer than
    asked, or shorter than ``MIN_STEPS`` steps."""
    bk = TILES[tile][2]
    got, kslice = _splits(k, bk, splits)
    if got != splits or (splits > 1 and kslice < MIN_STEPS * bk):
        return None
    return kslice


def _model_us(tile: int, tiles: int, splits: int, kslice: int) -> float:
    blocks = tiles * splits
    slots = SMS if splits == 1 else min(SMS,
                                        GPCS * (GPC_SMS // splits) * splits)
    waves = cdiv(blocks, slots)
    if waves > 1:
        waves /= SHARE_GAIN[tile]
    steps = kslice // TILES[tile][2]
    return (waves * steps * STEP_US[tile] + FIXED_US[tile]
            + (SPLIT_US[tile] if splits > 1 else 0.0))


def model_us(plan: GemmPlan, m: int, n: int, batch: int = 1) -> float:
    """The planner's model of ``plan``'s time (us) on an (M x K) @ (K x N)
    product over ``batch``."""
    tiles = cdiv(m, plan.bm) * cdiv(n, plan.bn) * batch
    return _model_us(plan.tile, tiles, plan.splits, plan.kslice)


def _plan(tile: int, splits: int, kslice: int, m: int, n: int, batch: int,
          vec_a: int, vec_b: int) -> GemmPlan:
    bm, bn, _ = TILES[tile]
    return GemmPlan(tile, splits, kslice, vec_a, vec_b,
                    (cdiv(n, bn) * splits, cdiv(m, bm), batch))


def _check(m, n, k, batch, dtype, vec_a, vec_b):
    if min(m, n, batch) < 1 or k < 0:
        raise ValueError(f"no GEMM of {m}x{k} @ {k}x{n} over {batch}")
    if dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"the GEMM mainloop takes f32, bf16 or f16, not "
                        f"{dtype}")
    if dtype != torch.float32:
        vec_a = vec_b = 1  # 2-byte types are loaded through registers
    return vec_a, vec_b


@functools.lru_cache(maxsize=4096)
def pin_gemm(m: int, n: int, k: int, batch: int = 1,
             dtype: torch.dtype = torch.float32, vec_a: int = 1,
             vec_b: int = 1, *, tile: int, splits: int) -> GemmPlan:
    """The launch of ``tile`` and ``splits`` (a tuned variant's) for this
    product, in place of the planner's choice; raises ValueError where the
    planner would not launch them (:func:`split_kslice`).  Cached, as
    :func:`plan_gemm` is, so a pinned launch costs the host no more than
    the planner's."""
    vec_a, vec_b = _check(m, n, k, batch, dtype, vec_a, vec_b)
    if not 0 <= tile < len(TILES) or not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"no tile {tile} with {splits} splits")
    kslice = split_kslice(k, tile, splits)
    if kslice is None:
        raise ValueError(f"{splits} splits of K = {k} on the "
                         f"{TILES[tile][0]}x{TILES[tile][1]} tile are not "
                         f"a legal plan")
    return _plan(tile, splits, kslice, m, n, batch, vec_a, vec_b)


@functools.lru_cache(maxsize=4096)
def plan_gemm(m: int, n: int, k: int, batch: int = 1,
              dtype: torch.dtype = torch.float32, vec_a: int = 1,
              vec_b: int = 1, tiles: Tuple[int, ...] = None) -> GemmPlan:
    """The launch of an (M x K) @ (K x N) product over ``batch``, on one
    of ``tiles`` (indices into ``TILES``; all of them by default)."""
    vec_a, vec_b = _check(m, n, k, batch, dtype, vec_a, vec_b)
    cands = []
    for tile in range(len(TILES)) if tiles is None else tiles:
        bm, bn, _ = TILES[tile]
        out_tiles = cdiv(m, bm) * cdiv(n, bn) * batch
        for splits in range(1, MAX_SPLITS + 1):
            kslice = split_kslice(k, tile, splits)
            if kslice is not None:
                cands.append((_model_us(tile, out_tiles, splits, kslice),
                              splits, tile, kslice))
    _, splits, tile, kslice = min(cands)
    return _plan(tile, splits, kslice, m, n, batch, vec_a, vec_b)
