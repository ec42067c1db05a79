"""Binding of the layout-transform CUDA kernel (``csrc/layout_transform.cu``).

Replaces the reference's four Pallas kernels, ``chw_to_hwc_pallas``,
``hwc_to_chw_pallas``, ``chw_to_hwc8_pallas`` and ``hwc8_to_chw_pallas``.
(H, W, C/8, 8) in row-major memory is the same bytes as (H, W, C), so all
four are one (C, H*W) <-> (H*W, C) transpose, with the HWC8 blocking a
view on either side.  The reference's tile padding (H to 8, W to 128)
and cropping have no counterpart: the kernel masks its ragged tiles.
Each entry takes an optional leading batch axis.  :func:`plan` is the
launch: where one axis is short (conv1's 3 or 4 channels) :func:`route`
sends the transpose to the kernel's short-axis route, else to its tile,
whose size in bytes :func:`pick_tile` sets from the planes' bytes.  The
tile route's grid is 1-D over (plane, tile) and the short routes' planes
ride grid y and z (which the C entry sets), so no batch or plane size is
refused.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..common import KernelLib, cdiv, ptr, require_cuda, stream_ptr

_I, _L, _P = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
LIB = KernelLib("layout_transform.cu",
                {"repro_transpose": (_P, _P, _L, _L, _L, _I, _I, _I, _I,
                                     _P)})
#: the kernel's routes
TILE, SHORT_ROWS, SHORT_COLS = 0, 1, 2
#: the short routes' longest short axis (the kernel's SHORT_MAX), and the
#: most bytes of it: at 256 x 256 positions of f32 on the H100 the short
#: columns beat the tile at every C up to 16, the short rows at every C up
#: to 12, and at C = 16 (64 bytes) the tile's 16-byte accesses beat the
#: short rows, which therefore take fewer than SHORT_BYTES
#: (``tools/bench_torch_gemm.py --sweep``; PERF.md gives the run)
SHORT_MAX = 16
SHORT_BYTES = 64
#: positions a block of the short routes moves (the kernel's SHORT_THREADS)
SHORT_THREADS = 256
#: the tile route's tiles by the C entry's ``tile``, in bytes: 8 KB, and
#: 16 KB where the planes hold ``BLOCKS_PER_SM`` of those per SM (f64 has
#: no 16 KB tile).  Both fitted on the H100 by
#: ``tools/bench_torch_gemm.py --sweep``; PERF.md gives the run.
TILE_BYTES = (8 * 1024, 16 * 1024)
#: the tiles' shapes (the kernel's tile_rb / tile_sb): (bytes along R,
#: bytes along S).  A tile of e-byte elements takes shape log2(e) for
#: 8 KB and the next for 16 KB: (RB / e) x (SB / e) elements moved by
#: (RB / 16) x (SB / 16) threads, each a 16 / e square of elements,
#: through two buffers of it in shared memory; f32: 64 x 32 and 64 x 64.
SHAPES = ((128, 64), (128, 128), (256, 128), (256, 256))
#: the blocks per SM the tile route launches at most, each striding over
#: its tiles with the next tile's loads in flight
BLOCKS_PER_SM = 4
#: the H100 SXM's SMs (the planners' default; a launch passes its card's)
SMS = 132


def route(r: int, s: int, esize: int) -> int:
    """The kernel's route for a (R, S) -> (S, R) transpose of ``esize``-byte
    elements: a short axis of at most ``SHORT_MAX`` elements takes a short
    route, ``SHORT_COLS`` where S is the shorter and has at most
    ``SHORT_BYTES`` bytes, ``SHORT_ROWS`` where R is and has fewer;
    anything else the tile."""
    if r <= s:
        short = r <= SHORT_MAX and r * esize < SHORT_BYTES
        return SHORT_ROWS if short else TILE
    short = s <= SHORT_MAX and s * esize <= SHORT_BYTES
    return SHORT_COLS if short else TILE


def _shape(tile: int, esize: int) -> int:
    return esize.bit_length() - 1 + tile


def tile_built(tile: int, esize: int) -> bool:
    """Whether the kernel builds ``tile`` for ``esize``-byte elements."""
    return tile in (0, 1) and _shape(tile, esize) < len(SHAPES)


def tile_elems(tile: int, esize: int):
    """(rows along R, columns along S) of a tile, in elements."""
    rb, sb = SHAPES[_shape(tile, esize)]
    return rb // esize, sb // esize


def tile_count(r: int, s: int, esize: int, tile: int, batch: int = 1) -> int:
    tr, ts = tile_elems(tile, esize)
    return batch * cdiv(r, tr) * cdiv(s, ts)


def pick_tile(r: int, s: int, esize: int, batch: int = 1,
              sms: int = SMS) -> int:
    """The tile route's tile: 16 KB where the kernel builds it and the
    planes hold ``BLOCKS_PER_SM`` of them per SM (in f32 above 8 MiB of
    planes), else 8 KB (in f32 64 x 32 elements)."""
    if tile_built(1, esize) and \
            tile_count(r, s, esize, 1, batch) >= BLOCKS_PER_SM * sms:
        return 1
    return 0


@dataclass(frozen=True)
class LayoutPlan:
    """One launch of the kernel.  ``units``: the route's work items over
    the batch (tiles, or blocks of ``SHORT_THREADS`` positions).  On the
    tile route ``tile`` and ``grid``, the blocks launched, each striding
    over tiles; a short route reads neither (0), its C entry launching
    ``units`` blocks, a plane's on grid x and the planes on (z, y)."""
    route: int
    tile: int
    grid: int
    units: int


def plan(r: int, s: int, esize: int, batch: int = 1, route_: int = None,
         tile_: int = None, sms: int = SMS) -> LayoutPlan:
    """The launch of a batch of (R, S) -> (S, R) transposes: the route
    (``route_`` overrides :func:`route`); on the tile route the tile
    (``tile_`` overrides :func:`pick_tile`) and ``BLOCKS_PER_SM`` blocks
    per SM at most, each striding over its tiles.  Any batch, R and S:
    no grid axis caps them."""
    rt = route(r, s, esize) if route_ is None else route_
    if rt == TILE:
        tile = pick_tile(r, s, esize, batch, sms) if tile_ is None else tile_
        units = tile_count(r, s, esize, tile, batch)
        return LayoutPlan(rt, tile, min(units, BLOCKS_PER_SM * sms), units)
    return LayoutPlan(rt, 0, 0, batch * cdiv(s if rt == SHORT_ROWS else r,
                                            SHORT_THREADS))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def transpose_cuda(x: torch.Tensor, r: int, s: int, route_: int = None,
                   plan_: LayoutPlan = None) -> torch.Tensor:
    """x viewed as (B, R, S) -> a contiguous (B, S, R); any dtype of 1, 2,
    4 or 8 bytes, copied bit for bit.  ``route_`` overrides
    :func:`route` (a tuned variant's), ``plan_`` the whole launch (for
    sweeps)."""
    require_cuda(x)
    if not x.is_contiguous():
        raise ValueError("the transpose kernel takes a contiguous tensor")
    if x.element_size() not in (1, 2, 4, 8) or x.is_complex():
        raise TypeError(f"the transpose kernel takes 1-, 2-, 4- or 8-byte "
                        f"real elements, got {x.dtype}")
    b = x.numel() // (r * s) if r * s else 0
    if b * r * s != x.numel():
        raise ValueError(f"{tuple(x.shape)} is not a batch of {r}x{s}")
    y = torch.empty((b, s, r), dtype=x.dtype, device=x.device)
    if y.numel():
        p = plan_ or plan(r, s, x.element_size(), b, route_,
                          sms=_sms(x.device.index))
        LIB.call("repro_transpose", ptr(x), ptr(y), b, r, s,
                 x.element_size(), p.tile, p.grid, p.route,
                 stream_ptr(x.device))
    return y


def chw_to_hwc_cuda(x: torch.Tensor, route_: int = None) -> torch.Tensor:
    """x: (C, H, W) or (N, C, H, W) -> (H, W, C) or (N, H, W, C)."""
    *lead, c, h, w = x.shape
    return transpose_cuda(x, c, h * w, route_).reshape(*lead, h, w, c)


def hwc_to_chw_cuda(x: torch.Tensor) -> torch.Tensor:
    """x: (H, W, C) or (N, H, W, C) -> (C, H, W) or (N, C, H, W)."""
    *lead, h, w, c = x.shape
    return transpose_cuda(x, h * w, c).reshape(*lead, c, h, w)


def chw_to_hwc8_cuda(x: torch.Tensor, route_: int = None) -> torch.Tensor:
    """x: (N?, C, H, W) -> (N?, H, W, C/8, 8); C % 8 == 0."""
    c = x.shape[-3]
    assert c % 8 == 0
    return chw_to_hwc_cuda(x, route_).unflatten(-1, (c // 8, 8))


def hwc8_to_chw_cuda(x: torch.Tensor) -> torch.Tensor:
    """x: (N?, H, W, C/8, 8) -> (N?, C, H, W)."""
    assert x.shape[-1] == 8
    return hwc_to_chw_cuda(x.flatten(-2))
