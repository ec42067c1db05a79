"""Binding of the layout-transform CUDA kernel (``csrc/layout_transform.cu``).

Replaces the reference's four Pallas kernels, ``chw_to_hwc_pallas``,
``hwc_to_chw_pallas``, ``chw_to_hwc8_pallas`` and ``hwc8_to_chw_pallas``.
(H, W, C/8, 8) in row-major memory is the same bytes as (H, W, C), so all
four are one (C, H*W) <-> (H*W, C) transpose, with the HWC8 blocking a
view on either side.  The reference's tile padding (H to 8, W to 128)
and cropping have no counterpart: the kernel masks its ragged tiles.
Each entry takes an optional leading batch axis, run on the grid.  Where
one axis is short (conv1's 3 or 4 channels), :func:`route` sends the
transpose to the kernel's short-axis route instead of its 32 x 32 tile.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import KernelLib, cdiv, ptr, require_cuda, stream_ptr

_I, _P = ctypes.c_int, ctypes.c_void_p
LIB = KernelLib("layout_transform.cu",
                {"repro_transpose": (_P, _P, _I, _I, _I, _I, _I, _P)})
_MAX_GRID_YZ = 65535
_TILE_SIZE = 32
#: the kernel's routes
TILE, SHORT_ROWS, SHORT_COLS = 0, 1, 2
#: the short routes' longest short axis (the kernel's SHORT_MAX), and the
#: most bytes of it: at 256 x 256 positions of f32 on the H100 the short
#: routes beat the tile at every C up to 16, both ways
#: (``tools/bench_torch_gemm.py --sweep``; PERF.md gives the run)
SHORT_MAX = 16
SHORT_BYTES = 64


def route(r: int, s: int, esize: int) -> int:
    """The kernel's route for a (R, S) -> (S, R) transpose of ``esize``-byte
    elements: a short axis of at most ``SHORT_MAX`` elements and
    ``SHORT_BYTES`` bytes takes a short route (``SHORT_ROWS`` where R is
    the shorter, ``SHORT_COLS`` where S is), anything else the tile."""
    short = min(r, s)
    if short > SHORT_MAX or short * esize > SHORT_BYTES:
        return TILE
    return SHORT_ROWS if r <= s else SHORT_COLS


def transpose_cuda(x: torch.Tensor, r: int, s: int,
                   route_: int = None) -> torch.Tensor:
    """x viewed as (B, R, S) -> a contiguous (B, S, R); any dtype of 1, 2,
    4 or 8 bytes, copied bit for bit.  ``route_`` overrides
    :func:`route` (for sweeps)."""
    require_cuda(x)
    if not x.is_contiguous():
        raise ValueError("the transpose kernel takes a contiguous tensor")
    if x.element_size() not in (1, 2, 4, 8) or x.is_complex():
        raise TypeError(f"the transpose kernel takes 1-, 2-, 4- or 8-byte "
                        f"real elements, got {x.dtype}")
    b = x.numel() // (r * s) if r * s else 0
    if b * r * s != x.numel():
        raise ValueError(f"{tuple(x.shape)} is not a batch of {r}x{s}")
    if route_ is None:
        route_ = route(r, s, x.element_size())
    if b > _MAX_GRID_YZ or (route_ == TILE and
                            cdiv(r, _TILE_SIZE) > _MAX_GRID_YZ):
        raise ValueError(f"{b} planes of {r}x{s} outside the kernel grid")
    y = torch.empty((b, s, r), dtype=x.dtype, device=x.device)
    if y.numel():
        LIB.call("repro_transpose", ptr(x), ptr(y), b, r, s,
                 x.element_size(), route_, stream_ptr(x.device))
    return y


def chw_to_hwc_cuda(x: torch.Tensor) -> torch.Tensor:
    """x: (C, H, W) or (N, C, H, W) -> (H, W, C) or (N, H, W, C)."""
    *lead, c, h, w = x.shape
    return transpose_cuda(x, c, h * w).reshape(*lead, h, w, c)


def hwc_to_chw_cuda(x: torch.Tensor) -> torch.Tensor:
    """x: (H, W, C) or (N, H, W, C) -> (C, H, W) or (N, C, H, W)."""
    *lead, h, w, c = x.shape
    return transpose_cuda(x, h * w, c).reshape(*lead, c, h, w)


def chw_to_hwc8_cuda(x: torch.Tensor) -> torch.Tensor:
    """x: (N?, C, H, W) -> (N?, H, W, C/8, 8); C % 8 == 0."""
    c = x.shape[-3]
    assert c % 8 == 0
    return chw_to_hwc_cuda(x).unflatten(-1, (c // 8, 8))


def hwc8_to_chw_cuda(x: torch.Tensor) -> torch.Tensor:
    """x: (N?, H, W, C/8, 8) -> (N?, C, H, W)."""
    assert x.shape[-1] == 8
    return hwc_to_chw_cuda(x.flatten(-2))
