"""Binding of the 2-D Winograd transform kernels
(``csrc/winograd_transform.cu``).

Replaces no Pallas kernel: the reference leaves its input transform
V = B^T d B and output transform y = A^T Q A + b to jnp einsums, which XLA
fuses on the TPU; here they are two kernels around the batched GEMM.  x
enters as an (N, C, H, W) view through its strides (CHW, HWC, batched or
not, no copy in front) and V leaves as the GEMM's contiguous (alpha^2, C,
N * T); Q enters as a contiguous (alpha^2, M, N * T) and y leaves, cropped
and with the bias added, through its strides.  :func:`plan` cuts the
tiles into blocks.  The matrices are core/winograd_transforms.py's, the
plain version's, passed with each launch.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ...core.winograd_transforms import winograd_matrices
from ..common import KernelLib, cdiv, ptr, require_cuda, stream_ptr
from .ref import tiles

_I, _L, _P = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
LIB = KernelLib("winograd_transform.cu", {
    "repro_wino_input_transform": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _L,
                                   _L, _L, _L, _I, _I, _I, _I, _I, _P),
    "repro_wino_output_transform": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _L, _L, _L, _L, _I, _I, _I, _I, _P)})
#: the (m, k) pairs the kernels are built for: the registry's 2-D
#: Winograd primitives'
PAIRS = ((2, 3), (4, 3), (6, 3), (2, 5), (4, 5))
#: tiles a block transforms at most, one a thread (the kernel's kThreads)
ITEMS = 256
#: tile columns a block takes at most (a wider plane splits across blocks)
MAX_COLS = 64
#: dynamic shared memory a block takes at most (the kernel's kMaxSmem)
SMEM_BYTES = 48 * 1024
#: channels a block takes at least where C is x's or y's unit stride: 8
#: floats fill a 32-byte sector
SECTOR_CHANS = 8
#: the blocks a launch wants before a block's channels, then its rows, are
#: split further: two a multiprocessor (the kernel's kMinBlocks)
BLOCKS_PER_SM = 2
#: the H100 SXM's SMs (the planner's default; a launch passes its card's)
SMS = 132


@dataclass(frozen=True)
class TransformPlan:
    """One launch: a block takes ``rows`` x ``cols`` tiles of one image
    and ``chans`` channels with ``threads`` threads and ``smem`` bytes of
    shared memory; ``blocks`` in all."""
    rows: int
    cols: int
    chans: int
    threads: int
    blocks: int
    smem: int


def smem_bytes(output: bool, m_: int, k: int, rows: int, cols: int,
               chans: int) -> int:
    """A block's shared memory, as the C entry computes it: the input
    rows its tiles read (input), or the outputs they write (output), per
    channel at an odd pitch."""
    halo = 0 if output else k - 1
    return 4 * chans * (((rows * m_ + halo) * (cols * m_ + halo)) | 1)


def plan(output: bool, n: int, c: int, nth: int, ntw: int, m_: int, k: int,
         chan_fast: bool, sms: int = SMS) -> TransformPlan:
    """The blocks of one transform over N images of C channels (M for the
    output) of nth x ntw tiles.  A block takes up to ``ITEMS`` tiles: whole
    tile rows of one channel where they fit (``MAX_COLS`` columns at most),
    then more channels; at least ``SECTOR_CHANS`` channels where C is the
    unit stride (``chan_fast``).  Over ``SMEM_BYTES`` it takes fewer
    channels, then fewer rows, then fewer columns.  Under ``BLOCKS_PER_SM``
    blocks a multiprocessor it splits its channels, then its rows."""
    cols = min(ntw, MAX_COLS)
    rows = min(nth, max(1, ITEMS // cols))
    floor = min(c, SECTOR_CHANS) if chan_fast else 1
    chans = min(c, max(floor, ITEMS // (rows * cols)))

    def blocks():
        return n * cdiv(nth, rows) * cdiv(ntw, cols) * cdiv(c, chans)

    while smem_bytes(output, m_, k, rows, cols, chans) > SMEM_BYTES:
        if chans > floor:
            chans = max(floor, chans // 2)
        elif rows > 1:
            rows = cdiv(rows, 2)
        else:
            cols = cdiv(cols, 2)
    while blocks() < BLOCKS_PER_SM * sms and chans > floor:
        chans = max(floor, chans // 2)
    while blocks() < BLOCKS_PER_SM * sms and rows > 1:
        rows = cdiv(rows, 2)
    threads = min(ITEMS, 32 * cdiv(rows * cols * chans, 32))
    return TransformPlan(rows, cols, chans, threads, blocks(),
                         smem_bytes(output, m_, k, rows, cols, chans))


@functools.lru_cache(maxsize=None)
def _matrices(m_: int, k: int):
    """(B^T, A) of F(m_, k) as contiguous f32 host arrays (kept alive for
    the launches that pass them)."""
    A, _, Bt = winograd_matrices(m_, k)
    return (np.ascontiguousarray(Bt, np.float32),
            np.ascontiguousarray(A, np.float32))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _chan_fast(strides) -> bool:
    """Whether C, not W, is the unit stride of an (N, C, H, W) view: the
    kernel's own test (HWC)."""
    return strides[1] == 1 and strides[3] != 1


def input_transform_cuda(x: torch.Tensor, m_: int, k: int,
                         pad: int) -> torch.Tensor:
    """x: an (N, C, H, W) f32 view, any strides -> V = B^T d B of every
    tile, a contiguous (alpha^2, C, N * T)."""
    require_cuda(x)
    n, c, h, w = x.shape
    _, _, nth, ntw = tiles(h, w, m_, k, pad)
    a = m_ + k - 1
    v = torch.empty((a * a, c, n * nth * ntw), dtype=torch.float32,
                    device=x.device)
    if v.numel():
        p = plan(False, n, c, nth, ntw, m_, k, _chan_fast(x.stride()),
                 _sms(x.device.index))
        bt, _ = _matrices(m_, k)
        LIB.call("repro_wino_input_transform", ptr(x), ptr(v),
                 ctypes.c_void_p(bt.ctypes.data), m_, k, n, c, h, w,
                 *x.stride(), pad, p.rows, p.cols, p.chans, p.threads,
                 stream_ptr(x.device))
    return v


def output_transform_cuda(q: torch.Tensor, b: torch.Tensor, m_: int, k: int,
                          n: int, oh: int, ow: int,
                          out_layout: str = "CHW") -> torch.Tensor:
    """q: a contiguous (alpha^2, M, N * T) f32, b: (M,) -> y = A^T Q A + b
    of every tile, cropped to OH x OW: a contiguous (N, M, OH, OW), or
    (N, OH, OW, M) for ``out_layout="HWC"``."""
    require_cuda(q, b)
    if not q.is_contiguous() or not b.is_contiguous():
        raise ValueError("the output transform takes a contiguous Q and "
                         "bias")
    mo = q.shape[1]
    nth, ntw = cdiv(oh, m_), cdiv(ow, m_)
    if q.shape != ((m_ + k - 1) ** 2, mo, n * nth * ntw) or \
            b.shape != (mo,):
        raise ValueError(f"Q {tuple(q.shape)} and bias {tuple(b.shape)} do "
                         f"not fit {n} images of {oh}x{ow} at F({m_},{k})")
    if out_layout == "HWC":
        y = torch.empty((n, oh, ow, mo), dtype=torch.float32,
                        device=q.device)
        yv = y.permute(0, 3, 1, 2)
    else:
        y = yv = torch.empty((n, mo, oh, ow), dtype=torch.float32,
                             device=q.device)
    if y.numel():
        p = plan(True, n, mo, nth, ntw, m_, k, _chan_fast(yv.stride()),
                 _sms(q.device.index))
        _, am = _matrices(m_, k)
        LIB.call("repro_wino_output_transform", ptr(q), ptr(b), ptr(y),
                 ctypes.c_void_p(am.ctypes.data), m_, k, n, mo, oh, ow,
                 *yv.stride(), p.rows, p.cols, p.chans, p.threads,
                 stream_ptr(q.device))
    return y
