"""The DNN primitive library on PyTorch: 72 convolution routines in 6 families.

Port of the reference's ``core/primitives.py`` (Section 4 of the paper).
Each primitive is a 3-tuple {L_in, P, L_out} plus a ``supports``
predicate; names, families, ``supports``, ``prepare`` packings and the
fusable layout sets are the reference's, so the PBQP choice space is the
same.  Families: ``direct``, ``im2``, ``kn2``, ``winograd``, ``fft`` (the
library routines, on PyTorch operators as the reference left them to
XLA) and ``pallas`` — the five primitives backed by the port's
hand-written CUDA kernels (``repro_torch.kernels``), tagged ``kernel``.

Routines take a leading batch axis: ``f(x, packed)`` maps
``(N, *memory shape)`` to ``(N, *memory shape)``.  Every registered
``make`` and ``fused`` builder also accepts a single image without the
batch axis (as the reference's per-image routines do) and returns a
contiguous tensor in its output layout.  ``prepare`` packs numpy weights
exactly as the reference does and returns CPU tensors; callers move them
to the device (``core.plan.compile_plan``).
"""
from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.winograd_transform import ops as wt
from ..kernels.winograd_transform.ref import winograd_tensors
from .layouts import LAYOUT_BY_NAME
from .scenario import Scenario
from .winograd_transforms import winograd_matrices

__all__ = ["Primitive", "build_registry", "convert_layout", "registry",
           "primitives_for", "FUSABLE_LAYOUTS", "register_extension",
           "unregister_extension", "clear_extensions", "extension_token",
           "invalidate_registry_cache", "to_tensor"]

#: layouts the generic prologue/epilogue wrapper can absorb — every
#: permutation layout plus the blocked HWC8.
FUSABLE_LAYOUTS = ("CHW", "HWC", "HCW", "CWH", "WCH", "WHC", "HWC8")


def _rank(layout: str) -> int:
    """Axes of one image in ``layout`` (4 for a channel-blocked one)."""
    return 4 if LAYOUT_BY_NAME[layout].block_c else 3


# ----------------------------------------------------------------------
# layout conversion (used by the legalizer's conversion layers)
# ----------------------------------------------------------------------
def convert_layout(x: torch.Tensor, src: str, dst: str) -> torch.Tensor:
    """Convert an activation tensor between memory layouts.

    Acts on the trailing image axes, so leading (batch) axes pass
    through.  The result is materialized (contiguous): a conversion
    layer is a real copy, as the reference's transposes are.
    """
    if src == dst:
        return x
    ls, ld = LAYOUT_BY_NAME[src], LAYOUT_BY_NAME[dst]
    lead = x.dim() - _rank(src)
    # -> logical CHW
    if ls.block_c:
        cpos = lead + ls.perm.index(0)
        x = torch.movedim(x, -1, cpos + 1)
        x = x.flatten(cpos, cpos + 1)
    keep = tuple(range(lead))
    x = x.permute(*keep, *(lead + int(i) for i in np.argsort(ls.perm)))
    # -> destination
    x = x.permute(*keep, *(lead + i for i in ld.perm))
    if ld.block_c:
        cpos = lead + ld.perm.index(0)
        c = x.shape[cpos]
        x = x.unflatten(cpos, (c // ld.block_c, ld.block_c))
        x = torch.movedim(x, cpos + 1, -1)
    return x.contiguous()


def _from_chw(y_chw, dst: str):
    return convert_layout(y_chw, "CHW", dst)


def _to_chw(x, src: str):
    return convert_layout(x, src, "CHW")


def _auto_batch(fn: Callable, l_in: str) -> Callable:
    """Let a batched routine also take one image without the batch axis,
    and hand back a contiguous tensor in either case."""
    rank = _rank(l_in)

    def f(x, packed):
        if x.dim() == rank:
            return fn(x.unsqueeze(0), packed).squeeze(0).contiguous()
        return fn(x, packed).contiguous()

    return f


def to_tensor(a) -> torch.Tensor:
    """numpy -> CPU tensor under the reference's dtypes: JAX runs with
    64-bit types off, so float64 packs as float32 and complex128 as
    complex64."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.complex128:
        a = a.astype(np.complex64)
    return torch.from_numpy(np.ascontiguousarray(a))


# ----------------------------------------------------------------------
@dataclass(frozen=True)
class Primitive:
    """One routine in the library: {L_in, P, L_out} + applicability."""

    name: str
    family: str
    l_in: str
    l_out: str
    supports: Callable[[Scenario], bool]
    #: (scenario, w(M,C,K,K) np, b(M,) np) -> dict of packed CPU tensors
    prepare: Callable[[Scenario, np.ndarray, np.ndarray], Any]
    #: scenario -> f(x_mem, packed) -> y_mem
    make: Callable[[Scenario], Callable]
    tags: Tuple[str, ...] = ()
    #: layouts the routine can consume directly in its prologue
    fusable_in: Tuple[str, ...] = ()
    #: layouts the routine can emit directly in its epilogue
    fusable_out: Tuple[str, ...] = ()
    #: optional custom fused builder ``(scn, l_in, l_out) -> f(x, packed)``
    #: — the kernel primitives pass the wire layout to the kernel as
    #: index maps; the others fall back to the generic wrapper below.
    fused: Optional[Callable] = None
    #: tuning parameters of a generated variant (sorted (name, value)
    #: pairs); empty for the hand-written entries.
    params: Tuple[Tuple[str, int], ...] = ()

    def make_fused(self, scn: Scenario, l_in: Optional[str] = None,
                   l_out: Optional[str] = None) -> Callable:
        """Entry point consuming ``l_in``-layout input and emitting
        ``l_out``-layout output (defaults: the native layouts).

        The generic path converts inside the primitive's call.  Eager
        PyTorch does not fuse the conversion into the routine's reads or
        writes, so only primitives with a ``fused`` builder (or whose
        routine takes the layout natively) save the conversion pass.
        """
        li = l_in or self.l_in
        lo = l_out or self.l_out
        if li == self.l_in and lo == self.l_out:
            return self.make(scn)
        if li != self.l_in and li not in self.fusable_in:
            raise ValueError(f"{self.name}: cannot fuse input layout {li} "
                             f"(fusable_in={self.fusable_in})")
        if lo != self.l_out and lo not in self.fusable_out:
            raise ValueError(f"{self.name}: cannot fuse output layout {lo} "
                             f"(fusable_out={self.fusable_out})")
        if self.fused is not None:
            return self.fused(scn, li, lo)
        inner = self.make(scn)
        nat_in, nat_out = self.l_in, self.l_out

        def f(x, packed):
            if li != nat_in:
                x = convert_layout(x, li, nat_in)
            y = inner(x, packed)
            if lo != nat_out:
                y = convert_layout(y, nat_out, lo)
            return y

        return f

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{self.family}:{self.name} {self.l_in}->{self.l_out}>"


def _std_prepare(scn: Scenario, w: np.ndarray, b: np.ndarray):
    return {"w": to_tensor(w), "b": to_tensor(b)}


def _pad_chw(x, p):
    return F.pad(x, (p, p, p, p)) if p else x


def _zeros(x, *shape):
    return torch.zeros(shape, dtype=x.dtype, device=x.device)


# ======================================================================
# direct family
# ======================================================================
_DN_LHS = {"CHW": "NCHW", "HWC": "NHWC", "HCW": "NHCW"}


def _nchw_view(x, layout: str):
    """(N, C, H, W) view of an unblocked layout (no copy)."""
    inv = np.argsort(LAYOUT_BY_NAME[layout].perm)
    return x.permute(0, *(1 + int(i) for i in inv))


def _direct_lax(scn: Scenario, l_in: str, l_out: str, rhs_spec: str):
    """The framework's native convolution, fed the wire layout as a
    strided view (cuDNN reads NHWC natively) and emitting ``l_out``."""
    def f(x, packed):
        w = packed["w"]
        if rhs_spec == "HWIO":
            w = w.permute(3, 2, 0, 1)
        out = F.conv2d(_nchw_view(x, l_in), w, stride=scn.stride,
                       padding=scn.pad)
        out = out + packed["b"][:, None, None]
        return _from_chw(out, l_out)

    return f


def _direct_lax_prepare(rhs_spec):
    def prep(scn, w, b):
        if rhs_spec == "HWIO":
            w = np.transpose(w, (2, 3, 1, 0))
        return {"w": to_tensor(w), "b": to_tensor(b)}
    return prep


def _sum2d(scn: Scenario):
    """Textbook sum-of-single-channels: one 2-D conv per input channel,
    accumulated in a loop.  The paper's SUM2D baseline."""
    def f(x, packed):  # x: CHW
        w, b = packed["w"], packed["b"]  # (M, C, K, K)
        acc = _zeros(x, x.shape[0], *scn.out_shape_chw)
        for c in range(scn.c):
            acc = acc + F.conv2d(x[:, c:c + 1], w[:, c:c + 1],
                                 stride=scn.stride, padding=scn.pad)
        return acc + b[:, None, None]

    return f


def _sum1d(scn: Scenario):
    """Direct conv as a sum of 1-D row convolutions (textbook variant)."""
    def f(x, packed):  # CHW
        w, b = packed["w"], packed["b"]
        xp = _pad_chw(x, scn.pad)
        oh, ow = scn.out_h, scn.out_w
        acc = _zeros(x, x.shape[0], scn.m, oh, ow)
        for i in range(scn.k):
            rows = xp[:, :, i:i + (oh - 1) * scn.stride + 1:scn.stride, :]
            # 1-D correlation along W for kernel row i
            acc = acc + F.conv2d(rows, w[:, :, i:i + 1, :],
                                 stride=(1, scn.stride))
        return acc + b[:, None, None]

    return f


def _shift_add(scn: Scenario, layout: str, use_scan: bool,
               l_in: Optional[str] = None, l_out: Optional[str] = None):
    """Shift-and-add loop nest over the K x K kernel positions.

    ``l_in``/``l_out`` override the wire layouts (transform fusion).
    ``use_scan`` walks the taps through one flat index, as the
    reference's ``lax.scan`` variant does.
    """
    l_in = l_in or layout
    l_out = l_out or layout

    def f(x, packed):
        w, b = packed["w"], packed["b"]  # (M, C, K, K)
        xp = _pad_chw(_to_chw(x, l_in), scn.pad)
        oh, ow, s = scn.out_h, scn.out_w, scn.stride
        acc = _zeros(x, x.shape[0], scn.m, oh, ow)
        if use_scan:
            wflat = w.reshape(scn.m, scn.c, scn.k * scn.k)
            taps = [(t, t // scn.k, t % scn.k) for t in range(scn.k * scn.k)]
            for t, i, j in taps:
                win = xp[:, :, i:i + (oh - 1) * s + 1:s,
                         j:j + (ow - 1) * s + 1:s]
                acc = acc + torch.einsum("mc,nchw->nmhw", wflat[:, :, t], win)
        else:
            for i in range(scn.k):
                for j in range(scn.k):
                    win = xp[:, :, i:i + (oh - 1) * s + 1:s,
                             j:j + (ow - 1) * s + 1:s]
                    acc = acc + torch.einsum("mc,nchw->nmhw", w[:, :, i, j],
                                             win)
        return _from_chw(acc + b[:, None, None], l_out)

    return f


def _blocked_hwc8(scn: Scenario):
    """Shift-add over a channel-blocked HWC8 tensor (vector-friendly)."""
    def f(x, packed):  # x: (N, H, W, C/8, 8)
        w, b = packed["w"], packed["b"]  # w: (M/8, 8, C/8, 8, K, K)
        p, s = scn.pad, scn.stride
        xp = F.pad(x, (0, 0, 0, 0, p, p, p, p))
        oh, ow = scn.out_h, scn.out_w
        acc = _zeros(x, x.shape[0], oh, ow, scn.m // 8, 8)
        for i in range(scn.k):
            for j in range(scn.k):
                win = xp[:, i:i + (oh - 1) * s + 1:s,
                         j:j + (ow - 1) * s + 1:s]
                acc = acc + torch.einsum("zhwcb,ndcb->zhwnd", win,
                                         w[..., i, j])
        return acc + b.reshape(scn.m // 8, 8)

    return f


def _blocked_prepare(scn, w, b):
    wb = w.reshape(scn.m // 8, 8, scn.c // 8, 8, scn.k, scn.k)
    return {"w": to_tensor(wb), "b": to_tensor(b)}


# ======================================================================
# im2 family
# ======================================================================
def _patches_chw(x, scn: Scenario, method: str):
    """Toeplitz patch tensor (N, C, K, K, OH, OW) from logical CHW input.

    ``"xla"`` is the framework's patch extraction (``F.unfold``, whose
    rows run (C, kh, kw) as ``lax.conv_general_dilated_patches``'s do);
    ``"manual"`` stacks shifted strided slices.
    """
    n = x.shape[0]
    if method == "xla":
        pt = F.unfold(x, (scn.k, scn.k), padding=scn.pad, stride=scn.stride)
        return pt.reshape(n, scn.c, scn.k, scn.k, scn.out_h, scn.out_w)
    xp = _pad_chw(x, scn.pad)
    oh, ow, s = scn.out_h, scn.out_w, scn.stride
    rows = []
    for i in range(scn.k):
        cols = [xp[:, :, i:i + (oh - 1) * s + 1:s, j:j + (ow - 1) * s + 1:s]
                for j in range(scn.k)]
        rows.append(torch.stack(cols, dim=2))
    return torch.stack(rows, dim=2)  # (N, C, K, K, OH, OW)


def _im2(scn: Scenario, l_in: str, l_out: str, method: str, trans_b: bool,
         split_c: int = 0):
    def f(x, packed):
        n = x.shape[0]
        pt = _patches_chw(_to_chw(x, l_in), scn, method)
        ohow = scn.out_h * scn.out_w
        wm = packed["w"]
        if split_c:
            # low-memory: GEMM per channel chunk, accumulated
            csz = max(1, scn.c // split_c)
            y = _zeros(x, n, scn.m, ohow)
            for c0 in range(0, scn.c, csz):
                p = pt[:, c0:c0 + csz].reshape(n, -1, ohow)
                if trans_b:  # (C, KK, M) weights
                    y = y + (p.transpose(1, 2)
                             @ wm[c0:c0 + csz].reshape(-1, scn.m)
                             ).transpose(1, 2)
                else:        # (M, C, KK) weights
                    y = y + wm[:, c0:c0 + csz].reshape(scn.m, -1) @ p
        else:
            p = pt.reshape(n, scn.c * scn.k * scn.k, ohow)
            if trans_b:
                y = (p.transpose(1, 2) @ wm).transpose(1, 2)  # (CKK, M)
            else:
                y = wm @ p                                    # (M, CKK)
        y = y.reshape(n, scn.m, scn.out_h, scn.out_w) + \
            packed["b"][:, None, None]
        return _from_chw(y, l_out)

    return f


def _im2_prepare(trans_b: bool, split_c: int = 0):
    def prep(scn, w, b):
        if split_c:
            wm = w.reshape(scn.m, scn.c, scn.k * scn.k)
            if trans_b:
                wm = np.transpose(wm, (1, 2, 0))  # (C, KK, M)
            return {"w": to_tensor(wm), "b": to_tensor(b)}
        wm = w.reshape(scn.m, -1)
        if trans_b:
            wm = wm.T.copy()
        return {"w": to_tensor(wm), "b": to_tensor(b)}
    return prep


def _im2row_hwc(scn: Scenario, l_out: str, method: str, trans_b: bool,
                l_in: str = "HWC"):
    """HWC-native im2row: patch rows (OH*OW, K*K*C) @ (K*K*C, M).

    ``l_in`` overrides the wire layout (transform fusion).
    """
    def f(x, packed):
        n = x.shape[0]
        pt = _patches_chw(_to_chw(x, l_in), scn, method)
        p = pt.permute(0, 4, 5, 2, 3, 1).reshape(
            n, scn.out_h * scn.out_w, -1)  # (N, OHOW, KKC)
        if trans_b:
            y = (packed["w"] @ p.transpose(1, 2)).transpose(1, 2)
        else:
            y = p @ packed["w"]  # (KKC, M)
        y = y.reshape(n, scn.out_h, scn.out_w, scn.m) + packed["b"]
        if l_out == "HWC":
            return y
        return convert_layout(y, "HWC", l_out)

    return f


def _im2row_prepare(trans_b: bool):
    def prep(scn, w, b):
        wm = np.transpose(w, (2, 3, 1, 0)).reshape(-1, scn.m)  # (KKC, M)
        if trans_b:
            wm = wm.T.copy()
        return {"w": to_tensor(wm), "b": to_tensor(b)}
    return prep


# pointwise (K=1) GEMM specialisations
def _pw(scn: Scenario, layout: str, trans_b: bool):
    def f(x, packed):
        s, n, w = scn.stride, x.shape[0], packed["w"]
        if layout == "CHW":
            xs = x[:, :, ::s, ::s] if s > 1 else x
            p = xs.reshape(n, scn.c, -1)
            y = (p.transpose(1, 2) @ w).transpose(1, 2) if trans_b \
                else w @ p
            return y.reshape(n, scn.m, scn.out_h, scn.out_w) + \
                packed["b"][:, None, None]
        elif layout == "HWC":
            xs = x[:, ::s, ::s, :] if s > 1 else x
            p = xs.reshape(n, -1, scn.c)
            y = (w @ p.transpose(1, 2)).transpose(1, 2) if trans_b \
                else p @ w
            return y.reshape(n, scn.out_h, scn.out_w, scn.m) + packed["b"]
        else:  # HCW
            xs = x[:, ::s, :, ::s] if s > 1 else x
            y = torch.einsum("nhcw,cm->nhmw", xs, w)
            return y + packed["b"][None, :, None]

    return f


def _pw_prepare(layout: str, trans_b: bool):
    def prep(scn, w, b):
        wm = w.reshape(scn.m, scn.c)
        if layout == "CHW":
            wm = wm.T.copy() if trans_b else wm
        elif layout == "HWC":
            wm = wm if trans_b else wm.T.copy()
        else:
            wm = wm.T.copy()
        return {"w": to_tensor(wm), "b": to_tensor(b)}
    return prep


# ======================================================================
# kn2 family (stride-1 only)
# ======================================================================
def _kn2(scn: Scenario, col: bool, mode: str,
         l_in: Optional[str] = None, l_out: Optional[str] = None):
    """kn2row / kn2col: one (M x C) GEMM per kernel position, shifted
    accumulation into the output.  Low memory, no Toeplitz matrix.

    ``l_in``/``l_out`` override the wire layouts (transform fusion); the
    accumulation einsum emits HWC directly when that is the wire.
    ``mode`` is ``"unroll"`` (running sum), ``"scan"`` (one flat tap
    index, the reference's ``lax.scan``) or ``"stack"`` (all taps
    stacked, then summed).
    """
    l_in = l_in or ("HWC" if col else "CHW")
    l_out = l_out or ("HWC" if col else "CHW")

    def f(x, packed):
        w, b = packed["w"], packed["b"]  # (K, K, M, C)
        xp = _pad_chw(_to_chw(x, l_in), scn.pad)
        oh, ow = scn.out_h, scn.out_w
        hwc_acc = l_out == "HWC"

        def one(wt, i, j):
            win = xp[:, :, i:i + oh, j:j + ow]
            if hwc_acc:
                return torch.einsum("nchw,mc->nhwm", win, wt)
            return torch.einsum("mc,nchw->nmhw", wt, win)

        kk = scn.k * scn.k
        if mode == "scan":
            wflat = w.reshape(kk, scn.m, scn.c)
            shape = (oh, ow, scn.m) if hwc_acc else (scn.m, oh, ow)
            acc = _zeros(x, x.shape[0], *shape)
            for t in range(kk):
                acc = acc + one(wflat[t], t // scn.k, t % scn.k)
        elif mode == "stack":
            parts = torch.stack([one(w[i, j], i, j) for i in range(scn.k)
                                 for j in range(scn.k)])
            acc = parts.sum(dim=0)
        else:  # unrolled accumulation
            acc = one(w[0, 0], 0, 0)
            for t in range(1, kk):
                i, j = t // scn.k, t % scn.k
                acc = acc + one(w[i, j], i, j)

        if hwc_acc:
            return acc + b
        return _from_chw(acc + b[:, None, None], l_out)

    return f


def _kn2_prepare(scn, w, b):
    return {"w": to_tensor(np.transpose(w, (2, 3, 0, 1)).copy()),
            "b": to_tensor(b)}


# ======================================================================
# winograd family (stride-1, K in {3, 5})
# ======================================================================
def _wino2d(scn: Scenario, m_: int, l_in: str, l_out: str):
    """The input transform, one batched product over the alpha^2 points
    and the output transform (``kernels.winograd_transform``: kernels on
    the card, the einsums on the CPU).  CHW and HWC enter and leave
    through the transforms' strides; any other layout is converted."""
    out = l_out if l_out in ("CHW", "HWC") else "CHW"

    def f(x, packed):
        if l_in == "HWC":
            xc = x.permute(0, 3, 1, 2)
        else:
            xc = _to_chw(x, l_in)
        # (a^2, M, C) x (a^2, C, N*T)
        y = wt.winograd_conv(xc, lambda v: torch.bmm(packed["w"], v),
                             packed["b"], m_=m_, k=scn.k, pad=scn.pad,
                             out_layout=out)
        return y if out == l_out else _from_chw(y, l_out)

    return f


def _wino2d_prepare(m_: int):
    def prep(scn, w, b):
        A, G, Bt = winograd_matrices(m_, scn.k)
        a = m_ + scn.k - 1
        # (a^2, M, C): the batched product's left operand as it is stored
        U = np.einsum("ar,mcrs,bs->abmc", G, w, G).reshape(a * a, scn.m,
                                                          scn.c)
        return {"w": to_tensor(np.asarray(U, np.float32)),
                "b": to_tensor(b)}
    return prep


def _wino1d(scn: Scenario, m_: int, l_in: str, l_out: str):
    """Row-wise 1-D Winograd: F(m_, K) along W for each kernel row, with
    the K row contributions accumulated pre-output-transform.  Needs only
    O(alpha/m_) extra memory per row — the paper's ARM selections."""
    a = m_ + scn.k - 1

    def f(x, packed):
        A, _, Bt = winograd_tensors(m_, scn.k, x.device)
        Ug = packed["w"]  # (K, M, C, a): per kernel row transformed taps
        n = x.shape[0]
        xc = _to_chw(x, l_in)
        oh, ow = scn.out_h, scn.out_w
        ntw = -(-ow // m_)
        pw = (ntw - 1) * m_ + a - (scn.w + 2 * scn.pad)
        xp = F.pad(xc, (scn.pad, scn.pad + max(pw, 0), scn.pad, scn.pad))
        idx = (torch.arange(ntw, device=x.device)[:, None] * m_
               + torch.arange(a, device=x.device)[None, :])
        Q = _zeros(x, n, scn.m, oh, ntw, a)
        for i in range(scn.k):
            rows = xp[:, :, i:i + oh, :]  # stride-1 only
            tiles = rows[:, :, :, idx]    # (N, C, OH, ntw, a)
            V = torch.einsum("ab,nchtb->nchta", Bt, tiles)
            Q = Q + torch.einsum("mca,nchta->nmhta", Ug[i], V)
        Y = torch.einsum("ap,nmhta->nmhtp", A, Q)
        y = Y.reshape(n, scn.m, oh, ntw * m_)[:, :, :, :ow]
        return _from_chw(y + packed["b"][:, None, None], l_out)

    return f


def _wino1d_prepare(m_: int):
    def prep(scn, w, b):
        A, G, Bt = winograd_matrices(m_, scn.k)
        # (K rows, M, C, alpha)
        Ug = np.einsum("ar,mcir->imca", G, w)
        return {"w": to_tensor(np.asarray(Ug, np.float32)),
                "b": to_tensor(b)}
    return prep


# ======================================================================
# fft family
# ======================================================================
def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _fft2d(scn: Scenario, l_in: str, l_out: str, pow2: bool,
           subsample: bool = False):
    def f(x, packed):
        Wf, b = packed["w"], packed["b"]
        xp = _pad_chw(_to_chw(x, l_in), scn.pad)
        hp, wp = xp.shape[2], xp.shape[3]
        fh, fw = hp + scn.k - 1, wp + scn.k - 1
        if pow2:
            fh, fw = _next_pow2(fh), _next_pow2(fw)
        Xf = torch.fft.rfft2(xp, s=(fh, fw))
        Of = torch.einsum("nchw,mchw->nmhw", Xf, Wf)
        of = torch.fft.irfft2(Of, s=(fh, fw))
        full_oh = hp - scn.k + 1
        full_ow = wp - scn.k + 1
        y = of[:, :, scn.k - 1:scn.k - 1 + full_oh,
               scn.k - 1:scn.k - 1 + full_ow]
        if subsample and scn.stride > 1:
            y = y[:, :, ::scn.stride, ::scn.stride]
        y = y + b[:, None, None]
        return _from_chw(y.to(x.dtype), l_out)

    return f


def _fft2d_prepare(pow2: bool):
    def prep(scn, w, b):
        hp, wp = scn.h + 2 * scn.pad, scn.w + 2 * scn.pad
        fh, fw = hp + scn.k - 1, wp + scn.k - 1
        if pow2:
            fh, fw = _next_pow2(fh), _next_pow2(fw)
        wf = np.fft.rfft2(w[:, :, ::-1, ::-1], s=(fh, fw))
        return {"w": to_tensor(wf), "b": to_tensor(b)}
    return prep


def _fft1d_sum(scn: Scenario, l_in: str, l_out: str, pow2: bool):
    """2-D conv as a sum of per-kernel-row 1-D FFT convolutions along W,
    accumulated in the frequency domain (the paper's low-memory variant)."""
    def f(x, packed):
        Wf, b = packed["w"], packed["b"]  # (K, M, C, F)
        xp = _pad_chw(_to_chw(x, l_in), scn.pad)
        fw = xp.shape[3] + scn.k - 1
        if pow2:
            fw = _next_pow2(fw)
        oh = scn.out_h
        Of = None
        for i in range(scn.k):
            rows = xp[:, :, i:i + oh, :]
            Rf = torch.fft.rfft(rows, n=fw, dim=-1)  # (N, C, OH, F)
            term = torch.einsum("nchf,mcf->nmhf", Rf, Wf[i])
            Of = term if Of is None else Of + term
        of = torch.fft.irfft(Of, n=fw, dim=-1)
        y = of[:, :, :, scn.k - 1:scn.k - 1 + scn.out_w]
        return _from_chw(y.to(x.dtype) + b[:, None, None], l_out)

    return f


def _fft1d_prepare(pow2: bool):
    def prep(scn, w, b):
        wp = scn.w + 2 * scn.pad
        fw = wp + scn.k - 1
        if pow2:
            fw = _next_pow2(fw)
        wf = np.fft.rfft(w[:, :, :, ::-1], n=fw, axis=-1)  # (M, C, K, F)
        wf = np.transpose(wf, (2, 0, 1, 3)).copy()  # (K, M, C, F)
        return {"w": to_tensor(wf), "b": to_tensor(b)}
    return prep


# ======================================================================
# registry construction
# ======================================================================
def _sup(k_in=None, stride1=False, blocked=False, kmin_hw=True):
    def s(scn: Scenario) -> bool:
        if k_in is not None and scn.k not in k_in:
            return False
        if stride1 and scn.stride != 1:
            return False
        if blocked and (scn.c % 8 or scn.m % 8):
            return False
        if kmin_hw and (scn.h + 2 * scn.pad < scn.k or
                        scn.w + 2 * scn.pad < scn.k):
            return False
        return True
    return s


@functools.lru_cache(maxsize=1)
def build_registry() -> Tuple[Primitive, ...]:
    prims: List[Primitive] = []

    def add(name, family, l_in, l_out, supports, prepare, make, tags=(),
            fusable_in=FUSABLE_LAYOUTS, fusable_out=FUSABLE_LAYOUTS,
            fused=None):
        def batched_make(scn, _make=make, _l_in=l_in):
            return _auto_batch(_make(scn), _l_in)

        batched_fused = None
        if fused is not None:
            def batched_fused(scn, li, lo, _fused=fused):
                return _auto_batch(_fused(scn, li, lo), li)

        prims.append(Primitive(name, family, l_in, l_out, supports,
                               prepare, batched_make, tuple(tags),
                               tuple(fusable_in), tuple(fusable_out),
                               batched_fused))

    # ---------------- direct ----------------
    # direct_lax is natively layout-parameterized: a fused edge simply
    # rebuilds the conv for the wire layout
    def _lax_fused(rhs):
        return lambda scn, li, lo: _direct_lax(scn, li, lo, rhs)

    for l_in, l_out in [("CHW", "CHW"), ("HWC", "HWC"), ("CHW", "HWC"),
                        ("HWC", "CHW"), ("HCW", "HCW")]:
        for rhs in (["OIHW", "HWIO"] if l_in in ("CHW", "HWC") else ["OIHW"]):
            add(f"direct_lax_{l_in.lower()}_{l_out.lower()}_{rhs.lower()}",
                "direct", l_in, l_out, _sup(),
                _direct_lax_prepare(rhs),
                functools.partial(_direct_lax, l_in=l_in, l_out=l_out,
                                  rhs_spec=rhs),
                fusable_in=tuple(_DN_LHS), fusable_out=tuple(_DN_LHS),
                fused=_lax_fused(rhs))

    def _shift_fused(layout, use_scan):
        return lambda scn, li, lo: _shift_add(scn, layout, use_scan,
                                              l_in=li, l_out=lo)

    add("sum2d", "direct", "CHW", "CHW", _sup(), _std_prepare, _sum2d,
        tags=("baseline",))
    add("sum1d", "direct", "CHW", "CHW", _sup(), _std_prepare, _sum1d)
    for layout in ["CHW", "HWC", "HCW"]:
        add(f"direct_shiftadd_{layout.lower()}", "direct", layout, layout,
            _sup(), _std_prepare,
            functools.partial(_shift_add, layout=layout, use_scan=False),
            fused=_shift_fused(layout, False))
    for layout in ["CHW", "HWC"]:
        add(f"direct_shiftscan_{layout.lower()}", "direct", layout, layout,
            _sup(), _std_prepare,
            functools.partial(_shift_add, layout=layout, use_scan=True),
            fused=_shift_fused(layout, True))
    add("direct_blocked_hwc8", "direct", "HWC8", "HWC8",
        _sup(blocked=True), _blocked_prepare, _blocked_hwc8)

    # ---------------- im2 ----------------
    def _im2_fused(method, trans_b, split_c=0):
        return lambda scn, li, lo: _im2(scn, li, lo, method, trans_b,
                                        split_c)

    def _im2row_fused(method, trans_b):
        return lambda scn, li, lo: _im2row_hwc(scn, lo, method, trans_b,
                                               l_in=li)

    for method in ["xla", "manual"]:
        for trans_b in [False, True]:
            t = "t" if trans_b else "n"
            add(f"im2col_{method}_{t}_chw", "im2", "CHW", "CHW", _sup(),
                _im2_prepare(trans_b),
                functools.partial(_im2, l_in="CHW", l_out="CHW",
                                  method=method, trans_b=trans_b),
                fused=_im2_fused(method, trans_b))
            add(f"im2row_{method}_{t}_hwc", "im2", "HWC", "HWC", _sup(),
                _im2row_prepare(trans_b),
                functools.partial(_im2row_hwc, l_out="HWC", method=method,
                                  trans_b=trans_b),
                fused=_im2row_fused(method, trans_b))
    add("im2col_xla_n_chw_hwc", "im2", "CHW", "HWC", _sup(),
        _im2_prepare(False),
        functools.partial(_im2, l_in="CHW", l_out="HWC", method="xla",
                          trans_b=False),
        fused=_im2_fused("xla", False))
    add("im2row_xla_n_hwc_chw", "im2", "HWC", "CHW", _sup(),
        _im2row_prepare(False),
        functools.partial(_im2row_hwc, l_out="CHW", method="xla",
                          trans_b=False),
        fused=_im2row_fused("xla", False))
    for split in [4, 8]:
        add(f"im2col_split{split}_chw", "im2", "CHW", "CHW", _sup(),
            _im2_prepare(False, split_c=split),
            functools.partial(_im2, l_in="CHW", l_out="CHW", method="xla",
                              trans_b=False, split_c=split),
            tags=("lowmem",), fused=_im2_fused("xla", False, split))
    # pointwise K=1 GEMM specialisations
    for layout in ["CHW", "HWC"]:
        for trans_b in [False, True]:
            t = "t" if trans_b else "n"
            add(f"pw_gemm_{t}_{layout.lower()}", "im2", layout, layout,
                _sup(k_in=(1,)), _pw_prepare(layout, trans_b),
                functools.partial(_pw, layout=layout, trans_b=trans_b))
    add("pw_gemm_n_hcw", "im2", "HCW", "HCW", _sup(k_in=(1,)),
        _pw_prepare("HCW", False),
        functools.partial(_pw, layout="HCW", trans_b=False))

    # ---------------- kn2 ----------------
    def _kn2_fused(col, mode):
        return lambda scn, li, lo: _kn2(scn, col, mode, l_in=li, l_out=lo)

    for col, layout in [(False, "CHW"), (True, "HWC")]:
        nm = "kn2col" if col else "kn2row"
        for mode in ["unroll", "scan", "stack"]:
            add(f"{nm}_{mode}_{layout.lower()}", "kn2", layout, layout,
                _sup(stride1=True), _kn2_prepare,
                functools.partial(_kn2, col=col, mode=mode),
                tags=("lowmem",) if mode != "stack" else (),
                fused=_kn2_fused(col, mode))

    # ---------------- winograd ----------------
    def _wino2d_fused(m_):
        return lambda scn, li, lo: _wino2d(scn, m_, li, lo)

    def _wino1d_fused(m_):
        return lambda scn, li, lo: _wino1d(scn, m_, li, lo)

    for m_ in [2, 4, 6]:
        for layout in ["CHW", "HWC"]:
            for k in ([3, 5] if m_ != 6 else [3]):
                add(f"wino2d_f{m_}x{k}_{layout.lower()}", "winograd",
                    layout, layout, _sup(k_in=(k,), stride1=True),
                    _wino2d_prepare(m_),
                    functools.partial(_wino2d, m_=m_, l_in=layout,
                                      l_out=layout),
                    fused=_wino2d_fused(m_))
    for m_ in [2, 4]:
        for layout in ["CHW", "HWC"]:
            for k in [3, 5]:
                add(f"wino1d_f{m_}x{k}_{layout.lower()}", "winograd",
                    layout, layout, _sup(k_in=(k,), stride1=True),
                    _wino1d_prepare(m_),
                    functools.partial(_wino1d, m_=m_, l_in=layout,
                                      l_out=layout),
                    tags=("lowmem",), fused=_wino1d_fused(m_))

    # ---------------- fft ----------------
    def _fft2d_fused(pow2, subsample=False):
        return lambda scn, li, lo: _fft2d(scn, li, lo, pow2, subsample)

    def _fft1d_fused(pow2):
        return lambda scn, li, lo: _fft1d_sum(scn, li, lo, pow2)

    for layout in ["CHW", "HWC"]:
        for pow2 in [False, True]:
            p = "p2" if pow2 else "ex"
            add(f"fft2d_{p}_{layout.lower()}", "fft", layout, layout,
                _sup(stride1=True), _fft2d_prepare(pow2),
                functools.partial(_fft2d, l_in=layout, l_out=layout,
                                  pow2=pow2),
                fused=_fft2d_fused(pow2))
            add(f"fft1d_sum_{p}_{layout.lower()}", "fft", layout, layout,
                _sup(stride1=True), _fft1d_prepare(pow2),
                functools.partial(_fft1d_sum, l_in=layout, l_out=layout,
                                  pow2=pow2),
                tags=("lowmem",), fused=_fft1d_fused(pow2))
    add("fft2d_strided_chw", "fft", "CHW", "CHW", _sup(), _fft2d_prepare(False),
        functools.partial(_fft2d, l_in="CHW", l_out="CHW", pow2=False,
                          subsample=True),
        fused=_fft2d_fused(False, True))

    # ---------------- pallas (the hand-written CUDA kernels) ----------
    from ..kernels import register_pallas_primitives
    register_pallas_primitives(add, _sup)

    names = [p.name for p in prims]
    if len(names) != len(set(names)):
        raise RuntimeError("duplicate primitive names")
    return tuple(prims)


# ----------------------------------------------------------------------
# registry extensions + memoization
#
# ``registry()`` is on the hot path of every solve (``primitives_for``
# walks it once per node), so the base + extension concatenation is
# memoized; mutators below invalidate explicitly.
# ----------------------------------------------------------------------
_REG_LOCK = threading.Lock()
#: name -> (primitives, token); token feeds CostModel.version() so
#: installing/removing an extension rotates every cached plan key.
_EXTENSIONS: Dict[str, Tuple[Tuple[Primitive, ...], str]] = {}
_REG_CACHE: Optional[Tuple[Primitive, ...]] = None


def invalidate_registry_cache() -> None:
    """Drop the memoized registry; next ``registry()`` rebuilds it."""
    global _REG_CACHE
    with _REG_LOCK:
        _REG_CACHE = None


def register_extension(name: str, prims: Sequence[Primitive],
                       token: str = "") -> None:
    """Install (or replace) an extension set of primitives.

    ``token`` should digest the extension's content: it is folded into
    ``extension_token()`` and hence every ``CostModel.version()``.
    """
    prims = tuple(prims)
    with _REG_LOCK:
        base_names = {p.name for p in build_registry()}
        for other, (ps, _) in _EXTENSIONS.items():
            if other != name:
                base_names.update(p.name for p in ps)
        names = [p.name for p in prims]
        dup = (set(names) & base_names) or \
            {n for n in names if names.count(n) > 1}
        if dup:
            raise ValueError(f"extension {name!r}: duplicate primitive "
                             f"names {sorted(dup)}")
        _EXTENSIONS[name] = (prims, str(token))
        global _REG_CACHE
        _REG_CACHE = None


def unregister_extension(name: str) -> bool:
    """Remove one extension; returns whether it was installed."""
    with _REG_LOCK:
        found = _EXTENSIONS.pop(name, None) is not None
        if found:
            global _REG_CACHE
            _REG_CACHE = None
        return found


def clear_extensions() -> None:
    """Remove every extension."""
    with _REG_LOCK:
        _EXTENSIONS.clear()
        global _REG_CACHE
        _REG_CACHE = None


def extension_token() -> str:
    """Digest of the installed extensions (empty string when none)."""
    if not _EXTENSIONS:
        return ""
    return ";".join(f"{n}:{_EXTENSIONS[n][1] or len(_EXTENSIONS[n][0])}"
                    for n in sorted(_EXTENSIONS))


def registry() -> Tuple[Primitive, ...]:
    """The full primitive library: hand-written base + extensions."""
    global _REG_CACHE
    cache = _REG_CACHE
    if cache is None:
        with _REG_LOCK:
            cache = _REG_CACHE
            if cache is None:
                ext = tuple(p for n in sorted(_EXTENSIONS)
                            for p in _EXTENSIONS[n][0])
                cache = _REG_CACHE = build_registry() + ext
    return cache


def primitives_for(scn: Scenario,
                   families: Optional[Sequence[str]] = None,
                   exclude_tags: Sequence[str] = ()) -> List[Primitive]:
    out = []
    for p in registry():
        if families and p.family not in families:
            continue
        if any(t in p.tags for t in exclude_tags):
            continue
        if p.supports(scn):
            out.append(p)
    return out
