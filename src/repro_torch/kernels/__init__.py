"""Hand-written Hopper kernels for the paper's hot spots.

Each kernel lives in its own subpackage, at the reference's path:
  kernel.py — the ``ctypes`` binding of its CUDA source (``csrc/``)
  ops.py    — the wrapper: kernel for CUDA tensors, plain version for
              CPU tensors, and the launch count
  ref.py    — the plain PyTorch version, compared with the kernel

``register_pallas_primitives`` plugs the convolution kernels into the
primitive registry as the ``pallas`` family, under the reference's five
names, supports and fused builders.  They are tagged ``kernel``; the
analytic cost model prices them only when asked to
(``AnalyticCostModel(include_kernels=True)``), as the reference prices
its ``tpu-only`` ones.
"""
from __future__ import annotations

import numpy as np

__all__ = ["register_pallas_primitives", "kernel_libs"]


def kernel_libs():
    """Every CUDA library the kernels load (for ``common.build_all``)."""
    from .conv_direct.kernel import LIB as direct
    from .matmul.kernel import LIB as matmul
    from .winograd_gemm.kernel import LIB as wino
    return [matmul, wino, direct]


def register_pallas_primitives(add, _sup) -> None:
    from ..core.primitives import to_tensor
    from ..core.scenario import Scenario
    from . import conv_direct, conv_im2col, winograd_gemm
    from .matmul import ops as mm_ops

    def vmem_ok(scn: Scenario) -> bool:
        # the reference's direct kernel keeps the padded input strip in
        # VMEM; the CUDA kernel tiles it, but the same bound keeps the
        # choice space the reference's
        hp = scn.h + 2 * scn.pad
        wp = scn.w + 2 * scn.pad
        return hp * wp * scn.c * 4 <= 8 * 2 ** 20

    # ---- direct NHWC ----
    def direct_prepare(scn, w, b):
        return {"w": to_tensor(np.transpose(w, (2, 3, 1, 0)).copy()),
                "b": to_tensor(b)}

    def direct_make(scn):
        def f(x, packed):  # x: (N, H, W, C)
            return conv_direct.conv_direct(
                x, packed["w"], packed["b"], stride=scn.stride, pad=scn.pad)
        return f

    def direct_fused(scn, l_in, l_out):
        # the kernel reads a CHW input and stores a CHW output through
        # its own index maps (see csrc/conv_direct.cu)
        def f(x, packed):
            return conv_direct.conv_direct(
                x, packed["w"], packed["b"], stride=scn.stride,
                pad=scn.pad, in_layout=l_in, out_layout=l_out)
        return f

    base = _sup()
    add("pallas_direct_hwc", "pallas", "HWC", "HWC",
        lambda s: base(s) and vmem_ok(s), direct_prepare, direct_make,
        tags=("kernel",), fusable_in=("CHW",), fusable_out=("CHW",),
        fused=direct_fused)

    # ---- im2col GEMM ----
    def im2_prepare(scn, w, b):
        return {"w": to_tensor(w), "b": to_tensor(b)}

    def im2_make(scn):
        def f(x, packed):  # x: (N, C, H, W)
            return conv_im2col.conv_im2col(
                x, packed["w"], packed["b"], stride=scn.stride, pad=scn.pad)
        return f

    def im2_fused(scn, l_in, l_out):
        # HWC input feeds the patch gather directly; HWC output runs the
        # GEMM with the transposed-output store
        def f(x, packed):
            return conv_im2col.conv_im2col(
                x, packed["w"], packed["b"], stride=scn.stride,
                pad=scn.pad, in_layout=l_in, out_layout=l_out)
        return f

    add("pallas_im2col_chw", "pallas", "CHW", "CHW", base,
        im2_prepare, im2_make, tags=("kernel",),
        fusable_in=("HWC",), fusable_out=("HWC",), fused=im2_fused)

    # ---- winograd F(2,3)/F(4,3) ----
    for m_ in (2, 4):
        def wino_prepare(scn, w, b, m_=m_):
            return {"u": winograd_gemm.prepare_kernel(w, m_),
                    "b": to_tensor(b)}

        def wino_make(scn, m_=m_):
            def f(x, packed):  # x: (N, C, H, W)
                return winograd_gemm.conv_winograd(
                    x, packed["u"], packed["b"], m_=m_, k=scn.k,
                    stride=scn.stride, pad=scn.pad)
            return f

        def wino_fused(scn, l_in, l_out, m_=m_):
            # the output transform's einsum emits HWC itself
            def f(x, packed):
                return winograd_gemm.conv_winograd(
                    x, packed["u"], packed["b"], m_=m_, k=scn.k,
                    stride=scn.stride, pad=scn.pad, in_layout=l_in,
                    out_layout=l_out)
            return f

        add(f"pallas_wino_f{m_}x3_chw", "pallas", "CHW", "CHW",
            _sup(k_in=(3,), stride1=True), wino_prepare, wino_make,
            tags=("kernel",), fusable_in=("HWC",), fusable_out=("HWC",),
            fused=wino_fused)

    # ---- pointwise (K=1) GEMM ----
    def pw_prepare(scn, w, b):
        return {"w": to_tensor(w.reshape(scn.m, scn.c)), "b": to_tensor(b)}

    def pw_make(scn):
        return pw_fused(scn, "CHW", "CHW")

    def pw_fused(scn, l_in, l_out):
        # the GEMM kernel's strides absorb both ends: an HWC input is
        # read as the (OHOW, C) LHS and an HWC output is stored through
        # the transposed-output epilogue — no transpose in any case
        def f(x, packed):
            s, n = scn.stride, x.shape[0]
            w = packed["w"]  # (M, C)
            if l_in == "HWC":
                xs = x[:, ::s, ::s, :] if s > 1 else x
                p = xs.reshape(n, -1, scn.c)  # (N, OHOW, C)
                if l_out == "HWC":
                    y = mm_ops.matmul(p, w.T)  # (N, OHOW, M)
                    return y.reshape(n, scn.out_h, scn.out_w, scn.m) + \
                        packed["b"]
                y = mm_ops.matmul(p, w.T, out_layout="nm")  # (N, M, OHOW)
                return y.reshape(n, scn.m, scn.out_h, scn.out_w) + \
                    packed["b"][:, None, None]
            xs = x[:, :, ::s, ::s] if s > 1 else x
            p = xs.reshape(n, scn.c, -1)  # (N, C, OHOW)
            if l_out == "HWC":
                y = mm_ops.matmul(w, p, out_layout="nm")  # (N, OHOW, M)
                return y.reshape(n, scn.out_h, scn.out_w, scn.m) + \
                    packed["b"]
            y = mm_ops.matmul(w, p).reshape(n, scn.m, scn.out_h, scn.out_w)
            return y + packed["b"][:, None, None]
        return f

    add("pallas_pw_gemm_chw", "pallas", "CHW", "CHW", _sup(k_in=(1,)),
        pw_prepare, pw_make, tags=("kernel",),
        fusable_in=("HWC",), fusable_out=("HWC",), fused=pw_fused)
