"""Hand-written Hopper kernels for the paper's hot spots.

Each kernel lives in its own subpackage, at the reference's path:
  kernel.py — the ``ctypes`` binding of its CUDA source (``csrc/``)
  ops.py    — the wrapper: kernel for CUDA tensors, plain version for
              CPU tensors, and the launch count
  ref.py    — the plain PyTorch version, compared with the kernel
  bench.py  — ``benchmark_entry``, the calibration sweep's standalone
              microbenchmark of the kernel at one scenario

``layout_transform`` and ``flash_attention`` are not primitives: the
calibration sweep times them (``calibrate.sweep``), as the reference's
sweep times its Pallas counterparts.  ``winograd_transform`` (the 2-D
Winograd input and output transforms) is none either, and replaces no
Pallas kernel: every 2-D Winograd primitive, the library's ``wino2d_*`` and
the kernel ``pallas_wino_*``, runs it around its batched GEMM.

``register_pallas_primitives`` plugs the convolution kernels into the
primitive registry as the ``pallas`` family, under the reference's five
names, supports and fused builders; ``kernel_variant`` makes a tuned
variant of one of them, its launch pinned (``space.py``,
``repro_torch.autotune``).  They are tagged ``kernel``; the
analytic cost model prices them only when asked to
(``AnalyticCostModel(include_kernels=True)``), as the reference prices
its ``tpu-only`` ones.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["register_pallas_primitives", "kernel_variant", "kernel_libs",
           "LAUNCH_COUNTER_OF", "expected_launches", "conv_launches",
           "all_launches"]

#: the launch counter (``common.count_launch``) behind each kernel
#: primitive, and each tuned variant ``<name>@<params>`` of it: one launch
#: per conv the primitive runs
LAUNCH_COUNTER_OF = {"pallas_direct_hwc": "conv_direct",
                     "pallas_im2col_chw": "conv_im2col",
                     "pallas_wino_f2x3_chw": "winograd_gemm",
                     "pallas_wino_f4x3_chw": "winograd_gemm",
                     "pallas_pw_gemm_chw": "matmul"}


def expected_launches(sel):
    """The launches of one forward of selection ``sel``'s plan: one per
    conv that it gives to each kernel, by launch counter."""
    want = {}
    for node in sel.net.conv_nodes():
        name = sel.choices[node.id].primitive.name
        k = LAUNCH_COUNTER_OF.get(name.split("@")[0])
        if k:
            want[k] = want.get(k, 0) + 1
    return want


def conv_launches(name: str) -> dict:
    """One conv's launches under primitive ``name`` (or a tuned variant
    of it), by launch counter: its kernel's one (``LAUNCH_COUNTER_OF``),
    and an input and an output Winograd transform for a 2-D Winograd
    primitive (``wino2d_*``, ``pallas_wino_*``); {} for any other."""
    from .winograd_transform.ops import COUNTER
    want = {}
    k = LAUNCH_COUNTER_OF.get(name.split("@")[0])
    if k:
        want[k] = 1
    if name.startswith(("wino2d_", "pallas_wino_")):
        want[COUNTER] = 2
    return want


def all_launches(sel):
    """Every launch of one forward of selection ``sel``'s plan, by launch
    counter: ``expected_launches``' kernel convs and the Winograd
    transforms' two per 2-D Winograd conv."""
    want = {}
    for node in sel.net.conv_nodes():
        name = sel.choices[node.id].primitive.name
        for k, n in conv_launches(name).items():
            want[k] = want.get(k, 0) + n
    return want


def kernel_libs():
    """Every CUDA library the kernels load (for ``common.build_all``)."""
    from .conv_direct.kernel import LIB as direct
    from .flash_attention.kernel import LIB as flash
    from .layout_transform.kernel import LIB as layout
    from .matmul.kernel import LIB as matmul
    from .winograd_gemm.kernel import LIB as wino
    from .winograd_transform.kernel import LIB as transform
    return [matmul, wino, direct, layout, flash, transform]


def _fused_builder(name: str, pin=None):
    """The fused builder ``(scn, l_in, l_out) -> f(x, packed)`` of the
    kernel primitive ``name``, launching its kernel with ``pin`` (a tuned
    variant's tile and split count; None: the planner's launch).  Its
    native layouts give the primitive's ``make``."""
    from . import conv_direct, conv_im2col, winograd_gemm
    from .matmul import ops as mm_ops

    if name == "pallas_direct_hwc":
        # the kernel reads a CHW input and stores a CHW output through
        # its own index maps (see csrc/conv_direct.cu)
        def direct(scn, l_in, l_out):
            def f(x, packed):  # x: (N, H, W, C) natively
                return conv_direct.conv_direct(
                    x, packed["w"], packed["b"], stride=scn.stride,
                    pad=scn.pad, in_layout=l_in, out_layout=l_out, pin=pin)
            return f
        return direct

    if name == "pallas_im2col_chw":
        # HWC input feeds the patch gather directly; HWC output runs the
        # GEMM with the transposed-output store
        def im2(scn, l_in, l_out):
            def f(x, packed):  # x: (N, C, H, W) natively
                return conv_im2col.conv_im2col(
                    x, packed["w"], packed["b"], stride=scn.stride,
                    pad=scn.pad, in_layout=l_in, out_layout=l_out, pin=pin)
            return f
        return im2

    if name.startswith("pallas_wino_f"):
        m_ = int(name[len("pallas_wino_f")])

        # the output transform's einsum emits HWC itself
        def wino(scn, l_in, l_out):
            def f(x, packed):  # x: (N, C, H, W) natively
                return winograd_gemm.conv_winograd(
                    x, packed["u"], packed["b"], m_=m_, k=scn.k,
                    stride=scn.stride, pad=scn.pad, in_layout=l_in,
                    out_layout=l_out, pin=pin)
            return f
        return wino

    assert name == "pallas_pw_gemm_chw", name

    # the GEMM kernel's strides absorb both ends: an HWC input is read as
    # the (OHOW, C) LHS and an HWC output is stored through the
    # transposed-output epilogue — no transpose in any case
    def pw(scn, l_in, l_out):
        def f(x, packed):
            s, n = scn.stride, x.shape[0]
            w = packed["w"]  # (M, C)
            if l_in == "HWC":
                xs = x[:, ::s, ::s, :] if s > 1 else x
                p = xs.reshape(n, -1, scn.c)  # (N, OHOW, C)
                if l_out == "HWC":
                    y = mm_ops.matmul(p, w.T, pin=pin)  # (N, OHOW, M)
                    return y.reshape(n, scn.out_h, scn.out_w, scn.m) + \
                        packed["b"]
                y = mm_ops.matmul(p, w.T, out_layout="nm",
                                  pin=pin)  # (N, M, OHOW)
                return y.reshape(n, scn.m, scn.out_h, scn.out_w) + \
                    packed["b"][:, None, None]
            xs = x[:, :, ::s, ::s] if s > 1 else x
            p = xs.reshape(n, scn.c, -1)  # (N, C, OHOW)
            if l_out == "HWC":
                y = mm_ops.matmul(w, p, out_layout="nm",
                                  pin=pin)  # (N, OHOW, M)
                return y.reshape(n, scn.out_h, scn.out_w, scn.m) + \
                    packed["b"]
            y = mm_ops.matmul(w, p, pin=pin).reshape(n, scn.m, scn.out_h,
                                                    scn.out_w)
            return y + packed["b"][:, None, None]
        return f
    return pw


def register_pallas_primitives(add, _sup) -> None:
    from ..core.primitives import to_tensor
    from ..core.scenario import Scenario
    from . import winograd_gemm

    def native(name, l_in, l_out):
        fused = _fused_builder(name)
        return (lambda scn: fused(scn, l_in, l_out)), fused

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

    base = _sup()
    make, fused = native("pallas_direct_hwc", "HWC", "HWC")
    add("pallas_direct_hwc", "pallas", "HWC", "HWC",
        lambda s: base(s) and vmem_ok(s), direct_prepare, make,
        tags=("kernel",), fusable_in=("CHW",), fusable_out=("CHW",),
        fused=fused)

    # ---- im2col GEMM ----
    def im2_prepare(scn, w, b):
        return {"w": to_tensor(w), "b": to_tensor(b)}

    make, fused = native("pallas_im2col_chw", "CHW", "CHW")
    add("pallas_im2col_chw", "pallas", "CHW", "CHW", base,
        im2_prepare, make, tags=("kernel",),
        fusable_in=("HWC",), fusable_out=("HWC",), fused=fused)

    # ---- winograd F(2,3)/F(4,3) ----
    for m_ in (2, 4):
        def wino_prepare(scn, w, b, m_=m_):
            return {"u": winograd_gemm.prepare_kernel(w, m_),
                    "b": to_tensor(b)}

        make, fused = native(f"pallas_wino_f{m_}x3_chw", "CHW", "CHW")
        add(f"pallas_wino_f{m_}x3_chw", "pallas", "CHW", "CHW",
            _sup(k_in=(3,), stride1=True), wino_prepare, make,
            tags=("kernel",), fusable_in=("HWC",), fusable_out=("HWC",),
            fused=fused)

    # ---- pointwise (K=1) GEMM ----
    def pw_prepare(scn, w, b):
        return {"w": to_tensor(w.reshape(scn.m, scn.c)), "b": to_tensor(b)}

    make, fused = native("pallas_pw_gemm_chw", "CHW", "CHW")
    add("pallas_pw_gemm_chw", "pallas", "CHW", "CHW", _sup(k_in=(1,)),
        pw_prepare, make, tags=("kernel",),
        fusable_in=("HWC",), fusable_out=("HWC",), fused=fused)


def kernel_variant(base_name: str, name: str, pin, legal, params):
    """A tuned variant of the kernel primitive ``base_name`` (a registering
    space's ``make_primitive``): the hand-written entry's family, layouts,
    packing and fusable sets, named ``name``, tagged ``autotuned``, its
    kernel launched with ``pin`` instead of the planner's choice.  It
    supports what the entry supports where ``legal(scn)`` holds: a pinned
    launch is not a legal plan at every shape."""
    from ..core.primitives import _auto_batch, build_registry
    entry = next(p for p in build_registry() if p.name == base_name)
    fused = _fused_builder(base_name, pin)
    return dataclasses.replace(
        entry, name=name,
        supports=lambda scn: entry.supports(scn) and legal(scn),
        make=lambda scn: _auto_batch(fused(scn, entry.l_in, entry.l_out),
                                     entry.l_in),
        fused=lambda scn, li, lo: _auto_batch(fused(scn, li, lo), li),
        tags=("kernel", "autotuned"), params=params)
