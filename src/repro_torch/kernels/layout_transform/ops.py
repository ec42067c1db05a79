"""Layout-transform wrappers: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors, and ``convert``, the layout-parameterized entry
with the reference's routing.  Each of the four entries counts its own
launches, as ``layout_transform.<entry>``."""
from __future__ import annotations

from ..common import count_launch, on_cpu
from .kernel import (chw_to_hwc8_cuda, chw_to_hwc_cuda, hwc8_to_chw_cuda,
                     hwc_to_chw_cuda)
from .ref import (chw_to_hwc8_ref, chw_to_hwc_ref, hwc8_to_chw_ref,
                  hwc_to_chw_ref)


def _dispatch(x, entry, kernel, plain, *route):
    if on_cpu(x):
        return plain(x)
    y = kernel(x, *route)
    count_launch(f"layout_transform.{entry}")
    return y


def chw_to_hwc(x, route_=None):
    """(C, H, W) -> (H, W, C), any H/W; optional leading batch axis.
    ``route_`` overrides the kernel's route (``kernel.route``; a tuned
    variant's); the plain version ignores it."""
    return _dispatch(x, "chw_to_hwc", chw_to_hwc_cuda, chw_to_hwc_ref,
                     route_)


def hwc_to_chw(x):
    """(H, W, C) -> (C, H, W), any H/W; optional leading batch axis."""
    return _dispatch(x, "hwc_to_chw", hwc_to_chw_cuda, hwc_to_chw_ref)


def chw_to_hwc8(x, route_=None):
    """One-shot (C, H, W) -> (H, W, C/8, 8); C % 8 == 0, any H/W;
    ``route_`` as in :func:`chw_to_hwc`."""
    assert x.shape[-3] % 8 == 0
    return _dispatch(x, "chw_to_hwc8", chw_to_hwc8_cuda, chw_to_hwc8_ref,
                     route_)


def hwc8_to_chw(x):
    """One-shot (H, W, C/8, 8) -> (C, H, W); any H/W."""
    assert x.shape[-1] == 8
    return _dispatch(x, "hwc8_to_chw", hwc8_to_chw_cuda, hwc8_to_chw_ref)


#: direct kernels by (src, dst) layout-name pair
_DIRECT = {
    ("CHW", "HWC"): chw_to_hwc,
    ("HWC", "CHW"): hwc_to_chw,
    ("CHW", "HWC8"): chw_to_hwc8,
    ("HWC8", "CHW"): hwc8_to_chw,
}


def convert(x, src: str, dst: str):
    """Layout-parameterized entry point: the one-shot kernel when one
    exists for (src, dst), ``convert_layout`` otherwise."""
    if src == dst:
        return x
    fn = _DIRECT.get((src, dst))
    if fn is not None:
        return fn(x)
    from ...core.primitives import convert_layout
    return convert_layout(x, src, dst)
