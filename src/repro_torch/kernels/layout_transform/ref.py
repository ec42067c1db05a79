"""Plain PyTorch versions of the layout transforms (counterpart of the
reference's jnp oracles ``repro.kernels.layout_transform.ref``, plus the
HWC8 pair).  Each takes an optional leading batch axis and returns a
contiguous copy, as the kernel does."""
from __future__ import annotations

import torch


def chw_to_hwc_ref(x: torch.Tensor) -> torch.Tensor:
    """(..., C, H, W) -> (..., H, W, C)."""
    return torch.movedim(x, -3, -1).contiguous()


def hwc_to_chw_ref(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., C, H, W)."""
    return torch.movedim(x, -1, -3).contiguous()


def chw_to_hwc8_ref(x: torch.Tensor) -> torch.Tensor:
    """(..., C, H, W) -> (..., H, W, C/8, 8); C % 8 == 0."""
    y = chw_to_hwc_ref(x)
    return y.unflatten(-1, (y.shape[-1] // 8, 8))


def hwc8_to_chw_ref(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C/8, 8) -> (..., C, H, W)."""
    return hwc_to_chw_ref(x.flatten(-2))
