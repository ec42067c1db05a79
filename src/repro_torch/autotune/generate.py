"""Variant generation: enumerate every space's valid configurations.

Kernel space modules are imported lazily (they import
:mod:`repro.autotune.space`, never the reverse), so this module is the
single point where the autotuner learns what is tunable.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..core.primitives import Primitive
from .space import TunableSpace

__all__ = ["spaces", "generate_variants", "kernel_spaces"]


def spaces() -> Dict[str, TunableSpace]:
    """All six kernel packages' declared spaces, keyed by package."""
    from ..kernels.conv_direct import space as conv_direct
    from ..kernels.conv_im2col import space as conv_im2col
    from ..kernels.flash_attention import space as flash_attention
    from ..kernels.layout_transform import space as layout_transform
    from ..kernels.matmul import space as matmul
    from ..kernels.winograd_gemm import space as winograd_gemm
    mods = (conv_direct, conv_im2col, winograd_gemm, matmul,
            flash_attention, layout_transform)
    return {m.SPACE.kernel: m.SPACE for m in mods}


def generate_variants(kernels: Optional[Sequence[str]] = None,
                      max_per_kernel: Optional[int] = None
                      ) -> List[Primitive]:
    """Candidate primitives from every *registering* space.

    ``kernels`` filters by package name; ``max_per_kernel`` caps each
    space deterministically (the leading slice of its config order) —
    the CLI's ``--budget`` lever for quick sweeps.
    """
    out: List[Primitive] = []
    for kname, space in sorted(spaces().items()):
        if not space.registers:
            continue
        if kernels and kname not in kernels:
            continue
        cfgs = space.configs()
        if max_per_kernel is not None:
            cfgs = cfgs[:max_per_kernel]
        out.extend(space.make_primitive(p) for p in cfgs)
    names = [p.name for p in out]
    assert len(names) == len(set(names)), "duplicate variant names"
    return out


def kernel_spaces(kernels: Optional[Sequence[str]] = None
                  ) -> List[Tuple[TunableSpace, List[Dict[str, int]]]]:
    """(space, configs) for every *kernel-only* space."""
    out = []
    for kname, space in sorted(spaces().items()):
        if space.registers:
            continue
        if kernels and kname not in kernels:
            continue
        out.append((space, space.configs()))
    return out
