"""Tunable parameter spaces: the shared vocabulary of the autotuner.

Each of the six Pallas kernel packages declares its sweepable block/
tile/unroll axes and a validity predicate in its own ``space.py`` (see
e.g. :mod:`repro.kernels.conv_im2col.space`) as a
:class:`TunableSpace`.  Spaces come in two kinds:

* **registering** spaces (``make_primitive`` set) — each valid
  configuration becomes a first-class :class:`~repro.core.primitives.
  Primitive` in the ``pallas`` family, inheriting the hand-written
  entry's layouts and ``fusable_in/fusable_out``, so PBQP selects among
  generated variants exactly like hand-written kernels.

* **kernel-only** spaces (``benchmark``/``analytic`` set) — the kernel
  is not a convolution primitive (flash attention, layout transforms);
  its winning configurations are recorded in the variant catalog as
  ``kernel::`` entries for the ops layer, not registered with PBQP.

This module deliberately imports nothing from :mod:`repro.kernels` —
the kernel packages import *it*, and :mod:`repro.autotune.generate`
collects their ``SPACE`` objects lazily, so there is no import cycle.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["TunableSpace", "variant_suffix", "variant_name",
           "params_tuple"]


def variant_suffix(params: Dict[str, int],
                   order: Tuple[str, ...]) -> str:
    """Deterministic ``bm64_bn128_bk32``-style suffix (axis order)."""
    return "_".join(f"{a}{params[a]}" for a in order if a in params)


def variant_name(base: str, params: Dict[str, int],
                 order: Tuple[str, ...]) -> str:
    """Registry name of one generated variant: ``<base>@<suffix>``."""
    return f"{base}@{variant_suffix(params, order)}"


def params_tuple(params: Dict[str, int],
                 order: Tuple[str, ...]) -> Tuple[Tuple[str, int], ...]:
    """Hashable ``Primitive.params`` form, in axis order."""
    return tuple((a, int(params[a])) for a in order if a in params)


@dataclass(frozen=True)
class TunableSpace:
    """One kernel package's sweepable configuration space."""

    #: kernel package name (``conv_im2col``, ``flash_attention``, ...)
    kernel: str
    #: ordered (axis name, candidate values); order fixes variant names
    axes: Tuple[Tuple[str, Tuple[int, ...]], ...]
    #: static validity: VMEM fit of the tile working set, MXU alignment
    #: — anything decidable from the parameters alone.  Per-scenario
    #: applicability lives in the generated primitive's ``supports``.
    valid: Callable[[Dict[str, int]], bool]
    #: registering spaces: params -> Primitive (None for kernel-only)
    make_primitive: Optional[Callable] = None
    #: kernel-only spaces: (scn, params) -> zero-arg builder -> (fn,
    #: args), or None when the scenario does not apply
    benchmark: Optional[Callable] = None
    #: kernel-only spaces: (scn, params, HardwareSpec) -> seconds
    analytic: Optional[Callable] = None

    @property
    def registers(self) -> bool:
        return self.make_primitive is not None

    @property
    def axis_order(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    def configs(self) -> List[Dict[str, int]]:
        """Every valid configuration, in deterministic axis order."""
        names = [a for a, _ in self.axes]
        out = []
        for combo in itertools.product(*(vs for _, vs in self.axes)):
            params = dict(zip(names, combo))
            if self.valid(params):
                out.append(params)
        return out

    def name_for(self, base: str, params: Dict[str, int]) -> str:
        return variant_name(base, params, self.axis_order)
