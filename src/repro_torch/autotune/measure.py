"""Tuning sweep: measure candidate variants through the calibrate
machinery (port of the reference's ``autotune/measure.py``).

The tuner reuses the calibration subsystem wholesale: measurements are
:class:`~repro_torch.calibrate.sweep.SweepItem`\\ s executed by
:func:`~repro_torch.calibrate.sweep.run_sweep` against a resumable
:class:`~repro_torch.calibrate.profile.HardwareProfile`, keyed with the
same ``prim::<name>::<bucket>`` keys the :class:`~repro_torch.calibrate.
model.CalibratedCostModel` serves — so a tuning profile *is* a
calibration profile covering the generated variants.

On the card, items time the kernels with each variant's pinned launch
(``measure_primitive`` / the space's benchmark builder), as the
calibration sweep times them; an item that fails to build or launch
raises.  Off the card only the kernels' plain versions run, whose
timings price no launch: there :func:`analytic_measurer` prices items
through ``run_sweep(measure=...)`` with the card's own fitted models,
which keeps the whole pipeline (resume, budget caps, pruning, catalog)
deterministic and exercisable anywhere.  Nothing falls back from real
measurement to analytic pricing.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..calibrate.sweep import SweepItem
from ..core.costs import (
    H100_SPEC, AnalyticCostModel, HardwareSpec, MeasureCache,
    measure_primitive, prim_cost_key, time_callable,
)
from ..core.primitives import Primitive, build_registry, registry
from ..core.scenario import Scenario
from ..kernels.common import resolve_device
from ..serving.bucketing import BucketPolicy, bucket_scenario
from .space import TunableSpace, variant_suffix

__all__ = ["plan_tune_sweep", "analytic_measurer", "kernel_variant_key",
           "default_measure_mode"]


def kernel_variant_key(space: TunableSpace, params: Dict[str, int],
                       scn: Scenario) -> str:
    """Profile key of one kernel-only variant measurement."""
    suffix = variant_suffix(params, space.axis_order)
    return f"kernel::{space.kernel}@{suffix}::{scn.key()}"


def default_measure_mode(device=None) -> str:
    """``real`` on a CUDA device, ``analytic`` anywhere else (``device``:
    the card unless told otherwise; raises without one)."""
    return "real" if resolve_device(device).type == "cuda" else "analytic"


def plan_tune_sweep(variants: Sequence[Primitive],
                    scenarios: Sequence[Scenario], *,
                    kernel_only: Sequence[Tuple[TunableSpace,
                                                List[Dict[str, int]]]] = (),
                    include_base: bool = True,
                    policy: Optional[BucketPolicy] = None, device=None):
    """Enumerate the tuning measurements.

    Returns ``(items, index)``: the :class:`SweepItem` list for
    ``run_sweep`` plus an index ``key -> ("prim", prim, scn) |
    ("kernel", space, params, scn)`` that the analytic measurer and the
    dominance pruner use to interpret profile entries.  ``device`` is
    where every item is measured (the card by default); planning touches
    no device.

    ``include_base`` adds the hand-written ``pallas``-family entries as
    competitors: a variant that never beats its hand-written cousin on
    any bucket is dominated and pruned, keeping the catalog tight.
    """
    policy = policy or BucketPolicy()
    buckets: List[Scenario] = []
    seen = set()
    for raw in scenarios:
        scn = bucket_scenario(raw, policy)
        if scn.key() not in seen:
            seen.add(scn.key())
            buckets.append(scn)

    pool: List[Primitive] = list(variants)
    if include_base:
        vnames = {p.name for p in variants}
        pool += [p for p in registry()
                 if p.family == "pallas" and not p.params
                 and p.name not in vnames]

    items: List[SweepItem] = []
    index: Dict[str, tuple] = {}
    cache = MeasureCache()  # the items' shared draws and packed weights

    def add(item: SweepItem, entry: tuple) -> None:
        if item.key not in index:
            index[item.key] = entry
            items.append(item)

    for p in pool:
        for scn in buckets:
            if not p.supports(scn):
                continue
            add(SweepItem(
                "prim", prim_cost_key(p.name, scn),
                f"{p.family}:{p.name} @ {scn.key()}",
                lambda reps, min_time, p=p, scn=scn:
                    measure_primitive(p, scn, reps=reps,
                                      min_time=min_time, device=device,
                                      cache=cache)),
                ("prim", p, scn))

    for space, cfgs in kernel_only:
        for params in cfgs:
            for scn in buckets:
                builder = space.benchmark(scn, params, device=device) \
                    if space.benchmark else None
                if builder is None:
                    continue
                add(SweepItem(
                    "kernel", kernel_variant_key(space, params, scn),
                    f"kernel:{space.kernel}"
                    f"@{variant_suffix(params, space.axis_order)}"
                    f" @ {scn.key()}",
                    lambda reps, min_time, b=builder:
                        _measure_builder(b, reps, min_time)),
                    ("kernel", space, params, scn))
    return items, index


def _measure_builder(builder, reps: int, min_time: float) -> float:
    fn, args = builder()
    return time_callable(fn, args, reps=reps, min_time=min_time)


def _space_of(entry: str):
    """The registering space module whose variants pin ``entry``'s
    kernel (each has ``model_ratio``)."""
    from ..kernels.conv_direct import space as conv_direct
    from ..kernels.conv_im2col import space as conv_im2col
    from ..kernels.matmul import space as matmul
    from ..kernels.winograd_gemm import space as winograd_gemm
    return {"pallas_direct_hwc": conv_direct,
            "pallas_im2col_chw": conv_im2col,
            "pallas_wino_f2x3_chw": winograd_gemm,
            "pallas_wino_f4x3_chw": winograd_gemm,
            "pallas_pw_gemm_chw": matmul}[entry]


def analytic_measurer(index: Dict[str, tuple],
                      spec: HardwareSpec = H100_SPEC
                      ) -> Callable[[SweepItem], float]:
    """``run_sweep(measure=...)`` override pricing items analytically.

    A hand-written entry prices as ``AnalyticCostModel(spec,
    include_kernels=True)`` prices it.  A generated variant prices
    as its entry, times the launch planner's model of the variant's
    pinned launch over its model of its own choice at that scenario
    (``model_ratio`` of the declaring space, from
    ``kernels/matmul/plan.py`` or ``kernels/flash_attention/plan.py``),
    so variants of one kernel rank as the card's fitted model ranks their
    launches.  The TPU tiling terms of ``AnalyticCostModel`` read no
    parameter of these variants, so they price each exactly as its
    entry.  Kernel-only spaces price through their own ``analytic``.
    Deterministic.
    """
    cm = AnalyticCostModel(spec, include_kernels=True)
    entries = {p.name: p for p in build_registry()}

    def measure(item: SweepItem) -> float:
        entry = index[item.key]
        if entry[0] == "prim":
            _, prim, scn = entry
            name = prim.name.split("@")[0]
            cost = cm.primitive_cost(entries[name], scn)
            if prim.params:
                cost *= _space_of(name).model_ratio(scn, dict(prim.params))
            return cost
        _, space, params, scn = entry
        return space.analytic(scn, params, spec)

    return measure
